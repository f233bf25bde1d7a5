"""The bf16 operand build of the GLS and GD operators (``dtype=
torch.bfloat16``) against the JAX package's bf16 builds of its TPU kernels
and against the port's float32 operators, on the CPU.

The inputs are made with numpy from a seed, rounded once to bf16 (through
float32) and handed to both packages as the same bf16 values.  The port
computes its bf16-operand instances' function on the CPU: the bf16
operands widened to float32, the float32 plain kernel, the output rounded
once to bf16, the assembly summed in bf16.  The JAX package runs its
Pallas kernels in interpret mode with ``dtype=jnp.bfloat16`` (B2 with f32
accumulation and physics; B1 and B3 op by op in bf16).

- ``GLSOperator(dtype=torch.bfloat16)`` on a 2D Q1 lattice (B2) and on a
  curved 2D Q1 shell (``lattice=False``, B1), and ``GDOperator(dtype=
  torch.bfloat16)`` on a 2D Q2-Q1 lattice (B3): residual, frozen-tau
  tangent and (GLS) node blocks within 3e-2 of scale of the JAX bf16
  build and of the port's float32 operator on the same inputs (the bound
  of ``tests/test_pallas_lattice.py::test_lattice_all_bf16_build``); 3D
  and Q2 cases are marked slow, as the JAX package marks its own;
- the plain version of every bf16 instance is bit-equal to the float32
  plain kernel on the widened operands and tables, rounded to bf16;
- the host side of the new instances: the ``tile_config`` mirror, the
  launch plan per operand type, the launch checks and the dtypes refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softx_2020_200_tpu.fem import mesh as jax_mesh
from softx_2020_200_tpu.fem.dof import FESpace as JaxFESpace
from softx_2020_200_tpu.solvers import gls as jax_gls
from softx_2020_200_tpu.solvers.gd import GDOperator as JaxGDOperator
from softx_2020_200_tpu_torch.fem import mesh as port_mesh
from softx_2020_200_tpu_torch.fem.dof import FESpace
from softx_2020_200_tpu_torch.interop import state_from_numpy
from softx_2020_200_tpu_torch.ops import batched_kernel as bk
from softx_2020_200_tpu_torch.ops import gls_kernel, lattice_gd_kernel
from softx_2020_200_tpu_torch.ops import lattice_kernel
from softx_2020_200_tpu_torch.ops import persistent_tiles as pt
from softx_2020_200_tpu_torch.solvers.gd import GDOperator
from softx_2020_200_tpu_torch.solvers.gls import GLSOperator, StabFlags

torch.set_num_threads(1)

RTOL = 3e-2
NU, GAMMA = 0.05, 0.8
A0, SDT = 2.0, 4.0          # exact in bf16, as the JAX kernels round them
BF16 = dict(device="cpu", dtype=torch.bfloat16)
F32 = dict(device="cpu", dtype=torch.float32)
FROZEN = StabFlags(frozen_tau=True)


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(jnp.asarray(x, jnp.float64))


def _rel(a, b):
    a, b = _f64(a), _f64(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _bf16(rng, *shape, s=1.0):
    """Seeded values rounded once to bf16, as float32 numpy (exact)."""
    x = (rng.standard_normal(shape) * s).astype(np.float32)
    return torch.as_tensor(x).bfloat16().float().numpy()


def _gls_mesh(m, case):
    if case.startswith("2d-q1-shell"):
        return m.hyper_shell([0.0, 0.0], 0.25, 1.0, 6)
    dim = int(case[0])
    cells = [4, 4] if dim == 2 else [2, 2, 2]
    return m.subdivided_hyper_rectangle([0.0] * dim, [1.0] * dim, cells,
                                        colorize=True, dim=dim)


def _gls_pair(case, seed):
    """The JAX operator (bf16, Pallas in interpret mode), the port's bf16
    and float32 operators, and the same bf16 inputs for all three."""
    degree = 2 if "q2" in case else 1
    lattice = "shell" not in case
    sa = JaxFESpace(_gls_mesh(jax_mesh, case), degree)
    sb = FESpace(_gls_mesh(port_mesh, case), degree)
    ja = jax_gls.GLSOperator(sa, nu=NU, dtype=jnp.bfloat16,
                             stab=jax_gls.StabFlags(frozen_tau=True))
    ja.enable_pallas(interpret=True, structured=lattice)
    o16 = GLSOperator(sb, nu=NU, stab=FROZEN, lattice=lattice, **BF16)
    o32 = GLSOperator(sb, nu=NU, stab=FROZEN, lattice=lattice, **F32)
    assert (o16.layout is not None) == lattice
    rng = np.random.default_rng(seed)
    dim, N, E = sb.dim, sb.n_nodes, sb.n_elements
    x = dict(u=_bf16(rng, N, dim + 1, s=0.3), v=_bf16(rng, N, dim + 1),
             prev=_bf16(rng, N, dim, s=0.2),
             fq=_bf16(rng, E, o16.n_q, dim), mask=rng.random((N, dim + 1))
             < 0.2)
    return ja, o16, o32, x


def _port(x, dtype):
    return [state_from_numpy(x[k], device="cpu", dtype=dtype)[0]
            for k in ("u", "v", "prev", "fq")]


GLS_CASES = ["2d-q1-lattice", "2d-q1-shell",
             pytest.param("2d-q2-lattice", marks=pytest.mark.slow),
             pytest.param("3d-q1-lattice", marks=pytest.mark.slow)]


@pytest.mark.parametrize("case", GLS_CASES)
def test_gls_bf16_operator_matches_jax_bf16_build(case):
    """Residual, frozen-tau tangent and node blocks of the port's bf16
    operator (B2 on the lattice, B1 on the shell) against the JAX
    operator built in bf16 on its Pallas kernels (``structured=True`` on
    the lattice, False on the shell)."""
    ja, o16, _, x = _gls_pair(case, seed=11)
    u, v, prev, fq = _port(x, torch.bfloat16)
    ju, jv, jprev, jfq = (jnp.asarray(x[k], jnp.bfloat16)
                          for k in ("u", "v", "prev", "fq"))
    # the JAX residual and its frozen-tau tangent from one jvp (the primal
    # output is the residual)
    r_ref, dr_ref = jax.jvp(
        lambda w: ja.residual_free(w, jprev, jfq, A0, SDT), (ju,), (jv,))
    r = o16.residual_free(u, prev, fq, A0, SDT)
    assert r.dtype == torch.bfloat16
    assert _rel(r, r_ref) < RTOL
    state = o16.linearize(u, prev, fq, A0, SDT)
    assert state.ue.dtype == torch.bfloat16
    assert _rel(o16.jvp(state, v), dr_ref) < RTOL
    mask = torch.as_tensor(x["mask"])
    blocks = o16.node_blocks(u, mask, prev, fq, A0, SDT)
    ref = ja.node_blocks(ju, jnp.asarray(x["mask"]), jprev, jfq, A0, SDT)
    assert blocks.dtype == torch.bfloat16
    assert _rel(blocks, ref) < RTOL


@pytest.mark.parametrize("case", GLS_CASES)
def test_gls_bf16_operator_within_bf16_rounding_of_f32(case):
    """The bf16 operator against the port's float32 operator on the same
    (rounded) inputs: residual, frozen-tau tangent and node blocks differ
    by bf16 rounding only (the analogue of the JAX package's
    ``test_lattice_all_bf16_build``), and not by nothing."""
    _, o16, o32, x = _gls_pair(case, seed=7)
    u, v, prev, fq = _port(x, torch.bfloat16)
    w = [t.float() for t in (u, v, prev, fq)]
    mask = torch.as_tensor(x["mask"])
    pairs = [
        (o16.residual_free(u, prev, fq, A0, SDT),
         o32.residual_free(w[0], w[2], w[3], A0, SDT)),
        (o16.jvp(o16.linearize(u, prev, fq, A0, SDT), v),
         o32.jvp(o32.linearize(w[0], w[2], w[3], A0, SDT), w[1])),
        (o16.node_blocks(u, mask, prev, fq, A0, SDT),
         o32.node_blocks(w[0], mask, w[2], w[3], A0, SDT))]
    for got, want in pairs:
        assert got.dtype == torch.bfloat16 and want.dtype == torch.float32
        assert 1e-5 < _rel(got, want) < RTOL


def _gd_mesh(m, dim):
    return m.subdivided_hyper_rectangle([0.0] * dim, [1.0, 0.7, 1.3][:dim],
                                        [3, 4, 2][:dim], colorize=True,
                                        dim=dim)


@pytest.mark.parametrize("dim", [2, pytest.param(3, marks=pytest.mark.slow)])
def test_gd_bf16_operator_matches_jax_and_f32(dim):
    """``GDOperator(dtype=torch.bfloat16)`` on a lattice (B3's bf16
    instances' function): residual and exact tangent against the JAX
    operator built in bf16 on its Pallas kernel, and against the port's
    float32 operator on the same inputs."""
    ja = JaxGDOperator(_gd_mesh(jax_mesh, dim), degree_pressure=1, nu=NU,
                       gamma=GAMMA, dtype=jnp.bfloat16)
    assert ja.enable_pallas(interpret=True)
    o16 = GDOperator(_gd_mesh(port_mesh, dim), nu=NU, gamma=GAMMA, **BF16)
    o32 = GDOperator(_gd_mesh(port_mesh, dim), nu=NU, gamma=GAMMA, **F32)
    assert o16.layout_v is not None and o16.kernel._host_tables is not None
    rng = np.random.default_rng(5)
    z = dict(x=_bf16(rng, o16.n_dofs, s=0.3), dx=_bf16(rng, o16.n_dofs),
             vprev=_bf16(rng, o16.Nv, dim, s=0.1),
             fq=_bf16(rng, o16.space_v.n_elements, o16.n_q, dim, s=0.05))
    t16 = {k: state_from_numpy(v, device="cpu", dtype=torch.bfloat16)[0]
           for k, v in z.items()}
    t32 = {k: v.float() for k, v in t16.items()}
    jz = {k: jnp.asarray(v, jnp.bfloat16) for k, v in z.items()}
    a0 = 1.5

    r_ref, dr_ref = jax.jvp(
        lambda w: ja.residual_free(w, jz["vprev"], jz["fq"], a0, 0.0),
        (jz["x"],), (jz["dx"],))
    r = o16.residual_free(t16["x"], t16["vprev"], t16["fq"], a0)
    assert r.dtype == torch.bfloat16
    assert _rel(r, r_ref) < RTOL
    r32 = o32.residual_free(t32["x"], t32["vprev"], t32["fq"], a0)
    assert 1e-5 < _rel(r, r32) < RTOL

    dr = o16.jvp(o16.linearize(t16["x"], t16["vprev"], t16["fq"], a0),
                 t16["dx"])
    assert dr.dtype == torch.bfloat16
    assert _rel(dr, dr_ref) < RTOL
    dr32 = o32.jvp(o32.linearize(t32["x"], t32["vprev"], t32["fq"], a0),
                   t32["dx"])
    assert 1e-5 < _rel(dr, dr32) < RTOL


# ----------------------------------------------------------------------
# the plain version of each bf16 instance
# ----------------------------------------------------------------------
def _widened_equal(got, plain_f32_out):
    """``got`` (the bf16 module's output) is the float32 output rounded
    once to bf16, bit for bit."""
    assert got.dtype == torch.bfloat16
    return torch.equal(got, plain_f32_out.to(torch.bfloat16))


def test_plain_b2_bf16_is_the_rounded_f32_kernel():
    """B2's bf16 plain version: the rows and tables widened to float32,
    ``make_lattice_kernel`` (tau frozen for the tangent and the probes),
    the output rounded once to bf16; the tables are the float64 tables
    rounded once."""
    _, o16, _, x = _gls_pair("2d-q1-lattice", seed=3)
    k = o16.kernel
    assert k.T_all.dtype == torch.bfloat16
    assert k.tables.dtype == torch.bfloat16
    assert torch.equal(k.tables, torch.cat([k.T_all.reshape(-1),
                                            k.T_proj.reshape(-1)]))
    u, v, prev, fq = _port(x, torch.bfloat16)
    ue, due, up, fqr = (o16._rows(u), o16._rows(v), o16._rows(prev),
                        o16._fq_rows(fq))
    w = [t.float() for t in (ue, due, up, fqr)]

    def f32(stab):
        return lattice_kernel.make_lattice_kernel(
            dim=2, nn=4, nq=4, T_all=k.T_all.float(), T_proj=k.T_proj.float(),
            h=k.h, nu=k.nu, stab=stab)

    args = (A0, SDT)
    assert _widened_equal(k.residual(ue, up, fqr, *args),
                          f32(FROZEN)(w[0], w[2], w[3], *args))
    assert _widened_equal(
        k.tangent(ue, due, up, fqr, *args),
        lattice_kernel.lattice_tangent(f32(FROZEN), w[0], w[1], w[2], w[3],
                                       *args))
    assert _widened_equal(
        k.node_blocks(ue, up, fqr, *args),
        lattice_kernel.lattice_node_blocks(f32(FROZEN), w[0], w[2], w[3],
                                           *args, 4))


def test_plain_b1_bf16_is_the_rounded_f32_kernel():
    """B1's bf16 plain version: rows, geometry and tables widened, the
    float32 ``make_batched_kernel``, the output rounded once; the packed
    tables are the rounded B, G, symmetric Hessians and w."""
    _, o16, _, x = _gls_pair("2d-q1-shell", seed=4)
    k = o16.kernel
    assert k.B.dtype == torch.bfloat16 and k.tables.dtype == torch.bfloat16
    Hs = gls_kernel.symmetric_hessians(k.H.double().numpy(), 2)
    packed = np.concatenate([t.reshape(-1) for t in (
        k.B.double().numpy(), k.G.double().numpy(), Hs, k.w.double().numpy())])
    np.testing.assert_array_equal(k.tables.double().numpy(), packed)
    u, v, prev, fq = _port(x, torch.bfloat16)
    ue, due, up, fqr = (o16._soa(u), o16._soa(v), o16._soa(prev),
                        o16._fq_soa(fq))
    xe, h = o16.xe_state, o16.h_state
    assert xe.dtype == torch.bfloat16 and pt.row_pitch(xe) % 8 == 0
    w = [t.float() for t in (ue, due, xe, up, fqr, h)]
    f32 = bk.make_batched_kernel(dim=2, B=k.B.float(), G=k.G.float(),
                                 H=k.H.float(), w=k.w.float(), nu=k.nu,
                                 stab=FROZEN)
    state = (w[2], w[3], w[4], w[5], A0, SDT)
    assert _widened_equal(k.residual(ue, xe, up, fqr, h, A0, SDT),
                          f32(w[0], *state))
    assert _widened_equal(k.tangent(ue, due, xe, up, fqr, h, A0, SDT),
                          bk.tangent_batched(f32, w[0], w[1], *state))
    assert _widened_equal(k.node_blocks(ue, xe, up, fqr, h, A0, SDT),
                          bk.node_blocks_batched(f32, w[0], *state))


def test_plain_b3_bf16_is_the_rounded_f32_kernel():
    """B3's bf16 plain version: the 1D tables rounded once to bf16 are
    what the kernel takes (its 81 packed entries); the plain version's
    dense tables are their tensor products (float32), and its output the
    float32 plain kernel's on the widened rows, rounded once."""
    m = _gd_mesh(port_mesh, 2)
    o16 = GDOperator(m, nu=NU, gamma=GAMMA, **BF16)
    k = o16.kernel
    gk = lattice_gd_kernel
    tab = gk.gd_1d_tables(2, *k.geometry)
    rounded = {key: torch.as_tensor(v).float().bfloat16().double().numpy()
               for key, v in tab.items()}
    assert k._host_tables.dtype == torch.bfloat16
    np.testing.assert_array_equal(k._host_tables.double().numpy(),
                                  gk.pack_1d_tables(rounded))
    dense = gk.dense_from_1d(2, rounded)
    for got, want in zip((k.Tv, k.Pv, k.Tp, k.Pp), dense):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    rng = np.random.default_rng(8)
    t = [state_from_numpy(_bf16(rng, *shape), device="cpu",
                          dtype=torch.bfloat16)[0]
         for shape in ((o16.n_dofs,), (o16.n_dofs,), (o16.Nv, 2),
                       (12, o16.n_q, 2))]
    ue, due, vpe, fq = (o16._rows(t[0]), o16._rows(t[1]), o16._vrows(t[2]),
                        o16._fq_rows(t[3]))
    f32 = gk.make_lattice_gd_kernel(dim=2, nnv=9, nq=9, Tv=k.Tv, Pv=k.Pv,
                                    Tp=k.Tp, Pp=k.Pp, nu=NU, gamma=GAMMA)
    assert _widened_equal(k.residual(ue, vpe, fq, 1.5),
                          f32(ue.float(), vpe.float(), fq.float(), 1.5))
    want = torch.func.jvp(lambda v: f32(v, None, None, 1.5), (ue.float(),),
                          (due.float(),))[1]
    assert _widened_equal(k.tangent(ue, due, 1.5), want)


def test_interop_rounds_through_float32_once():
    """``state_from_numpy(..., dtype=torch.bfloat16)``: float64 values go
    to float32 and are rounded to bf16 from there, as ``Tensor.bfloat16``
    rounds a float32 tensor."""
    x = np.random.default_rng(2).standard_normal(257) * 3.0
    u, (p,) = state_from_numpy(x, [x * 0.5], device="cpu",
                               dtype=torch.bfloat16)
    assert u.dtype == p.dtype == torch.bfloat16
    assert torch.equal(u, torch.as_tensor(x.astype(np.float32)).bfloat16())
    assert torch.equal(p, torch.as_tensor((x * 0.5).astype(np.float32))
                       .bfloat16())


# ----------------------------------------------------------------------
# host side of the bf16-operand instances
# ----------------------------------------------------------------------
def _b1_instances():
    for dim, degree in sorted(gls_kernel.SUPPORTED):
        for mode in range(3):
            yield (dim, degree, mode, pt.STAGED, 1), {}
            if (dim, degree) in gls_kernel.REGISTER_SHAPES:
                for split in gls_kernel.REG_SPLITS[dim]:
                    yield (dim, degree, mode, pt.REGISTERS, split), {}
    for dim, degree, q1d in sorted(gls_kernel.OTHER_POINTS):
        for mode in range(3):
            yield (dim, degree, mode, pt.STAGED, 1), {"points": q1d}


def _b2_instances():
    for shape in sorted(lattice_kernel.SUPPORTED):
        for mode in range(3):
            yield (*shape, mode, pt.STAGED), {}
            if shape in lattice_kernel.REGISTER_SHAPES:
                yield (*shape, mode, pt.REGISTERS), {}


def _b3_instances():
    for dim in (2, 3):
        for mode in range(2):
            for route in ((pt.STAGED, pt.REGISTERS)
                          if dim in lattice_gd_kernel.REGISTER_DIMS
                          else (pt.STAGED,)):
                yield (dim, mode, route), {}


@pytest.mark.parametrize("module,instances", [
    (gls_kernel, _b1_instances), (lattice_kernel, _b2_instances),
    (lattice_gd_kernel, _b3_instances)], ids=["B1", "B2", "B3"])
def test_bf16_operand_tile_config(module, instances):
    """The Python mirror of the bf16-operand instances, which chip_smoke.py
    phase 2 holds to the compiled kernels: every row 2 bytes an element,
    TMA box widths a multiple of 16 bytes, one block's shared memory at
    most the float32 instance's (B1 and B2: also at most the bf16-state
    instance's, their staged tables halved) and within 227 KB, at most
    1,024 threads, the same threads and tile as float32."""
    n = 0
    for variant, kw in instances():
        state = {} if module is lattice_gd_kernel else {"state_bytes": 2}
        cfg = module.tile_config(*variant, **kw, **state, operand_bytes=2)
        f32 = module.tile_config(*variant, **kw)
        if module is lattice_gd_kernel:
            assert set(cfg.get("elem_bytes", (2,))) == {2}
        else:
            assert set(cfg["elem_bytes"]) == {2}
            s16 = module.tile_config(*variant, **kw, state_bytes=2)
            assert cfg["smem_bytes"] <= s16["smem_bytes"]
        assert cfg["rows"] == f32["rows"] and cfg["be"] == f32["be"]
        assert cfg["threads"] == f32["threads"] <= 1024
        assert cfg["be"] * 2 % 16 == 0
        assert cfg["smem_bytes"] <= f32["smem_bytes"] <= pt.SMEM_LIMIT
        n += 1
    assert n == {gls_kernel: 39, lattice_kernel: 24,
                 lattice_gd_kernel: 6}[module]
    # staged tables: B2 3D Q1 T_all + T_proj, 2 x 40 x 8 entries, in 320
    # words for bf16 against 640; B1 2D Q2's 495 entries in 256 (248
    # rounded up to 128 bytes)
    assert pt.table_words(2 * 40 * 8, 2) == 320
    assert pt.table_words(2 * 40 * 8) == 640
    assert pt.table_words(495, 2) == 256


def test_bf16_operand_launch_plan(monkeypatch):
    """B1's, B2's and B3's launch plans of a bf16 module ask the card for
    the bf16-operand instance's occupancy (a card on which it fits twice
    the blocks of the float32 one), and the module packs its tables in
    bf16."""
    seen = []

    def config(*variant, operand_bytes=4, **kw):
        seen.append(operand_bytes)
        return (8 if operand_bytes == 2 else 4, 0, 128)

    monkeypatch.setattr(pt, "sm_count", lambda device: 132)
    for module in (gls_kernel, lattice_kernel, lattice_gd_kernel):
        monkeypatch.setattr(module, "config_on_card", config)
    dev, E = torch.device("cuda", 0), 16 * 132 * 16
    o16 = GLSOperator(FESpace(_gls_mesh(port_mesh, "2d-q1-shell"), 2),
                      nu=NU, **BF16)
    assert o16.kernel._plan(1, E, dev, "staged", None, 2)[2] == 8 * 132
    lat = GLSOperator(FESpace(_gls_mesh(port_mesh, "3d-q1-lattice"), 2),
                      nu=NU, **BF16)
    assert lat.kernel._plan(1, 3, E, dev, "auto", 2)[1] == 8 * 132
    gd = GDOperator(_gd_mesh(port_mesh, 3), nu=NU, gamma=GAMMA, **BF16)
    assert gd.kernel._plan(1, E, dev, "auto")[1] == 8 * 132
    assert seen == [2, 2, 2]


def test_bf16_operand_launch_checks():
    """An all-bf16 launch: every row, the direction, the tables and the
    output bf16 at one even pitch; a float32 tensor among them, or rows
    at two pitches, is refused.  A dtype that no instance takes is
    refused when a kernel is built for the card, naming the dtype."""
    E = 13
    rows = [pt.narrow_rows(torch.ones(6, E)), pt.narrow_rows(torch.ones(E))]
    out = pt.empty_rows((6, E), pt.row_pitch(rows[0]), "cpu")
    tables = torch.ones(40, dtype=torch.bfloat16)
    state = [(rows[0], (6, E)), (rows[1], (E,)), (out, (6, E)),
             (tables, (40,))]
    assert pt.row_pitch(out) == 16 and out.dtype == torch.bfloat16
    assert pt.check_rows("test", -1, state, []) == 16
    with pytest.raises(ValueError, match="bf16 state rows"):
        pt.check_rows("test", -1, state + [(torch.ones(6, E), (6, E))], [])
    with pytest.raises(ValueError, match="different row pitches"):
        pt.check_rows("test", -1, state + [
            (torch.zeros(6, 14, dtype=torch.bfloat16)[:, :E], (6, E))], [])
    # rows already at the bf16 pitch are taken as they are
    assert pt.narrow_rows(rows[0]) is rows[0]
    assert pt.narrow_rows(torch.ones(3, 16).bfloat16()).stride() == (16, 1)
    space = FESpace(_gls_mesh(port_mesh, "2d-q1-shell"), 1)
    for module, kw in ((gls_kernel.GLSElementKernel, {}),):
        _, w, B, G, H = space.basis.quadrature(2)
        with pytest.raises(ValueError, match="float16"):
            module(dim=2, degree=1, B=B, G=G, H=H, w=w, nu=NU,
                   stab=StabFlags(), dtype=torch.float16, device="cuda",
                   **kw)
    with pytest.raises(ValueError, match="float64"):
        GLSOperator(FESpace(_gls_mesh(port_mesh, "2d-q1-lattice"), 1),
                    nu=NU, dtype=torch.float64, device="cuda")
    _, w, Bv, Gv, _ = FESpace(_gd_mesh(port_mesh, 2), 2).basis.quadrature(3)
    _, _, Bp, _, _ = FESpace(_gd_mesh(port_mesh, 2), 1).basis.quadrature(3)
    with pytest.raises(ValueError, match="float16"):
        lattice_gd_kernel.LatticeGDKernel(
            dim=2, degree_pressure=1, Bv=Bv, Gv=Gv, Bp=Bp, w=w,
            xe0=FESpace(_gd_mesh(port_mesh, 2), 2).element_coords()[0],
            nu=NU, gamma=GAMMA, dtype=torch.float16, device="cuda")
