"""The bf16 Jacobian state of the GLS operator (``jacobian state
precision = bf16``) against the JAX package's TPU kernels with
``state_dtype=bfloat16``, on the same inputs made with numpy.

The state the tangent and the node-block probes read (ue, up, fq, and B1's
xe and h) is rounded to bf16 once; every element is widened on read and
all arithmetic stays float64 here.  The inputs are float32 values widened
to float64, so both packages round them to the same bf16 values (both
round float64 through float32).

- ``GLSOperator(state_dtype=torch.bfloat16)``: the tangent against the
  JAX operator with ``enable_pallas(interpret=True,
  state_dtype=bfloat16)``, and the kernels' node blocks against
  ``node_block_rows`` of ``PallasGLS`` / ``PallasLatticeGLS``, on a 2D Q1
  lattice (B2), a 2D Q1 curved shell (B1) and a 3D Q1 lattice (B2):
  within 1e-12 of scale (float64, different summation order);
- the residual is bitwise the float32-state operator's, and the bf16
  tangent sits between 1e-7 and 2e-2 of scale from the frozen-tau
  float32-state tangent (the bounds of ``tests/test_pallas_lattice.py``'s
  bf16-state test);
- the coarse multigrid levels carry the state dtype; the launch plans and
  the host checks of the kernels keep the two state types apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softx_2020_200_tpu.fem import mesh as jax_mesh
from softx_2020_200_tpu.fem.dof import FESpace as JaxFESpace
from softx_2020_200_tpu.ops.operators import gather_elements
from softx_2020_200_tpu.solvers import gls as jax_gls
from softx_2020_200_tpu_torch.core.parameters import SimulationParameters
from softx_2020_200_tpu_torch.fem import mesh as port_mesh
from softx_2020_200_tpu_torch.fem.dof import FESpace
from softx_2020_200_tpu_torch.ops import gls_kernel, lattice_kernel
from softx_2020_200_tpu_torch.ops import persistent_tiles as pt
from softx_2020_200_tpu_torch.ops.multigrid import build_hierarchy
from softx_2020_200_tpu_torch.solvers.base import GLSNavierStokesSolver
from softx_2020_200_tpu_torch.solvers.gls import GLSOperator, StabFlags

torch.set_num_threads(1)

RTOL = 1e-12
NU = 0.05
A0, SDT = 2.0, 4.0
CPU = dict(device="cpu", dtype=torch.float64)
BF16 = dict(CPU, state_dtype=torch.bfloat16)


def _mesh(m, case):
    if case == "2d-q1-shell":
        return m.hyper_shell([0.0, 0.0], 0.25, 1.0, 6)
    dim, cells = (2, [4, 4]) if case == "2d-q1-lattice" else (3, [3, 2, 2])
    return m.subdivided_hyper_rectangle([0.0] * dim, [1.0, 0.7, 1.3][:dim],
                                        cells, colorize=True, dim=dim)


CASES = ("2d-q1-lattice", "2d-q1-shell", "3d-q1-lattice")


def _setup(case, seed=3):
    """The JAX and the port's space on the same mesh, and float32-exact
    float64 data."""
    sa = JaxFESpace(_mesh(jax_mesh, case), 1)
    sb = FESpace(_mesh(port_mesh, case), 1)
    rng = np.random.default_rng(seed)
    dim = sa.dim
    N, c, E, nq = sa.n_nodes, dim + 1, sa.n_elements, 2 ** dim

    def f32(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32).astype(
            np.float64)

    data = dict(u=f32(N, c, s=0.3), v=f32(N, c), prev=f32(N, dim, s=0.2),
                fq=f32(E, nq, dim), mask=rng.random((N, c)) < 0.2)
    return sa, sb, data


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("case", CASES)
def test_bf16_state_tangent_matches_tpu_kernel(case):
    """J v through the port's operator with a bf16 state against the JAX
    operator on its Pallas kernel (B1 on the shell, B2 on the lattices)
    with ``state_dtype=bfloat16``, in interpret mode."""
    sa, sb, x = _setup(case)
    ja = jax_gls.GLSOperator(sa, nu=NU, dtype=jnp.float64)
    ja.enable_pallas(interpret=True, state_dtype=jnp.bfloat16)
    op = GLSOperator(sb, nu=NU, **BF16)
    assert (op.layout is None) == (case == "2d-q1-shell")
    u, v, prev, fq = (jnp.asarray(x[k]) for k in ("u", "v", "prev", "fq"))
    dr_ref = jax.jvp(lambda w: ja.residual_free(w, prev, fq, A0, SDT),
                     (u,), (v,))[1]
    state = op.linearize(_t(x["u"]), _t(x["prev"]), _t(x["fq"]), A0, SDT)
    assert state.ue.dtype == torch.bfloat16
    assert _rel(op.jvp(state, _t(x["v"])), dr_ref) < RTOL


def _tpu_node_blocks(sa, x):
    """The JAX TPU kernel's node blocks with a bf16 state [nn, c*c, E],
    in the port's row orders (element order of the space for B1, of the
    lattice for B2)."""
    nn, c, E = sa.basis.n_nodes, sa.dim + 1, sa.n_elements
    u, prev, fq = (jnp.asarray(x[k]) for k in ("u", "prev", "fq"))
    ja = jax_gls.GLSOperator(sa, nu=NU, dtype=jnp.float64)
    ja.enable_pallas(interpret=True, state_dtype=jnp.bfloat16)
    pg = ja._pallas
    if sa.mesh.structured_shape is None:
        en = jnp.asarray(sa.elem_nodes)
        br = pg.node_block_rows(pg.to_rows(gather_elements(u, en)),
                                pg.to_rows(gather_elements(prev, en)),
                                pg.to_rows(fq), A0, SDT)
        return br.reshape(nn, c * c, pg.Ep)[:, :, :E]
    sl = ja._structured
    fqg = fq[ja._sl_perm]
    dim, nq = sa.dim, fq.shape[1]
    ue2 = pg.rows_from_list(sl.gather_rows_list(u), (nn, c))
    up2 = pg.rows_from_list(sl.gather_rows_list(prev), (nn, dim))
    fq2 = pg.rows_from_list([fqg[:, q, i] for q in range(nq)
                             for i in range(dim)], (nq, dim))
    return pg.node_block_rows(ue2, up2, fq2, A0, SDT)[:, :, :E]


@pytest.mark.parametrize("case", CASES)
def test_bf16_state_node_blocks_match_tpu_kernel(case):
    """The kernels' node blocks on the operator's bf16 state rows against
    ``node_block_rows`` of the TPU kernel with ``state_dtype=bfloat16``."""
    sa, sb, x = _setup(case, seed=4)
    op = GLSOperator(sb, nu=NU, **BF16)
    state = op.linearize(_t(x["u"]), _t(x["prev"]), _t(x["fq"]), A0, SDT)
    if op.layout is None:
        got = op.kernel.node_blocks(state.ue, op.xe_state, state.up,
                                    state.fq, op.h_state, A0, SDT)
    else:
        got = op.kernel.node_blocks(state.ue, state.up, state.fq, A0, SDT)
    assert got.dtype == torch.float64
    assert _rel(got, _tpu_node_blocks(sa, x)) < RTOL


@pytest.mark.parametrize("case", CASES)
def test_bf16_state_leaves_the_residual_bitwise(case):
    """The residual reads no rounded state: bitwise the float32-state
    operator's (in float32, as on the card)."""
    _, sb, x = _setup(case)
    f32 = dict(device="cpu", dtype=torch.float32)
    op32 = GLSOperator(sb, nu=NU, **f32)
    op16 = GLSOperator(sb, nu=NU, state_dtype=torch.bfloat16, **f32)
    args = [_t(x[k]).float() for k in ("u", "prev", "fq")]
    assert torch.equal(op16.residual_free(*args, A0, SDT),
                       op32.residual_free(*args, A0, SDT))


@pytest.mark.parametrize("case", CASES)
def test_bf16_tangent_within_bf16_rounding_of_f32(case):
    """The bf16-state tangent and node blocks differ from the float32-state
    frozen-tau ones by bf16 rounding of the coefficients: more than 1e-7
    and less than 2e-2 of scale."""
    _, sb, x = _setup(case, seed=6)
    frozen = StabFlags(frozen_tau=True)
    op32 = GLSOperator(sb, nu=NU, stab=frozen, **CPU)
    op16 = GLSOperator(sb, nu=NU, **BF16)
    u, v, prev, fq = (_t(x[k]) for k in ("u", "v", "prev", "fq"))
    mask = torch.as_tensor(x["mask"])
    d32 = op32.jvp(op32.linearize(u, prev, fq, A0, SDT), v)
    d16 = op16.jvp(op16.linearize(u, prev, fq, A0, SDT), v)
    assert 1e-7 < _rel(d16, d32) < 2e-2
    b32 = op32.node_blocks(u, mask, prev, fq, A0, SDT)
    b16 = op16.node_blocks(u, mask, prev, fq, A0, SDT)
    assert 1e-7 < _rel(b16, b32) < 2e-2


DECK = """
subsection simulation control
  set method = steady
end
subsection FEM
  set velocity order = 2
  set pressure order = 2
end
subsection mesh
  set type = dealii
  set grid type = hyper_cube
  set grid arguments = 0 : 1 : true
  set initial refinement = 3
end
subsection linear solver
  set preconditioner = gmg
  set jacobian state precision = {precision}
end
"""


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_coarse_levels_carry_the_state_dtype(precision):
    """Every multigrid level (the Q1 p-level and the halved lattices)
    stores its Jacobian state as the fine level does."""
    prm = SimulationParameters.from_text(DECK.format(precision=precision),
                                         dim=2)
    solver = GLSNavierStokesSolver(prm, device="cpu", dtype=torch.float64)
    levels = build_hierarchy(solver, min_elems=16)
    want = torch.bfloat16 if precision == "bf16" else None
    assert len(levels) == 3
    assert [lv.op.degree for lv in levels] == [2, 1, 1]
    assert all(lv.op.state_dtype is want for lv in levels)


def _patch_card(monkeypatch, module):
    """A card of 132 SMs on which a bf16 variant fits twice the blocks of
    its float32 one; returns the (state bytes) of every config lookup."""
    seen = []

    def config(*variant):
        sb = variant[-1]
        seen.append(sb)
        return (8 if sb == 2 else 4, 0, 128)

    monkeypatch.setattr(pt, "sm_count", lambda device: 132)
    monkeypatch.setattr(module, "config_on_card", config)
    return seen


def test_element_plan_keeps_state_types_apart(monkeypatch):
    """B1's launch plan is per state type: a bf16 probe planned after a
    float32 one of the same E gets its own occupancy and grid."""
    seen = _patch_card(monkeypatch, gls_kernel)
    k = gls_kernel.GLSElementKernel(
        dim=3, degree=2, B=np.ones((27, 27)), G=np.ones((27, 27, 3)),
        H=np.ones((27, 27, 3, 3)), w=np.ones(27), nu=NU, stab=StabFlags(),
        dtype=torch.float64, device="cpu")
    E, dev = 16 * 132 * 16, torch.device("cuda", 0)
    probe = gls_kernel._PROBE
    assert k._plan(probe, E, dev, "auto", None)[2] == 4 * 132
    assert k._plan(probe, E, dev, "auto", None, 2)[2] == 8 * 132
    assert k._plan(probe, E, dev, "auto", None)[2] == 4 * 132
    assert seen == [4, 2]


def test_lattice_plan_keeps_state_types_apart(monkeypatch):
    """B2's launch plan is per state type, as B1's."""
    seen = _patch_card(monkeypatch, lattice_kernel)
    basis_space = FESpace(_mesh(port_mesh, "3d-q1-lattice"), 2)
    _, w, B, G, H = basis_space.basis.quadrature(3)
    k = lattice_kernel.LatticeGLSKernel(
        dim=3, degree=2, B=B, G=G, H=H, w=w,
        xe0=basis_space.element_coords()[0], nu=NU, stab=StabFlags(),
        dtype=torch.float64, device="cpu")
    E, dev = 16 * 132 * 16, torch.device("cuda", 0)
    tangent = lattice_kernel._TANGENT
    assert k._plan(tangent, 3, E, dev, "auto")[1] == 4 * 132
    assert k._plan(tangent, 3, E, dev, "auto", 2)[1] == 8 * 132
    assert seen == [4, 2]


def test_state_rows_layout():
    """``state_rows``: bf16 rows whose pitch is E rounded up to 8 (16
    bytes), zero-padded, rounded through float32, read back as a view."""
    x = torch.as_tensor(np.random.default_rng(1).standard_normal((3, 4, 13)))
    s = pt.state_rows(x)
    assert s.shape == x.shape and s.dtype == torch.bfloat16
    assert s.stride() == (4 * 16, 16, 1) and pt.row_pitch(s) == 16
    torch.testing.assert_close(s, x.float().bfloat16(), rtol=0, atol=0)
    assert not s.untyped_storage().nbytes() % 16
    padded = torch.frombuffer(bytearray(s.untyped_storage()),
                              dtype=torch.bfloat16).view(3, 4, 16)
    assert torch.count_nonzero(padded[..., 13:]) == 0
    # the pitch of a contiguous tensor is E; of a column slice, none
    assert pt.row_pitch(torch.zeros(5, 7)) == 7
    assert pt.row_pitch(torch.zeros(7)) == 7
    assert pt.row_pitch(torch.zeros(7, 5).t()) is None
    assert pt.row_pitch(torch.zeros(4, 3, 10)[:, :2]) is None


def test_launch_checks_and_load_path_take_bf16_rows():
    """The host check of a launch takes bf16 state rows at one even pitch
    beside float32 rows, and refuses mixed or misaligned state; the load
    path counts the bf16 pitch in bytes."""
    E = 13
    f32 = [(torch.zeros(4, E), (4, E))]
    rows = [pt.state_rows(torch.ones(6, E)), pt.state_rows(torch.ones(E))]
    state = [(rows[0], (6, E)), (rows[1], (E,))]
    assert pt.check_rows("test", -1, state, f32) == 16
    with pytest.raises(ValueError, match="bf16 state rows"):
        pt.check_rows("test", -1, [(rows[0], (6, E)),
                                   (torch.ones(4, E), (4, E))], f32)
    odd = torch.zeros(6, 15, dtype=torch.bfloat16)[:, :E]
    with pytest.raises(ValueError, match="even row pitch"):
        pt.check_rows("test", -1, [(odd, (6, E))], f32)
    with pytest.raises(ValueError, match="different row pitches"):
        pt.check_rows("test", -1, [(rows[0], (6, E)),
                                   (pt.state_rows(torch.ones(2, 20)),
                                    (2, 20))], [])
    with pytest.raises(ValueError, match="contiguous float32"):
        pt.check_rows("test", -1, [(torch.ones(6, E), (6, E))],
                      [(torch.zeros(4, E, dtype=torch.float64), (4, E))])
    aligned = [0x7f0000000000, 0x7f0000000100]
    # a bf16 pitch of 8 elements is 16 bytes (TMA) at any E; beside the
    # f32 rows of an odd E the launch takes 4-byte cp.async
    assert pt.load_path(E, aligned, [2 * 16]) == pt.LOAD_TMA
    assert pt.load_path(E, aligned, [2 * 16, 4 * E]) == pt.LOAD_CP_ASYNC_4
    assert pt.load_path(E, aligned, [2 * 14]) == pt.LOAD_CP_ASYNC_4


@pytest.mark.parametrize("module,args", [
    (gls_kernel, [(d, k, m, r, s) for d, k in sorted(gls_kernel.SUPPORTED)
                  for m in gls_kernel.BF16_MODES
                  for r, s in ((0, 1),) + tuple(
                      (1, n) for n in gls_kernel.REG_SPLITS[d]
                      if (d, k) in gls_kernel.REGISTER_SHAPES)]),
    (lattice_kernel, [(*shape, m, r)
                      for shape in sorted(lattice_kernel.SUPPORTED)
                      for m in lattice_kernel.BF16_MODES
                      for r in ((0, 1) if shape in
                                lattice_kernel.REGISTER_SHAPES else (0,))]),
], ids=["B1", "B2"])
def test_bf16_tile_config(module, args):
    """The Python mirror of the bf16 variants' layout: state boxes of 2
    bytes an element (the direction stays 4), TMA inner extents a multiple
    of 16 bytes, a stage no larger than the float32 variant's, and every
    variant within one block's shared memory."""
    for variant in args:
        cfg32 = module.tile_config(*variant)
        cfg16 = module.tile_config(*variant, state_bytes=2)
        assert cfg16["rows"] == cfg32["rows"]
        assert cfg16["elem_bytes"][1] == 4
        assert {e for i, e in enumerate(cfg16["elem_bytes"]) if i != 1} \
            == {2}
        assert cfg16["be"] * 2 % 16 == 0
        assert cfg16["smem_bytes"] <= cfg32["smem_bytes"] <= pt.SMEM_LIMIT
