"""The decomposition of the Hopper GLS element kernel (B1,
``csrc/gls_element.cu``), transcribed in float64 PyTorch and held against
the port's plain kernel (``ops/batched_kernel.py::make_batched_kernel``),
and the host-side helpers of the persistent-tile skeleton
(``ops/persistent_tiles.py``, the ``tile_config`` mirrors).

The CUDA kernel cannot run here, so its arithmetic is checked in the
order it does it:

- the STAGED route: phase A, one (point, element) at a time, computes
  J, J^-1 and Km = J^-1 J^-T, values, gradients and Laplacians (through
  the symmetric Hessian table ``Hs`` and Km), the physics, and stages the
  reference-frame coefficients a_v, ag_ref = a_g J^-T, apg_ref, a_p,
  a_lap and Km; phase B, one (node, element) at a time, contracts them
  with B, G and Hs;
- the REGISTERS route: per element, each of ``split`` threads walks every
  split-th point into its own accumulators, and the parts are summed.

Each is held against the plain kernel: the primal residual, the frozen
tangent (tau and the LSIC coefficient frozen, by forward-mode AD through
the plain kernel) and the node blocks (one-hot probes), on a curved
shell and on a box with moved vertices, without and with LSIC.
Tolerance: 1e-12 of the max-abs scale (float64, different summation
order).
"""

import numpy as np
import pytest
import torch

from softx_2020_200_tpu_torch.fem import mesh as port_mesh
from softx_2020_200_tpu_torch.fem.dof import FESpace
from softx_2020_200_tpu_torch.ops import gls_kernel, lattice_kernel
from softx_2020_200_tpu_torch.ops import persistent_tiles as pt
from softx_2020_200_tpu_torch.ops.batched_kernel import (node_blocks_batched,
                                                         tangent_batched)
from softx_2020_200_tpu_torch.solvers.gls import GLSOperator, StabFlags

torch.set_num_threads(1)

RTOL = 1e-12
NU = 0.05
A0, SDT = 2.0, 4.0


# ----------------------------------------------------------------------
# the transcription
# ----------------------------------------------------------------------
def _inverse(J):
    """J [d, d, E] -> (det [E], J^-1 [d, d, E])."""
    Jm = J.permute(2, 0, 1)
    return torch.linalg.det(Jm), torch.linalg.inv(Jm).permute(1, 2, 0)


def _pairs(d):
    return [(a, b) for a in range(d) for b in range(a, d)]


def _weak_form(mode, flags, scale, h, uq, grad, lap, upq, f, duq, dgrad,
               dlap):
    """``weak_form`` of gls_element.cu over a batch: uq [c, E],
    grad [c, d, E], lap/upq/f [d, E], upq the time derivative
    interpolated from its nodal values A0 u + u^{n-i} terms (and the
    direction's for the tangent and the probe) -> a_v [d, E], a_g [d, d, E], a_p [E], a_pg [d, E],
    a_lap [d, E], pre-multiplied by det J * w."""
    d = grad.shape[1]
    inv_h2 = 1.0 / (h * h)
    visc = 9.0 * (4.0 * NU) ** 2 * inv_h2 * inv_h2
    udot = upq
    conv = torch.einsum("ijE,jE->iE", grad[:d], uq[:d])
    r_m = udot + conv + grad[d] - NU * lap - f
    div = sum(grad[i, i] for i in range(d))
    umag2 = (uq[:d] ** 2).sum(0)
    tau = 1.0 / torch.sqrt(SDT * SDT + 4.0 * umag2 * inv_h2 + visc)
    tau_l = 0.5 * torch.sqrt(umag2) * h
    eye = torch.eye(d, dtype=uq.dtype)[:, :, None]
    if mode == "primal":
        a_v = scale * (udot + conv - f)
        a_g = scale * NU * grad[:d] - eye * (scale * uq[d])
        if flags.supg:
            a_g = a_g + scale * tau * r_m[:, None] * uq[None, :d]
        if flags.lsic:
            a_g = a_g + eye * (tau_l * scale * div)
        a_pg = scale * tau * r_m if flags.pspg else torch.zeros_like(r_m)
        a_lap = (-scale * tau * NU * r_m if flags.gls_viscous_adjoint
                 else torch.zeros_like(r_m))
        return a_v, a_g, scale * div, a_pg, a_lap
    dudot = A0 * duq[:d]
    dconv = (torch.einsum("ijE,jE->iE", dgrad[:d], uq[:d])
             + torch.einsum("ijE,jE->iE", grad[:d], duq[:d]))
    dr_m = dudot + dconv + dgrad[d] - NU * dlap
    ddiv = sum(dgrad[i, i] for i in range(d))
    a_v = scale * (dudot + dconv)
    a_g = scale * NU * dgrad[:d] - eye * (scale * duq[d])
    if flags.supg:
        a_g = a_g + scale * tau * (dr_m[:, None] * uq[None, :d]
                                   + r_m[:, None] * duq[None, :d])
    if flags.lsic:
        a_g = a_g + eye * (tau_l * scale * ddiv)
    a_pg = scale * tau * dr_m if flags.pspg else torch.zeros_like(dr_m)
    a_lap = (-scale * tau * NU * dr_m if flags.gls_viscous_adjoint
             else torch.zeros_like(dr_m))
    return a_v, a_g, scale * ddiv, a_pg, a_lap


class _Point:
    """The quantities of one quadrature point q of every element, as both
    routes compute them: geometry, values/gradients/Laplacians and the
    direction (``due`` for the tangent, one-hot (n0, j0) for the probe)."""

    def __init__(self, k, q, ue, xe, up, fq, h, mode, due=None, probe=None):
        d, c = k.dim, k.nc
        B, G, w = k.B.double(), k.G.double(), k.w.double()
        Hs = torch.as_tensor(gls_kernel.symmetric_hessians(
            k.H.double().numpy(), d))
        self.Bq, self.Gq, self.Hq = B[q], G[q], Hs[q]
        J = torch.einsum("niE,nj->ijE", xe, G[q])
        det, self.Ji = _inverse(J)
        self.scale = det * w[q]
        self.Ks = torch.stack([(self.Ji[a] * self.Ji[b]).sum(0)
                               for a, b in _pairs(d)])          # [nh, E]
        self.lap_phi = torch.einsum("nk,kE->nE", Hs[q], self.Ks)  # [nn, E]

        def fields(u):
            val = torch.einsum("n,ncE->cE", B[q], u)
            dref = torch.einsum("na,ncE->caE", G[q], u)
            grad = torch.einsum("caE,aiE->ciE", dref, self.Ji)
            lap = torch.einsum("nE,niE->iE", self.lap_phi, u[:, :d])
            return val, grad, lap

        self.uq, self.grad, self.lap = fields(ue)
        self.upq = torch.einsum("n,niE->iE", B[q], A0 * ue[:, :d] + up)
        self.f = fq[q]
        E = ue.shape[-1]
        self.duq = self.dgrad = self.dlap = None
        if mode == "tangent":
            self.duq, self.dgrad, self.dlap = fields(due)
        elif mode == "probe":
            n0, j0 = probe
            gphys = torch.einsum("a,aiE->iE", G[q, n0], self.Ji)
            self.duq = torch.zeros(c, E, dtype=ue.dtype)
            self.dgrad = torch.zeros(c, d, E, dtype=ue.dtype)
            self.dlap = torch.zeros(d, E, dtype=ue.dtype)
            self.duq[j0] = B[q, n0]
            self.dgrad[j0] = gphys
            if j0 < d:
                self.dlap[j0] = self.lap_phi[n0]
        self.h = h

    def coefficients(self, mode, flags):
        return _weak_form(mode, flags, self.scale, self.h, self.uq, self.grad,
                          self.lap, self.upq, self.f, self.duq, self.dgrad,
                          self.dlap)


def _staged(k, mode, flags, ue, xe, up, fq, h, due=None, probe=None):
    """The STAGED route: phase A stages [nq, ncoef, E] coefficients in the
    kernel's order (a_v, ag_ref, apg_ref, a_p, a_lap, Km); phase B
    contracts them per node.  Returns out [nn, c, E] (for the probe, the
    node n0 row only)."""
    d, c, nn, nq = k.dim, k.nc, k.nn, k.nq
    nh = d * (d + 1) // 2
    stage = []
    for q in range(nq):
        pt_ = _Point(k, q, ue, xe, up, fq, h, mode, due, probe)
        a_v, a_g, a_p, a_pg, a_lap = pt_.coefficients(mode, flags)
        ag_ref = torch.einsum("ijE,ajE->iaE", a_g, pt_.Ji)
        apg_ref = torch.einsum("jE,ajE->aE", a_pg, pt_.Ji)
        stage.append(torch.cat([a_v, ag_ref.reshape(d * d, -1), apg_ref,
                                a_p[None], a_lap, pt_.Ks]))
    coef = torch.stack(stage)                          # [nq, ncoef, E]
    AV, AG, APG = 0, d, d + d * d
    AP, ALAP, KM = APG + d, APG + d + 1, APG + 2 * d + 1
    B, G = k.B.double(), k.G.double()
    Hs = torch.as_tensor(gls_kernel.symmetric_hessians(k.H.double().numpy(),
                                                       d))
    out = torch.zeros(nn, c, ue.shape[-1], dtype=ue.dtype)
    nodes = [probe[0]] if mode == "probe" else range(nn)
    for n in nodes:
        lp = torch.einsum("qk,qkE->qE", Hs[:, n], coef[:, KM:KM + nh])
        for i in range(d):
            out[n, i] = (torch.einsum("q,qE->E", B[:, n], coef[:, AV + i])
                         + (lp * coef[:, ALAP + i]).sum(0)
                         + torch.einsum("qa,qaE->E", G[:, n],
                                        coef[:, AG + i * d:AG + i * d + d]))
        out[n, d] = (torch.einsum("q,qE->E", B[:, n], coef[:, AP])
                     + torch.einsum("qa,qaE->E", G[:, n],
                                    coef[:, APG:APG + d]))
    return out


def _registers(k, mode, flags, ue, xe, up, fq, h, due=None, probe=None,
               split=1):
    """The REGISTERS route: each of ``split`` threads per element walks
    points part, part + split, ... into its own nn*c accumulators (lap_phi
    per node from Hs and Km); the parts are then summed, as the warp
    shuffles do."""
    d, c, nn, nq = k.dim, k.nc, k.nn, k.nq
    parts = []
    for part in range(split):
        acc = torch.zeros(nn, c, ue.shape[-1], dtype=ue.dtype)
        for q in range(part, nq, split):
            pt_ = _Point(k, q, ue, xe, up, fq, h, mode, due, probe)
            a_v, a_g, a_p, a_pg, a_lap = pt_.coefficients(mode, flags)
            ag_ref = torch.einsum("ijE,ajE->iaE", a_g, pt_.Ji)
            apg_ref = torch.einsum("jE,ajE->aE", a_pg, pt_.Ji)
            for n in range(nn):
                acc[n, :d] += (pt_.Bq[n] * a_v + pt_.lap_phi[n] * a_lap
                               + torch.einsum("a,iaE->iE", pt_.Gq[n],
                                              ag_ref))
                acc[n, d] += (pt_.Bq[n] * a_p
                              + torch.einsum("a,aE->E", pt_.Gq[n], apg_ref))
        parts.append(acc)
    return sum(parts)


# ----------------------------------------------------------------------
# against the plain kernel
# ----------------------------------------------------------------------
def _space(dim, degree, geometry):
    if geometry == "shell":
        m = (port_mesh.hyper_shell([0.0, 0.0], 0.25, 1.0, 6) if dim == 2
             else port_mesh.hyper_shell([0.0, 0.0, 0.0], 0.5, 1.0))
    else:
        cells = [3, 2, 2][:dim]
        m = port_mesh.subdivided_hyper_rectangle([0.0] * dim, [1.0] * dim,
                                                 cells, colorize=True,
                                                 dim=dim)
        v = m.vertices
        inner = np.all((v > 1e-9) & (v < 1 - 1e-9), axis=1)
        rng = np.random.default_rng(dim * 10 + degree)
        v[inner] += rng.uniform(-0.2, 0.2, (int(inner.sum()), dim)) / 3
        m.structured_shape = None
    return FESpace(m, degree)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


CASES = [(2, 1, "shell"), (2, 2, "shell"), (2, 2, "moved"), (3, 1, "moved"),
         (3, 2, "moved"), (3, 1, "shell")]


@pytest.mark.parametrize("lsic", [False, True], ids=["", "lsic"])
@pytest.mark.parametrize("dim,degree,geometry", CASES)
def test_staged_and_register_routes_match_plain_kernel(dim, degree,
                                                       geometry, lsic):
    space = _space(dim, degree, geometry)
    frozen = StabFlags(lsic=lsic, frozen_tau=True)
    op = GLSOperator(space, nu=NU, stab=frozen, device="cpu",
                     dtype=torch.float64)
    assert op.layout is None
    k = op.kernel
    rng = np.random.default_rng(3)
    N, c, E, nq = op.n_nodes, dim + 1, space.n_elements, op.n_q
    u, v = (torch.as_tensor(rng.standard_normal((N, c)) * s)
            for s in (0.3, 1.0))
    ue, due = op._soa(u), op._soa(v)
    up = op._soa(torch.as_tensor(rng.standard_normal((N, dim)) * 0.2))
    fq = op._fq_soa(torch.as_tensor(rng.standard_normal((E, nq, dim))))
    xe, h = op.xe_soa.double(), op.h.double()
    args = (xe, up, fq, h, A0, SDT)

    full = k.plain(StabFlags(lsic=lsic))
    want = {"primal": full(ue, *args),
            "tangent": tangent_batched(k.plain(frozen), ue, due, *args),
            "blocks": node_blocks_batched(k.plain(frozen), ue, *args)}
    splits = [1] if (dim, degree) not in gls_kernel.REGISTER_SHAPES else \
        list(gls_kernel.REG_SPLITS[dim])
    routes = [("staged", _staged)] + [
        (f"registers/{n}", lambda *a, n=n, **kw: _registers(*a, split=n, **kw))
        for n in splits]
    for name, route in routes:
        got = route(k, "primal", StabFlags(lsic=lsic), ue, xe, up, fq, h)
        assert _rel(got, want["primal"]) < RTOL, name
        got = route(k, "tangent", frozen, ue, xe, up, fq, h, due=due)
        assert _rel(got, want["tangent"]) < RTOL, name
        blocks = torch.empty_like(want["blocks"])
        for n0 in range(k.nn):
            for j0 in range(c):
                col = route(k, "probe", frozen, ue, xe, up, fq, h,
                            probe=(n0, j0))
                blocks[n0, j0::c] = col[n0]
        assert _rel(blocks, want["blocks"]) < RTOL, name


def test_symmetric_hessians_contract_like_full_ones():
    rng = np.random.default_rng(0)
    for d in (2, 3):
        H = rng.standard_normal((5, 7, d, d))
        K = rng.standard_normal((d, d))
        K = K + K.T
        Hs = gls_kernel.symmetric_hessians(H, d)
        Ks = np.array([K[a, b] for a, b in _pairs(d)])
        np.testing.assert_allclose(Hs @ Ks, np.einsum("qnab,ab->qn", H, K),
                                   rtol=1e-13)


# ----------------------------------------------------------------------
# host-side helpers
# ----------------------------------------------------------------------
def test_persistent_grid():
    assert pt.persistent_grid(0, 32, 4, 132) == 0
    assert pt.persistent_grid(9, 32, 4, 132) == 1          # below one tile
    assert pt.persistent_grid(12288, 32, 4, 132) == 384    # one tile a block
    assert pt.persistent_grid(262144, 32, 4, 132) == 528   # capped: 4 x 132
    assert pt.persistent_grid(195, 16, 1, 132) == 13       # ragged tail
    with pytest.raises(ValueError, match="does not fit"):
        pt.persistent_grid(100, 32, 0, 132)


def test_load_path():
    aligned = [0x7f0000000000, 0x7f0000000100]
    assert pt.load_path(12288, aligned) == pt.LOAD_TMA
    assert pt.load_path(12, aligned) == pt.LOAD_TMA
    # a row pitch that is not a multiple of 16 bytes (E % 4 != 0)
    for E in (195, 210, 9):
        assert pt.load_path(E, aligned) == pt.LOAD_CP_ASYNC_4
    # a tensor that starts mid-row (a view with an offset)
    assert pt.load_path(12288, aligned + [0x7f0000000104]) == \
        pt.LOAD_CP_ASYNC_4


def test_route_and_split_choice():
    STAGED, REGISTERS = pt.STAGED, pt.REGISTERS
    assert pt.choose_route("auto", True, 12288, 64, 132) == REGISTERS
    assert pt.choose_route("auto", True, 768, 64, 132) == STAGED
    assert pt.choose_route("auto", False, 10 ** 6, 64, 132) == STAGED
    assert pt.choose_route("registers", False, 10 ** 6, 64, 132) == STAGED
    assert pt.choose_route("registers", True, 9, 64, 132) == REGISTERS
    assert pt.choose_route("staged", True, 10 ** 6, 64, 132) == STAGED
    with pytest.raises(ValueError, match="unknown route"):
        pt.choose_route("fast", True, 1, 1, 1)
    # threads per element: the largest split that fits the card at once
    cands = [(1, 5), (2, 5), (4, 4)]            # (split, blocks per SM)
    assert pt.split_for(12288, cands, 132, 64) == 2     # 4 x 12288 > 33792
    assert pt.split_for(4096, cands, 132, 64) == 4
    assert pt.split_for(262144, cands, 132, 64) == 1
    assert pt.split_for(262144, [(1, 4)], 132, 64) == 1
    # the wrappers' rules on the card's 132 SMs
    assert gls_kernel.route_for(2, 2, 12288, 132) == REGISTERS
    assert gls_kernel.route_for(3, 2, 10 ** 6, 132) == STAGED
    assert gls_kernel.route_for(2, 2, 768, 132, "registers") == REGISTERS
    assert gls_kernel.route_for(2, 2, 12288, 132, "staged") == STAGED
    assert lattice_kernel.route_for(3, 1, 2, 32768, 132, True) == REGISTERS
    assert lattice_kernel.route_for(3, 1, 2, 4096, 132, True) == STAGED
    assert lattice_kernel.route_for(2, 2, 3, 10 ** 6, 132, True) == STAGED
    # a lattice whose basis Laplacians do not vanish stays STAGED
    assert lattice_kernel.route_for(3, 1, 2, 32768, 132, False) == STAGED


def _lattice_kernel(dim, degree, shear):
    """B2's wrapper on a lattice of translates of a box (``shear`` 0) or a
    sheared box."""
    from softx_2020_200_tpu_torch.fem.basis import TensorBasis
    basis = TensorBasis(dim, degree)
    _, w, B, G, H = basis.quadrature(degree + 1)
    A = np.diag([0.5, 0.25, 0.75][:dim])
    A[0, 1] = shear
    return lattice_kernel.LatticeGLSKernel(
        dim=dim, degree=degree, B=B, G=G, H=H, w=w, xe0=basis.nodes @ A.T,
        nu=NU, stab=StabFlags(), dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("dim", [2, 3])
def test_lattice_laplacian_rows_vanish_only_for_q1_boxes(dim):
    """B2's REGISTERS route leaves out the Laplacian rows of T_all: zero
    for Q1 on a box lattice (the route's shapes), not for Q2 or for Q1 on
    a sheared lattice of translates."""

    def kernel(degree, shear):
        return _lattice_kernel(dim, degree, shear)

    assert kernel(1, 0.0).laplacian_free
    assert not kernel(1, 0.2).laplacian_free
    assert not kernel(2, 0.0).laplacian_free


@pytest.mark.parametrize("dim", [2, 3])
def test_lattice_launch_plan_follows_each_kernels_tables(dim, monkeypatch):
    """The launch plan of B2 is per kernel: a sheared lattice planned
    after a box lattice of the same shape and E stays STAGED, where the
    box takes REGISTERS (a plan shared between them would hand the
    sheared lattice a route without its Laplacian terms)."""
    monkeypatch.setattr(pt, "sm_count", lambda device: 132)
    monkeypatch.setattr(lattice_kernel, "config_on_card",
                        lambda *variant: (4, 0, 128))
    E = 128 * 132 + 512                      # REGISTERS for a box lattice
    device = torch.device("cuda", 0)
    box, sheared = _lattice_kernel(dim, 1, 0.0), _lattice_kernel(dim, 1, 0.2)
    for mode in range(3):
        assert box._plan(mode, 2, E, device, "auto")[0] == pt.REGISTERS
        assert sheared._plan(mode, 2, E, device, "auto")[0] == pt.STAGED
        assert sheared._plan(mode, 2, E, device, "registers")[0] == \
            pt.STAGED


def _b1_variants():
    for dim, degree in sorted(gls_kernel.SUPPORTED):
        for mode in range(3):
            yield (dim, degree, mode, pt.STAGED, 1)
            if (dim, degree) in gls_kernel.REGISTER_SHAPES:
                for split in gls_kernel.REG_SPLITS[dim]:
                    yield (dim, degree, mode, pt.REGISTERS, split)


def _b2_variants():
    for shape in sorted(lattice_kernel.SUPPORTED):
        for mode in range(3):
            yield (*shape, mode, pt.STAGED)
            if shape in lattice_kernel.REGISTER_SHAPES:
                yield (*shape, mode, pt.REGISTERS)


def test_shared_memory_budget_and_tma_boxes():
    """Every variant of both kernels fits one block's 227 KB of shared
    memory with its two ring stages counted, launches at most 1,024
    threads, and loads boxes TMA can take: at most 256 rows and elements,
    the element extent a multiple of 4 floats (16 bytes)."""
    configs = ([gls_kernel.tile_config(*v) for v in _b1_variants()]
               + [lattice_kernel.tile_config(*v) for v in _b2_variants()])
    assert len(configs) == 33 + 24
    for cfg in configs:
        assert 0 <= cfg["smem_bytes"] <= pt.SMEM_LIMIT
        assert cfg["threads"] <= 1024
        assert cfg["be"] % 4 == 0 and cfg["be"] <= pt.TMA_BOX_MAX
        assert max(cfg["rows"]) <= pt.TMA_BOX_MAX


def test_tile_config_mirrors_the_kernel_layout():
    """Spot values of the Python mirror of the kernels' shared-memory
    layout (the card holds the mirror equal to the compiled kernels in
    chip_smoke.py phase 2)."""
    # B1 3D Q2 tangent: tables 27*27*(1+3+6)+27 = 7317 floats (7328
    # padded), two stages of 460 rows x 16 elements each padded to 32
    # floats, 27 points x 25 coefficients x 16 elements
    cfg = gls_kernel.tile_config(3, 2, 1)
    stage = sum(pt.pad32(r * 16) for r in (108, 108, 81, 81, 81, 1))
    assert cfg["be"] == 16 and cfg["threads"] == 432
    assert cfg["smem_bytes"] == 4 * (7328 + 2 * stage + 27 * 25 * 16)
    # B1 2D Q2, the Taylor-Couette shape: 32 elements, 288 threads
    cfg = gls_kernel.tile_config(2, 2, 1)
    assert (cfg["be"], cfg["threads"]) == (32, 288)
    assert gls_kernel.tile_config(2, 2, 1, pt.REGISTERS, 2)["be"] == 32
    # B2 3D Q1: tables 2 x 40 x 8, 32 elements, 256 threads
    cfg = lattice_kernel.tile_config(3, 1, 2, 0)
    stage = sum(pt.pad32(r * 32) for r in (32, 0, 24, 24))
    assert cfg["smem_bytes"] == 4 * (640 + 2 * stage + (3 * 40 + 32) * 32)
    assert lattice_kernel.tile_config(3, 1, 2, 1, pt.REGISTERS)[
        "smem_bytes"] == 0


@pytest.mark.parametrize("dim", [2, 3])
def test_staged_route_with_three_points_matches_plain_kernel(dim):
    """Q1 with 3 Gauss points per axis (the forest multigrid's levels
    below a Q2 mesh's Q1 p-level), which B1 compiles on its STAGED route
    only: phase A over nq = 3^d points, phase B over nn = 2^d nodes."""
    space = _space(dim, 1, "moved")
    frozen = StabFlags(frozen_tau=True)
    op = GLSOperator(space, nu=NU, n_q1d=3, stab=frozen, device="cpu",
                     dtype=torch.float64)
    k = op.kernel
    assert (k.nq, k.nn, k.q1d) == (3 ** dim, 2 ** dim, 3)
    rng = np.random.default_rng(5)
    N, c, E = op.n_nodes, dim + 1, space.n_elements
    ue = op._soa(torch.as_tensor(rng.standard_normal((N, c)) * 0.3))
    due = op._soa(torch.as_tensor(rng.standard_normal((N, c))))
    up = op._soa(torch.as_tensor(rng.standard_normal((N, dim)) * 0.2))
    fq = op._fq_soa(torch.as_tensor(rng.standard_normal((E, k.nq, dim))))
    xe, h = op.xe_soa.double(), op.h.double()
    args = (xe, up, fq, h, A0, SDT)
    got = _staged(k, "primal", StabFlags(), ue, xe, up, fq, h)
    assert _rel(got, k.plain(StabFlags())(ue, *args)) < RTOL
    got = _staged(k, "tangent", frozen, ue, xe, up, fq, h, due=due)
    assert _rel(got, tangent_batched(k.plain(frozen), ue, due, *args)) < RTOL


def test_three_point_rule_launch_plan_and_tiles(monkeypatch):
    """The three-point Q1 variants fit one block (288 threads in 2D, 432
    in 3D, one per point) and always take the STAGED route, even when
    REGISTERS is asked for; a rule that is not compiled is refused."""
    for dim, threads in ((2, 288), (3, 432)):
        for mode in range(3):
            cfg = gls_kernel.tile_config(dim, 1, mode, points=3)
            assert cfg["threads"] == threads
            assert 0 < cfg["smem_bytes"] <= pt.SMEM_LIMIT
            assert cfg["rows"][4] == 3 ** dim * dim
    monkeypatch.setattr(pt, "sm_count", lambda device: 132)
    monkeypatch.setattr(gls_kernel, "config_on_card",
                        lambda *a, **kw: (2, 0, 288))
    device = torch.device("cuda", 0)
    space = _space(2, 1, "moved")
    k = GLSOperator(space, nu=NU, n_q1d=3, device="cpu",
                    dtype=torch.float64).kernel
    for route in ("auto", "registers"):
        assert k._plan(1, 10 ** 6, device, route, None)[0] == pt.STAGED
    k4 = GLSOperator(space, nu=NU, n_q1d=4, device="cpu",
                     dtype=torch.float64).kernel
    with pytest.raises(ValueError, match="no variant"):
        k4._plan(1, 100, device, "auto", None)
