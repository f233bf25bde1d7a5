"""The sum-factorized decomposition of the Hopper GD lattice kernel (B3,
``csrc/gd_lattice.cu``), transcribed in float64 PyTorch and held against
the port's plain kernel (``ops/lattice_gd_kernel.py::make_lattice_gd_kernel``),
and the host side of its launch (``tile_config``, ``route_for``).

The CUDA kernel cannot run here, so its arithmetic is checked in the
order it does it, with its own row indices:

- the 1D tables (``gd_1d_tables``: Q2 and Q1 values and Q2 derivatives at
  the 3 Gauss points, the weighted copies with det J * w on axis 0) and
  J^-1 reproduce the dense ``gd_affine_tables`` by tensor products, on a
  box and on a sheared lattice of translates;
- the STAGED route: per pencil, the passes over axis 0 (and axis 1 in 3D)
  into the scratch rows S0 and S1, the last pass into registers at the 3
  points of the pencil, the physics, the transposed passes back through
  S0/S1 to the nodes;
- the REGISTERS route (2D): per element, per q0 the axis-0 pass, per q1
  the axis-1 pass, the physics and the transposed axis-1 pass, then the
  transposed axis-0 pass.

Each is held against the plain kernel: the primal residual and the
exact tangent (by forward-mode AD through the plain kernel), 2D and 3D,
bounded and periodic lattices with E not a multiple of the 32-element
tile, and a sheared element (a full J^-1).  Tolerance: 1e-12 of the
max-abs scale (float64, a different summation order).
"""

import numpy as np
import pytest
import torch

from softx_2020_200_tpu_torch.fem import mesh as port_mesh
from softx_2020_200_tpu_torch.fem.basis import TensorBasis
from softx_2020_200_tpu_torch.ops import lattice_gd_kernel as gk
from softx_2020_200_tpu_torch.ops import persistent_tiles as pt
from softx_2020_200_tpu_torch.solvers.gd import GDOperator

torch.set_num_threads(1)

RTOL = 1e-12
NU, GAMMA, A0 = 0.03, 0.8, 1.7


# ----------------------------------------------------------------------
# the transcription
# ----------------------------------------------------------------------
class Rows:
    """A window of scratch rows (each an [E] tensor) at ``off``: the
    CUDA ``Rows``/``CRows`` of one element column."""

    def __init__(self, buf, off=0):
        self.buf, self.off = buf, off

    def __getitem__(self, r):
        return self.buf[self.off + r]

    def __setitem__(self, r, v):
        self.buf[self.off + r] = v


def dot1(M, o, x):
    return sum(M[o][k] * x[k] for k in range(len(x)))


def tdot1(M, n, x):
    return sum(M[q][n] * x[q] for q in range(3))


def physics(T, mode, d, p):
    """``physics`` of gd_lattice.cu at one point ``p`` (a dict of the
    point's inputs) -> (a_v [d], b [d][d], a_p)."""
    J = T["Jinv"]

    def phys(gr):
        return [[sum(gr[i][a] * J[a][j] for a in range(d)) for j in range(d)]
                for i in range(d)]

    g = phys(p["gr"])
    if mode == "primal":
        div = sum(g[i][i] for i in range(d))
        gd_p = GAMMA * div - p["pr"]
        a_v = [A0 * p["vel"][i] + p["x"][i]
               + sum(g[i][j] * p["vel"][j] for j in range(d)) - p["f"][i]
               for i in range(d)]
        a_g = [[NU * g[i][j] + (gd_p if i == j else 0.0) for j in range(d)]
               for i in range(d)]
        a_p = div
    else:
        dg = phys(p["xgr"])
        ddiv = sum(dg[i][i] for i in range(d))
        gd_p = GAMMA * ddiv - p["pr"]
        a_v = [A0 * p["x"][i]
               + sum(dg[i][j] * p["vel"][j] + g[i][j] * p["x"][j]
                     for j in range(d)) for i in range(d)]
        a_g = [[NU * dg[i][j] + (gd_p if i == j else 0.0) for j in range(d)]
               for i in range(d)]
        a_p = ddiv
    b = [[sum(J[a][j] * a_g[i][j] for j in range(d)) for a in range(d)]
         for i in range(d)]
    return a_v, b, a_p


def pass0(T, d, grad, pres, u, s, sp, pc):
    NNV, NNP = 3 ** d, 2 ** d
    CS = 2 * NNV if grad else NNV
    for c in range(d):
        x = [u[c * NNV + 3 * pc + k] for k in range(3)]
        for q in range(3):
            s[c * CS + 3 * pc + q] = dot1(T["V"], q, x)
            if grad:
                s[c * CS + NNV + 3 * pc + q] = dot1(T["D"], q, x)
    if pres and pc < NNP // 2:
        y = [u[d * NNV + 2 * pc + m] for m in range(2)]
        for q in range(3):
            sp[3 * pc + q] = dot1(T["Vp"], q, y)


def pass1(T, grad, pres, s, sp, o, op, pc):
    CI, CO = (54, 81) if grad else (27, 27)
    q0, hi = pc % 3, pc // 3
    ib = q0 + 9 * hi
    for c in range(3):
        a = [s[c * CI + ib + 3 * j] for j in range(3)]
        for q in range(3):
            o[c * CO + ib + 3 * q] = dot1(T["V"], q, a)
            if grad:
                o[c * CO + 27 + ib + 3 * q] = dot1(T["D"], q, a)
        if grad:
            bb = [s[c * CI + 27 + ib + 3 * j] for j in range(3)]
            for q in range(3):
                o[c * CO + 54 + ib + 3 * q] = dot1(T["V"], q, bb)
    if pres and pc < 6:
        y = [sp[q0 + 3 * j + 6 * hi] for j in range(2)]
        for q in range(3):
            op[q0 + 3 * q + 9 * hi] = dot1(T["Vp"], q, y)


def last_pass(T, d, group, grad, pres, s, sp, pc, pts):
    NNV, LS = 3 ** d, (3 if d == 2 else 9)
    NF = d if grad else 1
    CS = NF * NNV
    for c in range(d):
        r = [[s[c * CS + f * NNV + pc + LS * k] for k in range(3)]
             for f in range(NF)]
        for t in range(3):
            val = dot1(T["V"], t, r[0])
            g = [None] * d
            if grad:
                g[d - 1] = dot1(T["D"], t, r[0])
                for f in range(1, NF):
                    g[d - 1 - f] = dot1(T["V"], t, r[f])
            if group == 1:
                pts[t]["vel"][c] = val
                pts[t]["gr"][c] = g
            else:
                pts[t]["x"][c] = val
                if grad:
                    pts[t]["xgr"][c] = g
    if pres:
        y = [sp[pc + LS * j] for j in range(2)]
        for t in range(3):
            pts[t]["pr"] = dot1(T["Vp"], t, y)


def staged(T, mode, d, ue, x, fq):
    """The STAGED route of gd_lattice.cu on every element at once (one
    column of each scratch row per element)."""
    NNV, NNP, LS = 3 ** d, 2 ** d, (3 if d == 2 else 9)
    tan = mode == "tangent"
    S0 = [None] * (78 if d == 2 else 261)
    S1 = [None] * (42 if d == 2 else 261)
    out = [None] * (d * NNV + NNP)
    u_rows, x_rows = Rows(list(ue)), Rows(list(x))
    pencils = range(NNV // 3)
    pts = {pc: [dict(vel=[0] * d, gr=[0] * d, x=[0] * d, xgr=[0] * d,
                     pr=0, f=[0] * d) for _ in range(3)] for pc in pencils}
    if d == 2:
        for pc in pencils:
            pass0(T, 2, True, not tan, u_rows, Rows(S0), Rows(S0, 72), pc)
            pass0(T, 2, tan, tan, x_rows, Rows(S0, 36), Rows(S0, 72), pc)
        for pc in pencils:          # after __syncthreads
            last_pass(T, 2, 1, True, not tan, Rows(S0), Rows(S0, 72), pc,
                      pts[pc])
            last_pass(T, 2, 2, tan, tan, Rows(S0, 36), Rows(S0, 72), pc,
                      pts[pc])
    else:
        for group, rows, grad, pres in ((1, u_rows, True, not tan),
                                        (2, x_rows, tan, tan)):
            for pc in pencils:
                pass0(T, 3, grad, pres, rows, Rows(S0), Rows(S0, 162), pc)
            for pc in pencils:
                pass1(T, grad, pres, Rows(S0), Rows(S0, 162), Rows(S1),
                      Rows(S1, 243), pc)
            for pc in pencils:
                last_pass(T, 3, group, grad, pres, Rows(S1), Rows(S1, 243),
                          pc, pts[pc])
    # physics and the transposed pass over axis d-1, stored into S1 (2D)
    # or S0 (3D)
    o = Rows(S1 if d == 2 else S0)
    for pc in pencils:
        acc = [[[0.0] * 3 for _ in range(d)] for _ in range(d)]
        accp = [0.0, 0.0]
        for q in range(3):
            p = pts[pc][q]
            if not tan:
                p["f"] = [fq[i * NNV + pc + LS * q] for i in range(d)]
            a_v, b, a_p = physics(T, mode, d, p)
            for c in range(d):
                for n in range(3):
                    acc[c][0][n] = acc[c][0][n] + T["VW"][q][n] * a_v[c] \
                        + T["DW"][q][n] * b[c][d - 1]
                    for f in range(1, d):
                        acc[c][f][n] = acc[c][f][n] \
                            + T["VW"][q][n] * b[c][d - 1 - f]
            for m in range(2):
                accp[m] = accp[m] + T["VpW"][q][m] * a_p
        for c in range(d):
            for f in range(d):
                for n in range(3):
                    o[c * d * NNV + f * NNV + pc + LS * n] = acc[c][f][n]
        for m in range(2):
            o[d * d * NNV + pc + LS * m] = accp[m]
    if d == 3:
        x_, o = Rows(S0), Rows(S1)
        for pc in pencils:
            q0, hi = pc % 3, pc // 3
            ib = q0 + 9 * hi
            for c in range(3):
                X = [x_[c * 81 + ib + 3 * k] for k in range(3)]
                Y1 = [x_[c * 81 + 27 + ib + 3 * k] for k in range(3)]
                Y0 = [x_[c * 81 + 54 + ib + 3 * k] for k in range(3)]
                for n in range(3):
                    o[c * 54 + ib + 3 * n] = tdot1(T["VW"], n, X) + \
                        tdot1(T["DW"], n, Y1)
                    o[c * 54 + 27 + ib + 3 * n] = tdot1(T["VW"], n, Y0)
            if pc < 6:
                y = [x_[243 + q0 + 3 * k + 9 * hi] for k in range(3)]
                for m in range(2):
                    o[162 + q0 + 3 * m + 6 * hi] = tdot1(T["VpW"], m, y)
    x_ = Rows(S1)
    for pc in pencils:
        for c in range(d):
            z = [x_[c * 2 * NNV + 3 * pc + q] for q in range(3)]
            w = [x_[c * 2 * NNV + NNV + 3 * pc + q] for q in range(3)]
            for n in range(3):
                out[c * NNV + 3 * pc + n] = tdot1(T["VW0"], n, z) + \
                    tdot1(T["DW0"], n, w)
        if pc < NNP // 2:
            y = [x_[2 * d * NNV + 3 * pc + q] for q in range(3)]
            for m in range(2):
                out[d * NNV + 2 * pc + m] = tdot1(T["VpW0"], m, y)
    return torch.stack(out)


def registers(T, mode, ue, x, fq):
    """The REGISTERS route (2D) of gd_lattice.cu on every element at
    once."""
    d, NNV = 2, 9
    tan = mode == "tangent"
    out = [0.0] * 22
    for q0 in range(3):
        A, B, XA, XB = ([[None] * 3 for _ in range(d)] for _ in range(4))
        for c in range(d):
            for n1 in range(3):
                r = [c * NNV + n0 + 3 * n1 for n0 in range(3)]
                A[c][n1] = sum(T["V"][q0][n0] * ue[r[n0]] for n0 in range(3))
                B[c][n1] = sum(T["D"][q0][n0] * ue[r[n0]] for n0 in range(3))
                XA[c][n1] = sum(T["V"][q0][n0] * x[r[n0]] for n0 in range(3))
                XB[c][n1] = sum(T["D"][q0][n0] * x[r[n0]] for n0 in range(3))
        src = x if tan else ue
        P = [T["Vp"][q0][0] * src[18 + 2 * m1] + T["Vp"][q0][1]
             * src[19 + 2 * m1] for m1 in range(2)]
        X = [[0.0] * 3 for _ in range(d)]
        Y = [[0.0] * 3 for _ in range(d)]
        Pt = [0.0, 0.0]
        for q1 in range(3):
            p = dict(vel=[dot1(T["V"], q1, A[c]) for c in range(d)],
                     gr=[[dot1(T["V"], q1, B[c]), dot1(T["D"], q1, A[c])]
                         for c in range(d)],
                     x=[dot1(T["V"], q1, XA[c]) for c in range(d)],
                     xgr=[[dot1(T["V"], q1, XB[c]), dot1(T["D"], q1, XA[c])]
                          for c in range(d)],
                     pr=dot1(T["Vp"], q1, P))
            if not tan:
                p["f"] = [fq[c * NNV + q0 + 3 * q1] for c in range(d)]
            a_v, b, a_p = physics(T, mode, d, p)
            for c in range(d):
                for n in range(3):
                    X[c][n] = X[c][n] + T["VW"][q1][n] * a_v[c] \
                        + T["DW"][q1][n] * b[c][1]
                    Y[c][n] = Y[c][n] + T["VW"][q1][n] * b[c][0]
            for m in range(2):
                Pt[m] = Pt[m] + T["VpW"][q1][m] * a_p
        for c in range(d):
            for n1 in range(3):
                for n0 in range(3):
                    out[c * NNV + n0 + 3 * n1] = out[c * NNV + n0 + 3 * n1] \
                        + T["VW0"][q0][n0] * X[c][n1] \
                        + T["DW0"][q0][n0] * Y[c][n1]
        for m1 in range(2):
            for m0 in range(2):
                out[18 + m0 + 2 * m1] = out[18 + m0 + 2 * m1] \
                    + T["VpW0"][q0][m0] * Pt[m1]
    return torch.stack(out)


# ----------------------------------------------------------------------
# the cases
# ----------------------------------------------------------------------
def _box_mesh(dim, cells, periodic):
    m = port_mesh.subdivided_hyper_rectangle(
        [0.0] * dim, [1.0, 0.7, 1.3][:dim], list(cells), colorize=True,
        dim=dim)
    if periodic:
        m.periodic += [(2 * a, 2 * a + 1, a) for a in range(dim)]
    return m


def _sheared_kernel(dim):
    """B3's wrapper on a lattice of translates of a sheared element (a
    full J^-1), with its basis tables."""
    basis, pbasis = TensorBasis(dim, 2), TensorBasis(dim, 1)
    _, w, Bv, Gv, _ = basis.quadrature(3)
    _, _, Bp, _, _ = pbasis.quadrature(3)
    A = np.diag([0.5, 0.25, 0.75][:dim])
    A[0, 1], A[dim - 1, 0] = 0.2, -0.1
    return gk.LatticeGDKernel(dim=dim, degree_pressure=1, Bv=Bv, Gv=Gv,
                              Bp=Bp, w=w, xe0=basis.nodes @ A.T, nu=NU,
                              gamma=GAMMA, dtype=torch.float64,
                              device="cpu"), (Bv, Gv, Bp, w, basis.nodes @ A.T)


def _kernel_and_inputs(dim, geometry, seed=3):
    """(wrapper, ue, due, vpe, fq) in float64: on a box lattice through
    the GD operator's own row layouts, or on a sheared element with 37
    elements of random rows."""
    rng = np.random.default_rng(seed)
    if geometry == "sheared":
        k, _ = _sheared_kernel(dim)
        E = 37

        def rows(n, s):
            return torch.as_tensor(s * rng.standard_normal((n, E)))

        return (k, rows(k.rows, 0.3), rows(k.rows, 1.0),
                rows(dim * k.nnv, 0.2), rows(dim * k.nq, 0.1))
    cells = (7, 5) if dim == 2 else (3, 2, 2)
    op = GDOperator(_box_mesh(dim, cells, geometry == "periodic"), nu=NU,
                    gamma=GAMMA, dtype=torch.float64, device="cpu")
    assert op.layout_v is not None
    E = op.space_v.n_elements
    assert E % gk.STAGED_BE != 0

    def vec(*shape, s):
        return torch.as_tensor(s * rng.standard_normal(shape))

    return (op.kernel, op._rows(vec(op.n_dofs, s=0.3)),
            op._rows(vec(op.n_dofs, s=1.0)), op._vrows(vec(op.Nv, dim, s=0.2)),
            op._fq_rows(vec(E, op.n_q, dim, s=0.1)))


CASES = [(2, "staged", "bounded"), (2, "staged", "periodic"),
         (2, "staged", "sheared"), (2, "registers", "bounded"),
         (2, "registers", "periodic"), (2, "registers", "sheared"),
         (3, "staged", "bounded"), (3, "staged", "periodic"),
         (3, "staged", "sheared")]


@pytest.mark.parametrize("dim,route,geometry", CASES)
def test_route_arithmetic_matches_plain_kernel(dim, route, geometry):
    k, ue, due, vpe, fq = _kernel_and_inputs(dim, geometry)
    tab = gk.gd_1d_tables(dim, *k.geometry)
    T = {name: np.asarray(v).tolist() for name, v in tab.items()}
    plain = k.plain()
    want = {"primal": plain(ue, vpe, fq, A0),
            "tangent": torch.func.jvp(lambda v: plain(v, None, None, A0),
                                      (ue,), (due,))[1]}
    for mode, x in (("primal", vpe), ("tangent", due)):
        if route == "staged":
            got = staged(T, mode, dim, ue, x, fq)
        else:
            got = registers(T, mode, ue, x, fq)
        scale = want[mode].abs().max()
        err = (got - want[mode]).abs().max()
        assert err <= RTOL * scale, (mode, float(err / scale))


@pytest.mark.parametrize("geometry", ["box", "sheared"])
@pytest.mark.parametrize("dim", [2, 3])
def test_1d_tables_reproduce_dense_tables(dim, geometry):
    """Tensor products of the 1D tables with J^-1 (and det J * w folded
    into the weighted ones) are ``gd_affine_tables``' Tv, Pv, Tp, Pp."""
    if geometry == "box":
        m = _box_mesh(dim, (2,) * dim, False)
        op = GDOperator(m, nu=NU, gamma=GAMMA, dtype=torch.float64,
                        device="cpu")
        _, w, Bv, Gv, _ = op.space_v.basis.quadrature(3)
        _, _, Bp, _, _ = op.space_p.basis.quadrature(3)
        xe0 = op.layout_v.elem_coords_grid_order()[0]
    else:
        _, (Bv, Gv, Bp, w, xe0) = _sheared_kernel(dim)
    Jinv, detJ = gk.affine_geometry(xe0, Gv)
    if geometry == "sheared":
        assert np.abs(Jinv - np.diag(np.diag(Jinv))).max() > 0.1
    dense = gk.gd_affine_tables(dim, Bv, Gv, Bp, w, xe0)
    got = gk.dense_from_1d(dim, gk.gd_1d_tables(dim, Jinv, detJ))
    scale = max(np.abs(t).max() for t in dense)
    for a, b in zip(got, dense):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= RTOL * scale
    packed = gk.pack_1d_tables(gk.gd_1d_tables(dim, Jinv, detJ))
    assert packed.dtype == np.float32 and packed.size == gk.TABLE_FLOATS


def test_tile_config_budget_and_route_choice():
    """Every B3 variant fits one block's 227 KB with both ring stages and
    its scratch, at most 1,024 threads and TMA-sized boxes; the 3D
    tangent leaves room for two blocks per SM; REGISTERS only in 2D, from
    REG_MIN_PER_SM elements per SM on."""
    for dim in (2, 3):
        for mode in (0, 1):
            routes = [pt.STAGED] + ([pt.REGISTERS] if dim == 2 else [])
            for route in routes:
                cfg = gk.tile_config(dim, mode, route)
                assert 0 <= cfg["smem_bytes"] <= pt.SMEM_LIMIT
                assert cfg["threads"] <= 1024
                assert cfg["be"] % 4 == 0 and cfg["be"] <= pt.TMA_BOX_MAX
                assert max(cfg["rows"]) <= pt.TMA_BOX_MAX
    # 3D tangent: two stages of 89 + 89 rows x 32, scratch 2 x 261 rows
    cfg = gk.tile_config(3, 1)
    assert (cfg["be"], cfg["threads"]) == (32, 288)
    assert cfg["smem_bytes"] == 4 * (2 * 2 * pt.pad32(89 * 32) + 522 * 32)
    assert 2 * (cfg["smem_bytes"] + 1024) <= 228 * 1024
    assert gk.tile_config(2, 1)["threads"] == 96
    assert gk.tile_config(2, 0, pt.REGISTERS)["smem_bytes"] == 0
    n = gk.REG_MIN_PER_SM * 132
    assert gk.route_for(2, 65536, 132) == pt.REGISTERS
    assert gk.route_for(2, n, 132) == pt.REGISTERS
    assert gk.route_for(2, n - 1, 132) == pt.STAGED
    assert gk.route_for(3, 10 ** 6, 132) == pt.STAGED
    assert gk.route_for(3, 9, 132, "registers") == pt.STAGED
    assert gk.route_for(2, 9, 132, "registers") == pt.REGISTERS
    assert gk.route_for(2, 10 ** 6, 132, "staged") == pt.STAGED


@pytest.mark.parametrize("dim", [2, 3])
def test_launch_plan_per_kernel(dim, monkeypatch):
    """The plan follows E and the forced route, per kernel and variant,
    and the wrapper keeps the packed 1D tables only where they reproduce
    its dense ones."""
    monkeypatch.setattr(pt, "sm_count", lambda device: 132)
    monkeypatch.setattr(gk, "config_on_card", lambda *variant: (2, 0, 288))
    k, _ = _sheared_kernel(dim)
    assert k._host_tables is not None
    device = torch.device("cuda", 0)
    big, small = 65536, 12
    want_big = pt.REGISTERS if dim == 2 else pt.STAGED
    for mode in (0, 1):
        assert k._plan(mode, big, device, "auto")[0] == want_big
        assert k._plan(mode, small, device, "auto") == (pt.STAGED, 1)
        assert k._plan(mode, big, device, "staged")[0] == pt.STAGED
    assert k._plan(1, big, device, "staged")[1] == 264    # 2 x 132 blocks
