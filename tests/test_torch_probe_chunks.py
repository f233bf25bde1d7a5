"""The plain node blocks of B1 and B2 (``ops/batched_kernel.py::
node_blocks_batched``, ``ops/lattice_kernel.py::lattice_node_blocks``),
vectorised over the nn*c one-hot probes with ``torch.func.vmap``, held
to one forward-mode probe at a time, in float64: whole, and in chunks
of probes that do not divide nn*c (``probe_chunks``).  Tolerance: 1e-13
of the max-abs scale (the same jvp, batched)."""

import numpy as np
import pytest
import torch

from softx_2020_200_tpu_torch.fem import mesh as port_mesh
from softx_2020_200_tpu_torch.fem.dof import FESpace
from softx_2020_200_tpu_torch.ops import batched_kernel as bk
from softx_2020_200_tpu_torch.ops import lattice_kernel as lk
from softx_2020_200_tpu_torch.solvers.gls import GLSOperator, StabFlags

torch.set_num_threads(1)

RTOL = 1e-13
FROZEN = StabFlags(lsic=True, frozen_tau=True)
A0, SDT = 1.5, 20.0


def _operator(dim, degree, moved):
    cells = [3] * dim
    m = port_mesh.subdivided_hyper_rectangle([0.0] * dim, [1.0] * dim,
                                             cells, True, dim=dim)
    if moved:
        v = m.vertices
        inner = np.all((v > 1e-9) & (v < 1 - 1e-9), axis=1)
        rng = np.random.default_rng(dim * 10 + degree)
        v[inner] += rng.uniform(-0.2, 0.2, (int(inner.sum()), dim)) / 3
        m.structured_shape = None
    op = GLSOperator(FESpace(m, degree), nu=0.05, stab=FROZEN, device="cpu",
                     dtype=torch.float64)
    assert (op.layout is None) == moved
    rng = np.random.default_rng(7)
    u = torch.as_tensor(rng.standard_normal((op.n_nodes, dim + 1)) * 0.3)
    prev = torch.as_tensor(rng.standard_normal((op.n_nodes, dim)) * 0.2)
    fq = torch.as_tensor(rng.standard_normal((op.space.n_elements, op.n_q,
                                              dim)))
    return op, u, prev, fq


def _one_probe_at_a_time(tangent, ue, nn, c, row):
    """blocks[n, i*c+j] from one jvp per (node n, component j); ``row``
    maps (n, j) to the state row and the column's rows to [c(i), E]."""
    out = ue.new_empty((nn, c * c, ue.shape[-1]))
    for n0 in range(nn):
        for j in range(c):
            probe = torch.zeros_like(ue)
            probe[row(n0, j)] = 1.0
            out[n0, j::c] = row(n0, None, tangent(probe))
    return out


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunks"])
@pytest.mark.parametrize("layout", ["element", "lattice"])
@pytest.mark.parametrize("dim,degree", [(2, 1), (2, 2), (3, 1), (3, 2)])
def test_vectorised_node_blocks_match_one_probe_at_a_time(
        dim, degree, layout, chunked, monkeypatch):
    op, u, prev, fq = _operator(dim, degree, moved=layout == "element")
    k, nn, c, E = op.kernel, op.nn, dim + 1, op.space.n_elements
    if chunked:       # 5 probes a pass: the last chunk is a partial one
        monkeypatch.setattr(bk, "PROBE_ELEMENTS", 5 * E)
        assert (nn * c) % 5 != 0
    frozen = k.plain(FROZEN)
    if layout == "element":
        ue = op._soa(u)
        args = (op.xe_soa, op._soa(prev), op._fq_soa(fq), op.h, A0, SDT)
        got = bk.node_blocks_batched(frozen, ue, *args)
        want = _one_probe_at_a_time(
            lambda p: bk.tangent_batched(frozen, ue, p, *args), ue, nn, c,
            lambda n, j, col=None: (n, j) if col is None else col[n])
    else:
        ue = op._rows(u)
        args = (op._rows(prev), op._fq_rows(fq), A0, SDT)
        got = lk.lattice_node_blocks(frozen, ue, *args, nn)
        want = _one_probe_at_a_time(
            lambda p: lk.lattice_tangent(frozen, ue, p, *args), ue, nn, c,
            lambda n, j, col=None: j * nn + n if col is None
            else col[n::nn])
    assert got.shape == (nn, c * c, E)
    assert _rel(got, want) < RTOL


@pytest.mark.parametrize("n_probes,E,budget,want", [
    (27, 100, 1 << 16, [27]),          # every probe in one pass
    (108, 1000, 1 << 16, [65] + [43]),
    (32, 262144, 1 << 16, [1] * 32),   # at least one probe a pass
    (12, 10, 50, [5, 5, 2]),
])
def test_probe_chunks_cover_every_probe_once(n_probes, E, budget, want,
                                             monkeypatch):
    monkeypatch.setattr(bk, "PROBE_ELEMENTS", budget)
    chunks = list(bk.probe_chunks(n_probes, E, "cpu"))
    assert [len(k) for k in chunks] == want
    assert torch.equal(torch.cat(chunks), torch.arange(n_probes))
