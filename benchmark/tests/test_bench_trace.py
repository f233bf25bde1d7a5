"""The trace summary on synthetic profiler events: kernels by name, the
union of the device's busy intervals, the idle gaps by host operation,
and the operator-entry call counts."""

from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from benchmark import trace

T0 = 1_792_322_275_057_498_078       # a profiler clock near 2^60 ns


def _ev(name, start, dur, device):
    return SimpleNamespace(name=lambda: name, start_ns=lambda: T0 + start,
                           duration_ns=lambda: dur,
                           device_type=lambda: device)


def _prof(events):
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def test_busy_union_kernels_and_gaps():
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    events = [
        _ev("gls_lattice_reg_kernel", 0, 1000, cuda),
        _ev("vectorized_gather_kernel", 500, 1000, cuda),   # overlaps
        _ev("gls_lattice_reg_kernel", 5000, 1000, cuda),
        _ev("aten::index", 1600, 3000, cpu),                 # covers gap
        _ev("aten::copy_", 2000, 100, cpu),                  # not mid-gap
        _ev("vectorized_gather_kernel", 9000, 1, cuda),
    ]
    s = trace.summarize(_prof(events), window_s=1e-5)
    assert s.n_kernels == 4
    assert s.busy_s == pytest.approx((1500 + 1000 + 1) * 1e-9)
    assert s.kernels["gls_lattice_reg_kernel"] == [2, pytest.approx(2e-6)]
    assert s.device_s(("gather",)) == pytest.approx(1001e-9)
    labels = dict(s.idle_gaps)
    assert labels["host: aten::index"] == pytest.approx(3500e-9)
    assert labels["host: Python between operations"] == pytest.approx(3e-6)
    assert s.top_kernels(1) == [["gls_lattice_reg_kernel",
                                 pytest.approx(2e-6)]]


def test_operator_calls_are_counted_by_shape():
    from softx_2020_200_tpu_torch.fem.dof import FESpace
    from softx_2020_200_tpu_torch.fem.mesh import generate_mesh
    from softx_2020_200_tpu_torch.solvers.gls import GLSOperator
    mesh = generate_mesh("subdivided_hyper_rectangle",
                         "4, 4 : 0, 0 : 1, 1 : true", dim=2)
    op = GLSOperator(FESpace(mesh, 1), 0.01, device="cpu",
                     dtype=torch.float64)
    u = torch.zeros((op.n_nodes, 3), dtype=torch.float64)
    with trace.OperatorCalls() as calls:
        op.residual_free(u, u[:, :2], torch.zeros_like(op.qpts_phys),
                         1.0, 1.0)
        op.residual_free(u, u[:, :2], torch.zeros_like(op.qpts_phys),
                         1.0, 1.0)
    assert calls.calls == {(2, 1, 2, 16, op.layout is not None,
                            "primal"): 2}
    assert GLSOperator.residual_free.__name__ == "residual_free"
