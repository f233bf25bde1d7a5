"""What a traced run reads: the shapes of the GLS operator's kernel
calls, taken at the operator's entry, and a summary of the profiler's
trace of the window, reduced in memory (no trace file is written).

``OperatorCalls`` counts the calls of ``GLSOperator.residual_free``,
``jvp`` and ``node_blocks`` (every multigrid level is a GLSOperator) by
(dim, degree, points per axis, elements, lattice, variant): the work the
kernels are asked for, whatever kernel a later version runs it in.

``summarize`` gives the device's kernels by name (calls, seconds), the
union of the device's busy intervals, the longest idle gaps with what
the host was doing in each (the innermost host operation around the
gap's middle), and the number of kernels."""

from __future__ import annotations

import bisect
from collections import Counter
from dataclasses import dataclass, field

import numpy as np

_VARIANTS = {"residual_free": "primal", "jvp": "tangent",
             "node_blocks": "probe"}


class OperatorCalls:
    """Context manager: while open, count the GLS operator's kernel
    calls by shape in ``self.calls``."""

    def __init__(self):
        self.calls: Counter = Counter()
        self._saved = {}

    def __enter__(self):
        from softx_2020_200_tpu_torch.solvers.gls import GLSOperator
        self._cls = GLSOperator
        for meth, variant in _VARIANTS.items():
            orig = getattr(GLSOperator, meth)
            self._saved[meth] = orig
            setattr(GLSOperator, meth, self._wrap(orig, variant))
        return self

    def _wrap(self, orig, variant):
        calls = self.calls

        def counted(op, *args, **kwargs):
            calls[shape_key(op, variant)] += 1
            return orig(op, *args, **kwargs)

        return counted

    def __exit__(self, *exc):
        for meth, orig in self._saved.items():
            setattr(self._cls, meth, orig)
        return False


def shape_key(op, variant: str) -> tuple:
    """(dim, degree, points per axis, E, lattice, variant) of a call;
    the variant takes " bf16" for a bf16 Jacobian state (tangent and
    probes) and " bf16op" for a bf16 operator."""
    import torch
    q1d = int(round(op.n_q ** (1.0 / op.dim)))
    if op.dtype == torch.bfloat16:
        variant += " bf16op"
    elif op.state_dtype is not None and variant != "primal":
        variant += " bf16"
    return (op.dim, op.degree, q1d, op.space.n_elements,
            op.layout is not None, variant)


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float = 0.0
    n_kernels: int = 0
    kernels: dict = field(default_factory=dict)   # name -> [calls, s]
    idle_gaps: list = field(default_factory=list)  # [[host op, s]]
    calls: Counter = field(default_factory=Counter)

    def device_s(self, patterns=None) -> float:
        """Seconds of the kernels whose names hold one of ``patterns``
        (all kernels without)."""
        return sum(s for name, (_, s) in self.kernels.items()
                   if patterns is None or any(p in name for p in patterns))

    def top_kernels(self, n: int = 10) -> list:
        rows = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:n]
        return [[name[:160], s] for name, (_, s) in rows]


def _union(iv: np.ndarray) -> np.ndarray:
    """Union of intervals [n, 2] (sorted by start) as disjoint rows."""
    out = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out, float).reshape(-1, 2)


def summarize(prof, window_s: float, n_gaps: int = 10) -> TraceSummary:
    """The summary of a finished ``torch.profiler.profile``, read from
    its raw events (the profiler's own event tree takes minutes to build
    for a few hundred thousand kernels)."""
    from torch.autograd import DeviceType
    out = TraceSummary(window_s=window_s)
    dev, host, names = [], [], []
    for ev in prof.profiler.kineto_results.events():
        start, dur = ev.start_ns(), ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            dev.append((start, start + dur))
            row = out.kernels.setdefault(ev.name(), [0, 0.0])
            row[0] += 1
            row[1] += dur * 1e-9
            out.n_kernels += 1
        elif dur > 0:
            host.append((start, start + dur))
            names.append(ev.name())
    if not dev:
        return out
    # nanosecond clocks near 2^60 lose digits in float64: from the first
    # event on
    dev = np.asarray(sorted(dev), np.int64)
    hs = np.asarray(host, np.int64).reshape(-1, 2)
    base = min(dev[0, 0], hs[:, 0].min() if len(hs) else dev[0, 0])
    busy = _union((dev - base).astype(float))
    out.busy_s = float((busy[:, 1] - busy[:, 0]).sum()) * 1e-9
    gaps = np.column_stack([busy[:-1, 1], busy[1:, 0]])
    longest = np.argsort(gaps[:, 0] - gaps[:, 1])[:max(n_gaps * 20, 1)]
    hs = (hs - base).astype(float)
    order = np.argsort(hs[:, 0])
    hs, names = hs[order], [names[i] for i in order]
    starts = hs[:, 0].tolist()
    by_op: Counter = Counter()
    for g in longest:
        s, e = gaps[g]
        mid = 0.5 * (s + e)
        k = bisect.bisect_right(starts, mid)
        cover = np.nonzero(hs[:k, 1] >= mid)[0]
        label = "host: Python between operations"
        if len(cover):
            inner = cover[np.argmin(hs[cover, 1] - hs[cover, 0])]
            label = "host: " + names[inner][:120]
        by_op[label] += (e - s) * 1e-9
    out.idle_gaps = [[k, v] for k, v in by_op.most_common(n_gaps)]
    return out
