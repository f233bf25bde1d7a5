"""Program spans and counters, recorded only while a torch profiler
records (``torch.autograd.profiler._is_profiler_enabled``).

``span(name)`` marks a range of host work among the profiler's own host
events, on the clock of its device trace: every kernel then falls under
the span that launched it (through its launch's correlation id) and
every idle gap of the device under the span the host was in.  The
profiler's nesting on the thread gives each span its parent; the
``step`` span around each time step is the identifier that the spans
below it share.  Off, ``span`` returns one shared null context after
one check of the flag, and ``count`` returns after the same check.

A span is a ``torch._C._profiler._RecordFunctionFast`` range, a host op
of the profiler's FUNCTION scope.  ``torch.profiler.record_function``
is not used: its user scope makes the profiler add a
``gpu_user_annotation`` event on the device's timeline over the kernels
launched inside it, which a trace reader would take for device work.

A span never synchronises, reads no tensor's value, allocates nothing
on the device and keeps no tensor.

The counters (``COUNTERS``) are the V-cycles and their host seconds,
the host's seconds in device-to-host reads, the calls and bytes of
the index gathers and indexed writes by call site (``SITES``), which
``take`` and ``put`` make, each inside a span ``gather.<site>``, those
of a part of a site again on their own (``PARTS``), and
the multigrid preconditioner's builds with the states alive at each
(``track_state``).  The
counters are updated from the free functions of the Newton, Krylov and
multigrid layers, which know no solver, so they accumulate here,
process-wide like the profiler's own state, and ``fold`` moves them
into a solver's ``stats`` at the end of each nonlinear solve
(``solvers/base.py::record_solve``).

Besides, and always, the module tallies the multigrid preconditioner
states alive in the process (``live_states``): one per Newton
iteration's cycle, from its build until reference counting frees it.
"""

from __future__ import annotations

import time
import weakref
from contextlib import contextmanager, nullcontext

import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

from .timer import SectionTimer

# where an index gather runs: the multigrid transfers (``Level.down``,
# ``prolong``, ``restrict``), the GLS operator's element rows and
# assembly, the hanging-node constraints, the node-block and Schwarz
# preconditioners
SITES = ("transfer", "operator", "constraints", "smoother")
# parts of a site, counted besides it (their gathers stay in the site's
# count and span): the transfers between a lattice's finest level and
# its Q1 p-level (``ops/multigrid.py::build_hierarchy``)
PARTS = ("transfer_p",)

COUNTERS = {"vcycles": 0, "vcycle_s": 0.0, "sync_wait_s": 0.0,
            **{f"gather_{what}_{site}": 0 for site in SITES + PARTS
               for what in ("bytes", "calls")},
            "gmg_builds": 0, "gmg_states_live": 0}

_counts = dict(COUNTERS)
_GATHER_KEYS = {site: (f"gather_bytes_{site}", f"gather_calls_{site}")
                for site in SITES + PARTS}
_GATHER_SPANS = {site: f"gather.{site}" for site in SITES}
_NULL = nullcontext()
# the multigrid preconditioner states alive now (``track_state``)
_live = [0]


class _Timed:
    """A span that also adds its host seconds to the counter ``key``."""

    __slots__ = ("_range", "_key", "_t0")

    def __init__(self, name: str, key: str):
        self._range = _RecordFunctionFast(name)
        self._key = key

    def __enter__(self):
        self._range.__enter__()
        self._t0 = time.perf_counter()

    def __exit__(self, *exc):
        _counts[self._key] += time.perf_counter() - self._t0
        self._range.__exit__(*exc)
        return False


def span(name: str, seconds: str | None = None):
    """A context manager: the range ``name`` while a profiler records,
    its host seconds added to the counter ``seconds`` when given; a
    shared null context otherwise."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    if seconds is None:
        return _RecordFunctionFast(name)
    return _Timed(name, seconds)


def count(key: str, n=1) -> None:
    """Add ``n`` to the counter ``key`` while a profiler records."""
    if _profiler._is_profiler_enabled:
        _counts[key] += n


def _tally(site: str, out, index) -> None:
    nbytes, calls = _GATHER_KEYS[site]
    _counts[nbytes] += (out.numel() * out.element_size()
                        + index.numel() * index.element_size())
    _counts[calls] += 1


def take(site: str, x, index, part: str | None = None):
    """``x[index]``, an index gather at ``site``; while a profiler
    records, inside the span ``gather.<site>``, and the call and its
    bytes counted: the gathered rows and the index, from their
    shapes; under ``part`` too when one is given."""
    if not _profiler._is_profiler_enabled:
        return x[index]
    with _RecordFunctionFast(_GATHER_SPANS[site]):
        out = x[index]
    _tally(site, out, index)
    if part is not None:
        _tally(part, out, index)
    return out


def put(site: str, x, index, values):
    """``x.index_put((index,), values)``, an indexed write at ``site``,
    spanned and counted as ``take`` is (the values and the index)."""
    if not _profiler._is_profiler_enabled:
        return x.index_put((index,), values)
    with _RecordFunctionFast(_GATHER_SPANS[site]):
        out = x.index_put((index,), values)
    _tally(site, values, index)
    return out


def _freed() -> None:
    _live[0] -= 1


def track_state(state) -> None:
    """Tally ``state``, a multigrid cycle built at one linearization, as
    alive until it is freed; while a profiler records, count the build
    in ``gmg_builds`` and add the states alive, this one included, to
    ``gmg_states_live``."""
    _live[0] += 1
    weakref.finalize(state, _freed)
    if _profiler._is_profiler_enabled:
        _counts["gmg_builds"] += 1
        _counts["gmg_states_live"] += _live[0]


def live_states() -> int:
    """The multigrid preconditioner states alive in the process."""
    return _live[0]


def fold(stats: dict) -> None:
    """Add the counters to ``stats`` and zero them."""
    for key, value in _counts.items():
        stats[key] += value
    _counts.update(COUNTERS)


class SpanTimer(SectionTimer):
    """``SectionTimer`` whose sections are spans too."""

    @contextmanager
    def section(self, name: str):
        with span(name), super().section(name):
            yield
