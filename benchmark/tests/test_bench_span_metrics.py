"""The readers of the program's span counters on synthetic run contexts:
a value from the counters when they are there, and None, never an
error, where a program has no such counters (the keys absent) or they
did not move (zero)."""

import pytest

from benchtools import ROOT  # noqa: F401 - puts the checkout on sys.path
from benchmark.harness import RunContext
from test_bench_files import _module

STATS = {"newton_iterations": 4, "newton_seconds": 2.0,
         "sync_wait_s": 0.5, "vcycles": 20, "vcycle_s": 0.3,
         "gather_bytes_transfer": 3 * 2 ** 20,
         "gather_bytes_operator": 2 ** 20,
         "gather_bytes_constraints": 2 ** 19,
         "gather_bytes_smoother": 2 ** 19}

EXPECTED = {"vcycle_host_ms": 15.0, "host_ms_per_newton": 375.0,
            "gather_mib_per_newton": 1.25}

# the counters each reader needs to be non-zero
NEEDS = {"vcycle_host_ms": ("vcycles", "vcycle_s"),
         "host_ms_per_newton": ("newton_iterations", "newton_seconds",
                                "sync_wait_s"),
         "gather_mib_per_newton": ("newton_iterations",)}

# the parent's stats: no span counters
PARENT = {"newton_solves": 2, "newton_iterations": 4,
          "linear_iterations": 20, "host_syncs": 30,
          "line_search_evaluations": 4, "linear_restarts": 0,
          "solves_above_tolerance": 0, "newton_seconds": 2.0}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reads_the_counters(name):
    value = _module("metrics", name).read(RunContext(stats=dict(STATS)))
    assert value == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_none_without_the_counters(name):
    read = _module("metrics", name).read
    assert read(RunContext(stats=dict(PARENT))) is None
    assert read(RunContext()) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_none_where_a_counter_is_zero(name):
    read = _module("metrics", name).read
    for key in NEEDS[name]:
        assert read(RunContext(stats={**STATS, key: 0})) is None, key
    if name == "gather_mib_per_newton":
        zero = {k: 0 for k in STATS if k.startswith("gather_bytes_")}
        assert read(RunContext(stats={**STATS, **zero})) is None
