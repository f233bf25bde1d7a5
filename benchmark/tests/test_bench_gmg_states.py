"""The reader of ``gmg_states_live_at_build`` on synthetic run contexts:
the live states summed over the builds, over the builds, and None,
never an error, where a program has no build counters (the keys
absent) or built no multigrid state in the window."""

import pytest

from benchtools import ROOT  # noqa: F401 - puts the checkout on sys.path
from benchmark.harness import RunContext
from test_bench_files import _module

READ = _module("metrics", "gmg_states_live_at_build").read


@pytest.mark.parametrize("builds,live,expected", [
    (40, 40, 1.0),          # each state freed before the next build
    (40, 80, 2.0),          # each outlived its Newton iteration
    (6, 9, 1.5),
])
def test_reads_the_counters(builds, live, expected):
    stats = {"newton_iterations": builds, "gmg_builds": builds,
             "gmg_states_live": live}
    assert READ(RunContext(stats=stats)) == pytest.approx(expected)


@pytest.mark.parametrize("stats", [
    {},                                             # no counters at all
    {"newton_iterations": 4, "vcycles": 20},        # the parent's stats
    {"gmg_builds": 0, "gmg_states_live": 0},        # no build (no GMG)
    {"gmg_builds": 4},                              # one counter only
], ids=["empty", "parent", "no-build", "no-tally"])
def test_none_without_builds(stats):
    assert READ(RunContext(stats=stats)) is None
