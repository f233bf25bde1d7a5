"""A CPU rehearsal of the ``tgv_re1600_q2`` configuration's files: a tiny
cell of it (4^3 Q2 cells, 2 steps) added beside the benchmark's own, and
one traced run through the harness.

At 4^3 an element's volume is about 3.9, and float32 leaves the
residual's l2 norm near 1.5e-4 on this deck, above its 1e-6: the tiny
cell stops Newton at 3e-4 and holds the reference's readings to 5e-4.
On the CPU the readers of the device's trace find nothing, so the
metrics without a ``workloads`` list that the run has to report are
the others; ``b2_q2_roofline`` reads the device's kernels too."""

import json
import os
import time

from benchtools import make_root
from benchmark import harness

SEED = 2 ** 31 + 77
L = "6.283185307179586"
TINY = "tgv_re1600_q2.n4"
NEW = "tgv_re1600_q2.n64"


def _add_tiny(root, bench):
    """The cell ``TINY``: the n64 cell's file at 4^3 cells, 2 steps."""
    wdir = os.path.join(root, "benchmark", "workloads")
    with open(os.path.join(wdir, NEW + ".json")) as fh:
        cell = json.load(fh)
    cell.update(
        name=TINY, traffic="n4", episode_steps=2, judged_steps=1,
        trace_steps=2, warm_steps=3,
        deck={"mesh": {"grid arguments":
                       f"4, 4, 4 : 0, 0, 0 : {L}, {L}, {L} : true"},
              "non-linear solver": {"tolerance": "3e-4"}},
        limits={"ic_err": 1e-5, "res_setup": 5e-4, "res_window": 5e-4})
    with open(os.path.join(wdir, TINY + ".json"), "w") as fh:
        json.dump(cell, fh)
    bench["workloads"].append({"name": TINY, "config": "tgv_re1600_q2",
                               "traffic": "n4", "chips": 1,
                               "why": "a CPU rehearsal"})
    for m in bench["per_layer"]:
        if NEW in m.get("workloads", []):
            m["workloads"].append(TINY)


def test_traced_rehearsal_of_the_q2_cell(tmp_path):
    root = make_root(tmp_path, {}, extra=_add_tiny)
    out = harness.execute(TINY, SEED, 0.5, True, time.perf_counter(), root,
                          device="cpu")
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    got = set(out["metrics"])
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    plain = {m["name"] for m in bench["per_layer"]
             if "workloads" not in m and m["source"] != "device_trace"}
    assert plain | {"ptransfer_mib_per_newton"} <= got
    assert not got & {"b2_roofline", "b1_roofline",
                      "gmg_states_live_at_build", "b2_q2_roofline"}
    # the p-level's transfers are a part of every site's gathers
    assert out["metrics"]["ptransfer_mib_per_newton"]["value"] > 0
    assert (out["metrics"]["ptransfer_mib_per_newton"]["value"]
            < out["metrics"]["gather_mib_per_newton"]["value"])
