"""Helpers of the benchmark's own tests: tiny cells and a checkout of
the benchmark in a temporary directory."""

import copy
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

L = "6.283185307179586"

# tiny cells of the two configurations, with limits for float32 on the
# CPU at these sizes
TINY = {
    "tgv_re1600_q1.n8": {
        "config": "tgv_re1600_q1", "traffic": "n8",
        "deck": {"mesh": {"grid arguments":
                          f"8, 8, 8 : 0, 0, 0 : {L}, {L}, {L} : true"}},
        "limits": {"ic_err": 1e-5, "res_setup": 1e-4, "res_window": 1e-4}},
    "cylinder_re100_q2.r0": {
        "config": "cylinder_re100_q2", "traffic": "r0",
        "deck": {"mesh": {"initial refinement": "0"}},
        "limits": {"ic_err": 1e-5, "bc_err": 1e-5, "res_setup": 1e-2,
                   "res_window": 1e-4}},
}


def make_root(tmp_path, cells=TINY, extra=None) -> str:
    """A checkout of the benchmark in ``tmp_path``: BENCHMARK.json and
    benchmark/ copied, plus the tiny ``cells`` (one episode of 2 steps,
    1 warm step... as each gives) and ``extra(root, bench)`` edits."""
    root = str(tmp_path / "checkout")
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    for name, over in cells.items():
        with open(os.path.join(ROOT, "benchmark", "workloads",
                               f"{over['config']}.r5.json"
                               if "cylinder" in name else
                               f"{over['config']}.n96.json")) as fh:
            cell = json.load(fh)
        cell = copy.deepcopy(cell)
        cell.update(name=name, traffic=over["traffic"], deck=over["deck"],
                    limits=over["limits"], episode_steps=2, judged_steps=1,
                    trace_steps=2, warm_steps=3)
        with open(os.path.join(root, "benchmark", "workloads",
                               name + ".json"), "w") as fh:
            json.dump(cell, fh)
        bench["workloads"].append({"name": name, "config": over["config"],
                                   "traffic": over["traffic"], "chips": 1,
                                   "why": "a CPU rehearsal"})
        for m in bench["per_layer"]:
            if "workloads" in m and any(
                    w.startswith(over["config"]) for w in m["workloads"]):
                m["workloads"].append(name)
    if extra is not None:
        extra(root, bench)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    return root
