"""CPU rehearsals of whole runs: the harness past its look for a card,
at tiny sizes.  The result line has the contract's keys; a cell, a
configuration and a metric added as files alone run; nothing loads JAX
or the JAX package."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from benchtools import ROOT, TINY, make_root
from benchmark import harness

SEED = 2 ** 31 + 99

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _execute(root, name, trace=False, seconds=0.5):
    return harness.execute(name, SEED, seconds, trace, time.perf_counter(),
                           root, device="cpu")


@pytest.mark.parametrize("name", sorted(TINY))
def test_cpu_rehearsal(tiny_root, name):
    out = _execute(tiny_root, name)
    assert list(out) == KEYS
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"setup_s", "step_s"}   # no peak on CPU
    assert out["attempted"] >= 1 and out["failed"] >= 0
    assert out["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                             "memory_peak_bytes": 0}
    assert all(set(v) == {"value", "limit"} for v in out["checks"].values())
    json.dumps(out)


def test_traced_rehearsal(tiny_root):
    out = _execute(tiny_root, "tgv_re1600_q1.n8", trace=True)
    assert list(out) == KEYS[:5] + ["breakdown", "checks"]
    assert out["correct"] is True
    assert {"newton_per_step", "fgmres_per_newton",
            "host_syncs_per_newton"} <= set(out["metrics"])
    assert set(out["device"]) >= {"busy_s", "window_s"}
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def _add_files(root, bench):
    """A configuration, a cell on it and a per-layer metric, as files."""
    bdir = os.path.join(root, "benchmark")
    with open(os.path.join(bdir, "configs", "tgv_re1600_q1.json")) as fh:
        conf = json.load(fh)
    conf["name"] = "tgv_nu1e3_q1"
    conf["deck"]["physical properties"]["kinematic viscosity"] = "0.001"
    with open(os.path.join(bdir, "configs", "tgv_nu1e3_q1.json"), "w") as fh:
        json.dump(conf, fh)
    with open(os.path.join(bdir, "workloads",
                           "tgv_re1600_q1.n8.json")) as fh:
        cell = json.load(fh)
    cell.update(name="tgv_nu1e3_q1.n8", config="tgv_nu1e3_q1")
    with open(os.path.join(bdir, "workloads",
                           "tgv_nu1e3_q1.n8.json"), "w") as fh:
        json.dump(cell, fh)
    with open(os.path.join(bdir, "metrics", "window_steps.py"), "w") as fh:
        fh.write('def read(ctx):\n    return ctx.steps\n')
    bench["configs"].append({"name": "tgv_nu1e3_q1", "source": "x",
                             "file": "benchmark/configs/tgv_nu1e3_q1.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tgv_nu1e3_q1.n8",
                               "config": "tgv_nu1e3_q1", "traffic": "n8",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "window_steps", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "engine", "moves": "step_s",
                               "workloads": ["tgv_nu1e3_q1.n8"]})


def test_files_alone_add_a_cell_a_configuration_and_a_metric(tmp_path):
    root = make_root(tmp_path, {"tgv_re1600_q1.n8": TINY["tgv_re1600_q1.n8"]},
                     extra=_add_files)
    out = _execute(root, "tgv_nu1e3_q1.n8", trace=True)
    assert out["correct"] is True
    assert out["metrics"]["window_steps"]["value"] >= 1
    assert "b1_roofline" not in out["metrics"]


def test_unknown_cell_prints_nothing(tiny_root):
    with pytest.raises(SystemExit):
        _execute(tiny_root, "no_such.cell")


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "softx_2020_200_tpu_torch_x", sys)
    assert "softx_2020_200_tpu_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in harness.forbidden_modules()


def test_a_run_loads_no_jax(tiny_root):
    code = (
        "import sys, time; sys.path.insert(0, sys.argv[1]);"
        "from benchmark import harness;"
        "harness.execute('tgv_re1600_q1.n8', 3, 0.2, True, time.perf_counter(),"
        " sys.argv[2], device='cpu');"
        "print(sorted({m.split('.')[0] for m in sys.modules}))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, ROOT, tiny_root],
                         capture_output=True, text=True, env=env,
                         timeout=600, check=True).stdout.strip().splitlines()
    loaded = set(eval(out[-1]))  # noqa: S307 - our own child's output
    assert "softx_2020_200_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_without_a_card_run_py_prints_nothing(tmp_path):
    """``run.py`` from a directory that holds only BENCHMARK.json and
    benchmark/: no result line, a non-zero exit."""
    root = tmp_path / "bare"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "tgv_re1600_q1.n96", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=root, capture_output=True, text=True, env=env,
        timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
