"""The Kelly adaptation after the BDF2 startup step over shards, on the
CPU in float64 (ROADMAP C8).

The JAX package's two time loops differ there: its sharded loop
(``apps/common.py``) adapts after every step the frequency selects, the
startup step included, and its one-device loop (``solvers/base.py``)
adapts nothing after the startup step.  The port follows each: its
N-shard run prints what the JAX package's N-shard run prints, its
one-device run what the JAX package's one-device run prints, and on a
frequency-1 deck the sharded runs adapt once more than the one-device
runs.
"""

import contextlib
import io
import os
import re

from tests.test_golden_apps import GOLDEN_DIR, numdiff
from tests.test_torch_cli import _PORT_ONLY, _run

SHARDS = 4
_ADAPT = re.compile(r"^Mesh adaptation: \d+ -> (\d+) cells", re.M)


def _deck(tmp_path) -> str:
    """The golden Kelly deck over shards (``kelly_np4``: the cylinder in a
    channel, BDF2 with its startup sub-steps, forces every step) with
    Kelly after every step, one step (the startup step, in two
    sub-steps), outside test mode, its forces printed."""
    with open(os.path.join(GOLDEN_DIR, "kelly_np4.prm")) as fh:
        text = fh.read()
    for old, new in (("set frequency            = 2",
                      "set frequency            = 1"),
                     ("set time end  = 0.2", "set time end  = 0.05"),
                     ("set verbosity             = quiet",
                      "set verbosity             = verbose"),
                     ("subsection linear solver\n",
                      "subsection linear solver\n"
                      "  set preconditioner = block_jacobi\n"),
                     ("subsection test\n  set enable = true",
                      "subsection test\n  set enable = false")):
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    path = tmp_path / "kelly_f1.prm"
    path.write_text(text)
    return str(path)


def _jax(deck, n, tmp_path, monkeypatch) -> str:
    from softx_2020_200_tpu.apps.common import run_app as jax_run_app
    monkeypatch.chdir(tmp_path)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jax_run_app(2, [deck] + ([str(n)] if n > 1 else [])) == 0
    return buf.getvalue()


def _port(deck, n, tmp_path, monkeypatch) -> str:
    argv = [deck] + ([str(n)] if n > 1 else []) + ["--device", "cpu",
                                                   "--dtype", "float64"]
    out = _run(2, argv, tmp_path, monkeypatch)
    return "\n".join(ln for ln in out.splitlines()
                     if not ln.startswith(_PORT_ONLY))


def test_sharded_loop_adapts_after_the_startup_step(tmp_path, monkeypatch):
    deck = _deck(tmp_path)
    runs = {}
    for pkg, fn in (("jax", _jax), ("port", _port)):
        for n in (1, SHARDS):
            d = tmp_path / f"{pkg}{n}"
            d.mkdir()
            runs[pkg, n] = fn(deck, n, d, monkeypatch)
    cells = {k: [int(c) for c in _ADAPT.findall(v)] for k, v in runs.items()}
    # the one-device loops adapt nothing after the startup step, the
    # sharded loops adapt there
    assert cells["jax", 1] == [] and len(cells["jax", SHARDS]) == 1
    assert cells["port", 1] == cells["jax", 1]
    assert cells["port", SHARDS] == cells["jax", SHARDS]
    assert "Force boundary 3" in runs["port", SHARDS]
    numdiff(runs["port", 1], runs["jax", 1], rtol=2e-3, atol=1e-7)
    numdiff(runs["port", SHARDS], runs["jax", SHARDS], rtol=2e-3, atol=1e-7)
