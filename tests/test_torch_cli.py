"""The PyTorch package's CLI on the CPU in float64.

It reproduces the JAX package's golden outputs under the same numeric
diff (``tests/test_golden_apps.py::numdiff``, rtol 2e-3), refuses what
it cannot do instead of doing something else, and says so.
"""

import contextlib
import io
import os

import pytest
import torch

from softx_2020_200_tpu_torch.apps.common import run_app
from tests.test_golden_apps import GOLDEN_DIR, numdiff

torch.set_num_threads(1)


def _run(dim, argv, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run_app(dim, argv)
    assert rc == 0
    return buf.getvalue()


@pytest.mark.parametrize("name", ["couette_gls", "mms_bdf2", "periodic_gls"])
def test_cli_reproduces_golden_output(name, tmp_path, monkeypatch):
    deck = os.path.join(GOLDEN_DIR, name + ".prm")
    out = _run(2, [deck, "--device", "cpu", "--dtype", "float64"],
               tmp_path, monkeypatch)
    with open(os.path.join(GOLDEN_DIR, name + ".output")) as fh:
        numdiff(out, fh.read())


def _write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def _golden(name):
    with open(os.path.join(GOLDEN_DIR, name + ".prm")) as fh:
        return fh.read()


def test_cli_without_test_mode_reports_solver_counts(tmp_path, monkeypatch):
    """Outside ``subsection test`` the app says what ``auto`` resolves to
    and prints the Newton summary with the host syncs per iteration."""
    text = _golden("periodic_gls")
    assert text.endswith("subsection test\n  set enable = true\nend\n")
    text = text[:-len("  set enable = true\nend\n")] + "end\n"
    deck = _write(tmp_path, "deck.prm", text)
    out = _run(2, [deck, "--device", "cpu", "--dtype", "float64"],
               tmp_path, monkeypatch)
    assert "preconditioner 'auto' resolves to block_jacobi" in out
    summary = [ln for ln in out.splitlines()
               if ln.startswith("Newton summary: 1 solves")]
    assert len(summary) == 1
    assert "host syncs per Newton iteration" in summary[0]


@pytest.mark.parametrize("edit,match", [
    ("  set preconditioner = gmg\n", "A7, D1"),
    ("  set preconditioner = additive_schwarz\n", "D4"),
    ("  set jacobian state precision = bf16\n", "D5"),
])
def test_cli_refuses_what_is_not_ported(edit, match, tmp_path, monkeypatch):
    text = _golden("couette_gls").replace(
        "subsection linear solver\n", "subsection linear solver\n" + edit)
    deck = _write(tmp_path, "deck.prm", text)
    with pytest.raises(NotImplementedError, match=match):
        _run(2, [deck, "--device", "cpu"], tmp_path, monkeypatch)


def test_cli_device_and_device_count(tmp_path, monkeypatch):
    deck = os.path.join(GOLDEN_DIR, "couette_gls.prm")
    with pytest.raises(NotImplementedError, match="one device"):
        _run(2, [deck, "2", "--device", "cpu"], tmp_path, monkeypatch)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            _run(2, [deck], tmp_path, monkeypatch)
