"""The PyTorch package's CLI over N shards on the CPU in float64 against
the JAX package's multi-device goldens (``tests/test_golden_apps.py``:
the ``mms_bdf2_np8`` deck and the GD deck 8-way, and the restart across
shard counts from per-shard checkpoints).
"""

import os

import pytest
import torch

from tests.test_golden_apps import GOLDEN_DIR, numdiff
from tests.test_torch_cli import _run_shards


@pytest.mark.parametrize("name,solver", [("mms_bdf2_np8", "gls"),
                                         ("gd_mms_bdf2", "gd")])
def test_cli_sharded_reproduces_golden_output(name, solver, tmp_path,
                                              monkeypatch):
    """8 shards print the golden (``test_golden_mms_bdf2_multidevice``,
    ``test_golden_gd_mms_bdf2_sharded``)."""
    out = _run_shards(name, 8, tmp_path, monkeypatch, solver)
    with open(os.path.join(GOLDEN_DIR, name + ".output")) as fh:
        numdiff(out, fh.read())


def test_cli_sharded_restart_across_shard_counts(tmp_path, monkeypatch):
    """Per-shard checkpoints (``test_golden_restart_sharded_cross_device_
    count``): leg a 4-way writes the manifest and one file per shard,
    never the global field; the JAX package's reader gives the port's
    stacks from those files; leg b restores 8-way and prints the restart
    golden."""
    import numpy as np

    from softx_2020_200_tpu.parallel.sharded import \
        ShardedGLSSolver as JaxSharded
    from softx_2020_200_tpu_torch.core.parameters import \
        SimulationParameters
    from softx_2020_200_tpu_torch.parallel.sharded import ShardedGLSSolver
    from softx_2020_200_tpu_torch.solvers.base import GLSNavierStokesSolver
    _run_shards("restart_adaptive_a", 4, tmp_path, monkeypatch)
    assert (tmp_path / "restart_adaptive.shard3.npz").exists()
    assert not (tmp_path / "restart_adaptive.shard4.npz").exists()
    man = np.load(tmp_path / "restart_adaptive.npz")
    assert "u" not in man and "previous" not in man
    prm = SimulationParameters.from_file(
        os.path.join(GOLDEN_DIR, "restart_adaptive_b.prm"), dim=2)
    s = GLSNavierStokesSolver(prm, device="cpu", dtype=torch.float64)
    layout = ShardedGLSSolver.from_solver(s, ["cpu"] * 8).layout
    path = str(tmp_path / "restart_adaptive")
    got = ShardedGLSSolver.read_checkpoint_shards(path, layout,
                                                  torch.float64)
    want = JaxSharded.read_checkpoint_shards(path, layout, np.float64)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert np.abs(got[0]).max() > 0
    out = _run_shards("restart_adaptive_b", 8, tmp_path, monkeypatch)
    with open(os.path.join(GOLDEN_DIR, "restart_adaptive_b.output")) as fh:
        numdiff(out, fh.read())
