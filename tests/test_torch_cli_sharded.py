"""The PyTorch package's CLI over N shards on the CPU in float64 against
its own one-device run: SDIRK2 stages, CFL-adaptive dt and transient
Kelly adaptation print what one device prints (the JAX package's
``tests/test_golden_apps.py`` multi-device decks).  The golden and
restart cases over shards are in ``test_torch_cli_sharded_golden.py``.
"""

import pytest

from tests.test_golden_apps import numdiff
from tests.test_torch_cli import _run_shards


@pytest.mark.parametrize("name,n,rtol,atol", [
    ("sdirk_np8", 8, 1e-5, 1e-9), ("adaptive_np8", 8, 1e-5, 1e-9),
    ("kelly_np4", 4, 2e-3, 1e-7)])
def test_cli_sharded_matches_one_device(name, n, rtol, atol, tmp_path,
                                        monkeypatch):
    """SDIRK2 stages, CFL-adaptive dt (the sharded CFL reduction drives
    the dt sequence) and transient Kelly adaptation (gather, adapt,
    re-shard on the forest, hanging rows per shard): N shards print what
    one device prints, under the JAX package's tolerances."""
    (tmp_path / "one").mkdir()
    one = _run_shards(name, 1, tmp_path / "one", monkeypatch)
    out = _run_shards(name, n, tmp_path, monkeypatch)
    numdiff(out, one, rtol=rtol, atol=atol)
