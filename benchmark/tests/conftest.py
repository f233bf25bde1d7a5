"""Set-up of the benchmark's own tests: they run on the CPU; a test
that needs the card is marked ``card`` and skips without CUDA."""

import pytest

from benchtools import make_root


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
