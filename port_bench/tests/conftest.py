"""The benchmark's CPU tests: ``python -m pytest port_bench/tests`` from the
repository root.  No JAX here; tests that need a card carry the ``cuda``
marker and skip without one."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")
