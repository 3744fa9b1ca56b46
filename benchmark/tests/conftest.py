"""Tests of the benchmark itself (not collected by the repository's
``pytest tests/``): run them with ``python -m pytest benchmark/tests -q``.
Tests that need the CUDA card carry the ``card`` marker and decide about the
card inside the test."""
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs the CUDA card; skips without one")
