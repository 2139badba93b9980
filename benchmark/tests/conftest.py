"""CPU tests of the benchmark harness. The harness's modules import each
other by their bare names (benchmark/ on sys.path), as benchmark/run.py
arranges for itself."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (skips without one)")
