"""pytest settings of the benchmark's own tests (``flockbench/tests``):
the checkout's root on ``sys.path`` and the ``cuda`` marker, for tests that
need a card and skip without one."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skipped without one")
