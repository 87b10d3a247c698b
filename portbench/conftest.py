"""pytest settings of the benchmark's own tests (``python -m pytest portbench/tests``).

``card``: a test that needs a CUDA card; it looks for one inside the test
and skips without it."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")
