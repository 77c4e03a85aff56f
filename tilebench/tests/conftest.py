"""Tests of the benchmark's harness.  They run on the CPU; the one that
needs a CUDA device carries the `cuda` marker and skips without one.

    python -m pytest tilebench/tests -q -p no:cacheprovider
    python -m pytest tilebench/tests -q -m cuda -p no:cacheprovider   # on the card
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips without one")
