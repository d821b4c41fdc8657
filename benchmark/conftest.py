"""pytest set-up of the benchmark's own tests (``benchmark/tests``).

The harness's packages (``harness``, ``datagen``, ``reference``,
``layers``) are imported from this folder and the program from the
checkout above it.  Tests that need the cell's NVIDIA cards carry the
``card`` marker and skip, inside the ``cards`` fixture, where there are
fewer; run them on the card with ``python -m pytest benchmark/tests -m
card``.
"""

import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(BENCH_DIR)
for p in (CHECKOUT, BENCH_DIR):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: runs a cell on its NVIDIA cards; skips without "
        "them")


@pytest.fixture
def cards():
    """The number of visible cards; the test skips with none."""
    import torch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        pytest.skip("no CUDA card visible")
    return n
