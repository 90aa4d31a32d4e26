"""pytest settings of the benchmark's own tests (``portbench/tests``).

Run them from the root of the checkout with

    python -m pytest portbench/tests -q

Tests marked ``portbench_card`` need an NVIDIA GPU and skip without one;
the ``card`` fixture decides, when the test runs.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "portbench_card: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark runs on the card only")
    return "cuda"
