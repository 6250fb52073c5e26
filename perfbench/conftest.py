"""pytest settings of the benchmark's tests (``python -m pytest perfbench/tests -q``).

Tests marked ``card`` need an NVIDIA card and skip on a machine without one;
they decide that inside the test, through the ``card`` fixture. Run them on
the card with ``python -m pytest perfbench/tests -q -m card``.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test measures or runs kernels on the card")
    return torch.device("cuda", 0)
