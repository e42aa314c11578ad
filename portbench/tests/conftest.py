"""The benchmark's own tests. Run them from the repository's root:

    python -m pytest portbench/tests -q

Tests marked ``card`` need an NVIDIA card and skip without one; the
``card`` fixture decides, when the test runs.
"""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the test runs TF32 products or the program's CUDA kernels")
    return torch.device("cuda", 0)
