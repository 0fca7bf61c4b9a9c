"""CPU tests of the benchmark. Tests that need a CUDA card carry the
``chip`` marker and skip, inside the ``cuda`` fixture, where torch sees
none."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
for _p in (os.path.dirname(HERE), HERE):  # the program of this checkout, the yardstick
    if _p not in sys.path:
        sys.path.insert(0, _p)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
