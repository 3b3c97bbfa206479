"""The benchmark's tests: `pytest mvsbench/tests`. Tests that need the
card carry the `chip` marker and decide in the `card` fixture whether
one is present (never while a module is imported)."""

import os

os.environ.setdefault("OMP_NUM_THREADS", "1")

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card only")
    return torch.device("cuda", 0)
