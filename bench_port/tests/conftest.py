"""The `card` marker, whose tests skip where no CUDA card is found
(decided in a fixture, at run time), and a checkout with tiny cells for
the CPU tests (bench_port_checkout.py)."""
from __future__ import annotations

import pytest

from bench_port_checkout import make_checkout


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where none is found")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: runs on the chip only")


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return make_checkout(tmp_path_factory.mktemp("checkout"))
