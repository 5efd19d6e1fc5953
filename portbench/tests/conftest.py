"""The benchmark's own tests: ``python -m pytest portbench/tests -q``
(the CPU; tests marked ``cuda`` skip there and run on the card with
``python -m pytest portbench/tests -m cuda``)."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
