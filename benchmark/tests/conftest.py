"""Tests of the benchmark harness. Those marked ``card`` need an NVIDIA
card and skip without one (decided in a fixture, never at import)."""
import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs an NVIDIA card; skipped without one")


@pytest.fixture(autouse=True)
def _card(request):
    if request.node.get_closest_marker("card"):
        import torch
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA card")


@pytest.fixture(scope="session")
def tiny_root():
    return Path(__file__).resolve().parent / "data"
