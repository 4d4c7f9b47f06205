"""Tests of the port's benchmark: ``python -m pytest portbench/tests``
from the root of the repo (``tests/`` does not collect them).  Tests
marked ``card`` need a CUDA card; each decides so inside the test (the
``card`` fixture), never at import."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips "
                            "where there is none")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: this test runs on the card")
    return "cuda"
