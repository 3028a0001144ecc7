"""pytest settings of the benchmark's tests (python -m pytest geobench/tests).

`card` marks a test that needs an NVIDIA card; it skips without one, as the
`card` fixture decides inside the test (never at import)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (runs on the chip); skipped "
        "without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the chip")
    return torch.device("cuda:0")
