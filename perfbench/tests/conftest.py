"""Tests of the benchmark harness: run from the repository's root with
`python -m pytest perfbench/tests -q -p no:cacheprovider`. Tests marked
`cuda` need an NVIDIA card and skip where torch sees none."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (the torch port's kernels); "
                   "skips where torch sees none")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
