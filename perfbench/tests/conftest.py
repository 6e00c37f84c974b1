"""Tests of the benchmark itself, run on the CPU:

    python -m pytest -q perfbench/tests

The harness's modules are imported as the runner imports them, with
``perfbench/`` and ``src/`` on the path.  Tests marked ``gpu`` need a CUDA
card and skip here.
"""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
