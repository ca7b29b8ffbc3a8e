"""The harness's tests: on the CPU, run from the repository's root with
``python -m pytest perfbench/tests``; the ``gpu`` tests need a card and
skip without one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def cuda_card():
    """Skip unless a CUDA card is present (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
