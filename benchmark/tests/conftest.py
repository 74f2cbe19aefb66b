"""The benchmark's own tests (run from the repository root:
`python -m pytest benchmark/tests -q -p no:cacheprovider`). Tests that need a
card carry the repository's `cuda` marker (pytest.ini) and skip inside the
`cuda_device` fixture when there is none."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the chip)")
    return torch.device("cuda")
