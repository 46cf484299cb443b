"""The harness's own tests: `python -m pytest port_bench/tests` from the
repository's root. CPU tests at tiny sizes; the one marked `cuda` runs a
cell's control on the card and skips without one."""
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)   # the servers' threads and the reference share

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    """Skips the test where there is no card (decided here, when the test
    runs, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
