"""Signal helpers (plain PyTorch)."""
from __future__ import annotations

import torch


def snake_1d(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake activation x + sin^2(alpha*x)/alpha (arXiv:2006.08195).

    Parity: reference snake_1d src/util.cpp:98-101; alpha broadcasts over
    the channel dim."""
    return x + torch.sin(alpha * x).square() / alpha
