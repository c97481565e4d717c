"""Frozen copy, one process: the batch-wide normaliser of the port's
``parallel/dist.py`` without a process group (no cell of the benchmark runs
more than one rank; a cell on several cards copies the collectives in)."""
from __future__ import annotations

from typing import Optional

import torch


def reduce_mean_denominator(x: torch.Tensor,
                            clamp_min: Optional[float] = None,
                            offset: float = 0.0) -> torch.Tensor:
    """A batch-wide normaliser under mmdet's ``reduce_mean`` convention,
    one process: ``clamp(x + offset, clamp_min)``."""
    total = x + offset if offset else x
    if clamp_min is not None:
        total = torch.clamp(total, min=clamp_min)
    return total
