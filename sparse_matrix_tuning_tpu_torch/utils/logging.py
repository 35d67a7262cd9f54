"""Logging / seeding utilities (reference deepspeed_helpers.py:166-174,
:369-381)."""

from __future__ import annotations

import random

import numpy as np
import torch


def print_rank_0(msg, rank: int | None = None):
    """Print once per job. The port runs one process, which is rank 0
    unless torch.distributed says otherwise."""
    if rank is None:
        dist = torch.distributed
        rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    if rank <= 0:
        print(msg, flush=True)


def set_random_seed(seed: int):
    """Seed python, numpy and torch."""
    if seed is None:
        return
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
