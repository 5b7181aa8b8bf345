"""A parameter tree's leaves may be DTensors (a sharded training state) or
plain tensors; these read either the same way."""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor


def full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value on every process (a plain tensor as it is)."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this process (a plain tensor as it is)."""
    return t.to_local() if isinstance(t, DTensor) else t
