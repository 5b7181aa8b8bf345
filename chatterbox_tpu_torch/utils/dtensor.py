"""A parameter tree's leaves may be DTensors (a sharded training state) or
plain tensors; these read either the same way."""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate


def full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value on every process (a plain tensor as it is)."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this process (a plain tensor as it is)."""
    return t.to_local() if isinstance(t, DTensor) else t


def settled(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's pending partial sums reduced over their mesh axes, so
    that a cast after it rounds the whole sum once (XLA reduces a sharded
    dot's f32 result before converting it); anything else as it is."""
    if not isinstance(t, DTensor) or not any(p.is_partial() for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in t.placements])
