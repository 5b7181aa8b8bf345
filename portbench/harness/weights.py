"""Random weights made on the device from the run's seed, in a few large
calls: the parameter tree is laid out once with placeholders (the
reference's own init functions name every leaf, its shape and its
distribution), then every uniform leaf is cut from one `torch.rand` call,
every normal leaf from one `torch.randn` call and every constant from one
fill, each scaled by one elementwise product, and cast once to the type the
weights are served in. The leaves are views of those buffers.

The same tree goes to the program and to the reference; whatever the
program derives from it, the reference works out again.
"""
from __future__ import annotations

import torch

from ..reference import nn as ref_nn


class _Leaf:
    __slots__ = ("kind", "shape", "arg")

    def __init__(self, kind: str, shape, arg: float):
        self.kind, self.shape, self.arg = kind, tuple(shape), float(arg)

    @property
    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


class BulkInit(ref_nn.Init):
    """nn.Init's interface; its draws are placeholders until `fill`."""

    def __init__(self, device):
        self.device = torch.device(device)   # where an init function makes a fixed leaf
        self.leaves: list = []

    def _leaf(self, kind, shape, arg):
        leaf = _Leaf(kind, shape, arg)
        self.leaves.append(leaf)
        return leaf

    def uniform(self, shape, bound: float):
        return self._leaf("uniform", shape, bound)

    def normal(self, shape, std: float = 1.0):
        return self._leaf("normal", shape, std)

    def const(self, shape, value: float):
        return self._leaf("const", shape, value)

    def fill(self, tree, generator: torch.Generator, device, dtype=torch.float32):
        """The tree with every placeholder replaced by its values."""
        views = {}
        for kind in ("uniform", "normal", "const"):
            leaves = [l for l in self.leaves if l.kind == kind]
            if not leaves:
                continue
            counts = torch.tensor([l.numel for l in leaves], device=device)
            args = torch.tensor([l.arg for l in leaves], device=device)
            scale = torch.repeat_interleave(args, counts)
            n = int(counts.sum())
            if kind == "uniform":
                buf = (torch.rand(n, generator=generator, device=device) * 2.0 - 1.0) * scale
            elif kind == "normal":
                buf = torch.randn(n, generator=generator, device=device) * scale
            else:
                buf = scale
            buf = buf.to(dtype)
            off = 0
            for l in leaves:
                views[id(l)] = buf[off:off + l.numel].view(l.shape)
                off += l.numel

        def walk(t):
            if isinstance(t, dict):
                return {k: walk(v) for k, v in t.items()}
            if isinstance(t, list):
                return [walk(v) for v in t]
            return views[id(t)] if isinstance(t, _Leaf) else t

        return walk(tree)


def make_tree(init_fn, cfg: dict, seed: int, device, dtype=torch.float32):
    """init_fn(init, cfg) -> tree, filled from a generator on `device`
    seeded with `seed`."""
    bulk = BulkInit(device)
    tree = init_fn(bulk, cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return bulk.fill(tree, gen, device, dtype)

