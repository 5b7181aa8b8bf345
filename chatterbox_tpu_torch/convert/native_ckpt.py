"""This package's own checkpoint format: parameter trees <-> .safetensors
(the counterpart of chatterbox_tpu/convert/native_ckpt.py), so a reference
checkpoint is converted once and later loads are one flat read. Tree paths
flatten to '/'-joined keys, list indices as numbers: the JAX package's keys
for the same tree. Files are written and read by this package's own code
(no `safetensors` package), each tensor in its own type, bfloat16 included.
A quantized tree's fused and int4 leaves are views of one another, which a
load does not rebuild: save float trees and quantize after loading.

Training state: a DTensor leaf is gathered to its whole value on save
(every process of the group calls the save, since the gather is
collective; process 0 writes the file);
`load_into` copies a loaded tree into live (possibly sharded) parameters in
place; `save_optimizer` / `load_optimizer` keep AdamW's moments under the
parameters' keys and the number of updates made (the schedule's position).
"""
from __future__ import annotations

import json
import struct
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from ..utils.dtensor import full, local
from .weights import read_safetensors

_ST_NAMES = {torch.float64: "F64", torch.float32: "F32", torch.float16: "F16",
             torch.bfloat16: "BF16", torch.int64: "I64", torch.int32: "I32",
             torch.int16: "I16", torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL"}


def save_safetensors(tensors: dict, path):
    """Write {name: tensor or numpy array} as a .safetensors file."""
    tensors = {k: torch.as_tensor(t).detach() for k, t in tensors.items()}
    header, offset = {}, 0
    for name, t in tensors.items():
        if t.dtype not in _ST_NAMES:
            raise ValueError(f"{name}: cannot store {t.dtype}")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)                 # the buffer starts 8-aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for t in tensors.values():
            if t.numel():
                f.write(t.cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _writer() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def save_pytree(params, path):
    tensors = {k: full(t) for k, t in _flatten(params)}
    if _writer():
        save_safetensors(tensors, path)


def load_pytree(path, template, device="cuda"):
    """Load into the structure of `template` (the tree that was saved, or
    its meta-device init), each leaf on `device` in its stored type."""
    tensors = read_safetensors(path)

    def fill(node, prefix=()):
        if isinstance(node, dict):
            return {k: fill(v, prefix + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [fill(v, prefix + (str(i),)) for i, v in enumerate(node)]
        k = "/".join(prefix)
        if k not in tensors:
            raise KeyError(f"checkpoint {path} missing key {k}")
        if tuple(tensors[k].shape) != tuple(node.shape):
            raise ValueError(f"checkpoint {path}: {k} has shape {tuple(tensors[k].shape)}, "
                             f"expected {tuple(node.shape)}")
        return tensors[k].to(device)

    return fill(template)


def _place_like(src: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """src (a whole tensor) on like's device, sharded as like is."""
    src = src.to(like.device, like.dtype)
    if isinstance(like, DTensor):
        return distribute_tensor(src, like.device_mesh, like.placements)
    return src


@torch.no_grad()
def load_into(params, tree) -> None:
    """Copy the leaves of `tree` (whole tensors, the same structure) into
    the tensors of `params` in place, each sharded as its target is."""
    src = dict(_flatten(tree))
    for k, t in _flatten(params):
        if tuple(src[k].shape) != tuple(t.shape):
            raise ValueError(f"{k}: shape {tuple(src[k].shape)}, expected {tuple(t.shape)}")
        t.copy_(_place_like(src[k], t))


def _whole_like(shard: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A local shard of p's layout -> the whole tensor."""
    if isinstance(p, DTensor):
        return DTensor.from_local(shard, p.device_mesh, p.placements,
                                  run_check=False).full_tensor()
    return shard


def save_optimizer(state, path):
    """A TrainState's AdamW moments ("mu/<key>", "nu/<key>", whole tensors
    under the parameters' keys; zeros before the first update) and
    "count", the number of updates made."""
    out = {"count": torch.tensor(state.step, dtype=torch.int64)}
    for (k, p), lp in zip(_flatten(state.params), state.locals):
        st = state.adamw.state.get(lp, {})
        for name, slot in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            out[f"{name}/{k}"] = (_whole_like(st[slot], p) if slot in st
                                  else torch.zeros(p.shape))
    if _writer():
        save_safetensors(out, path)


def load_optimizer(state, path) -> None:
    """Restore `save_optimizer`'s file into a TrainState built over the same
    parameters: the moments (each process its shard), AdamW's step and
    state.step."""
    tensors = read_safetensors(path)
    count = int(tensors["count"])
    for (k, p), lp in zip(_flatten(state.params), state.locals):
        for name in ("mu", "nu"):
            if tuple(tensors[f"{name}/{k}"].shape) != tuple(p.shape):
                raise ValueError(f"{path}: {name}/{k} does not match its parameter")
        shard = lambda name: local(_place_like(tensors[f"{name}/{k}"], p))
        state.adamw.state[lp] = {"step": torch.tensor(float(count)),
                                 "exp_avg": shard("mu"), "exp_avg_sq": shard("nu")}
    state.step = count


def save_engine_checkpoint(out_dir, *, t3_params=None, s3gen_params=None,
                           ve_params=None, meta: dict | None = None):
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    if t3_params is not None:
        save_pytree(t3_params, out / "t3_native.safetensors")
    if s3gen_params is not None:
        save_pytree(s3gen_params, out / "s3gen_native.safetensors")
    if ve_params is not None:
        save_pytree(ve_params, out / "ve_native.safetensors")
    if meta:
        (out / "chatterbox_tpu.json").write_text(json.dumps(meta, indent=2))
