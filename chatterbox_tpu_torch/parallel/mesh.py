"""The (data, model) device mesh and T3's sharding rules over DTensor (the
counterpart of chatterbox_tpu/parallel/mesh.py).

The JAX package places arrays with `NamedSharding(mesh, PartitionSpec)` and
lets XLA insert the collectives. Here each parameter is a DTensor with one
placement per mesh axis ("data", "model"), and DTensor's sharding
propagation inserts the redistributions (all-reduce after a row-parallel
projection, all-gather before a softmax over a sharded vocabulary):
  * the batch: `Shard(0)` over "data", replicated over "model";
  * T3's attention and MLP weights: column-parallel in (`Shard(1)` over
    "model"), row-parallel out (`Shard(0)`), the heads' vocabularies over
    "model"; everything else replicated.
A placement that does not divide its dimension evenly is dropped for
replication, as the JAX package does.

A mesh is always a `DeviceMesh` over the process group's world: under
`torchrun` one process a device, otherwise a world of one set up here (an
in-process store, so no port is opened; NCCL for "cuda", gloo for "cpu"),
so one code path serves one device and many.
"""
from __future__ import annotations

import os
import re
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Partial, Replicate, Shard, distribute_tensor

AXES = ("data", "model")


def init_world(device_type: str = "cuda") -> None:
    """Join the process group once: from torchrun's environment when it is
    set (and pin this process to its local card), else as a world of one.
    The backend serves both CPU and CUDA tensors where CUDA is present."""
    if dist.is_initialized():
        return
    backend = "cpu:gloo,cuda:nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              device_type: str = "cuda") -> DeviceMesh:
    """A (data, model) mesh over the world's n devices (all of them by
    default): dp rows (2 when n >= 4, else n), n // dp columns."""
    init_world(device_type)
    n = n_devices or dist.get_world_size()
    if n != dist.get_world_size():
        raise ValueError(f"a mesh of {n} devices over a world of {dist.get_world_size()}")
    if dp is None:
        dp = 2 if n >= 4 else n
    if n % dp:
        raise ValueError(f"dp={dp} does not divide {n} devices")
    return init_device_mesh(device_type, (dp, n // dp), mesh_dim_names=AXES)


# ---------------------------------------------------------------------------
# T3 parameter sharding rules: (regex over the space-joined key path, the
# JAX PartitionSpec as a tuple of axis names or None, one per dimension)
# ---------------------------------------------------------------------------

_T3_RULES = [
    # llama attention / mlp: column-parallel in, row-parallel out
    (r".*\bbackbone\b.*\b(q|k|v|gate|up)\b.*\bw$", (None, "model")),
    (r".*\bbackbone\b.*\b(o|down)\b.*\bw$", ("model", None)),
    # gpt2 fused qkv + mlp
    (r".*\bbackbone\b.*\b(qkv|fc_in)\b.*\bw$", (None, "model")),
    (r".*\bbackbone\b.*\b(qkv|fc_in)\b.*\bb$", ("model",)),
    (r".*\bbackbone\b.*\b(attn_out|fc_out)\b.*\bw$", ("model", None)),
    # embeddings / heads: shard the vocab axis
    (r".*\b(text_emb|speech_emb|text_pos_emb|speech_pos_emb|wpe)\b.*\bw$", (None,)),
    (r".*\b(text_head|speech_head)\b.*\bw$", (None, "model")),
]


def t3_param_spec(path) -> tuple:
    """The partition spec of the T3 leaf at `path` (a tuple of keys and
    list indices): one entry per sharded leading dimension, each an axis
    name or None; () replicates."""
    s = " ".join(str(p) for p in path)
    for pattern, spec in _T3_RULES:
        if re.match(pattern, s):
            return spec
    return ()


def placements(mesh: DeviceMesh, spec: tuple, shape) -> list:
    """DTensor placements for a partition spec on `mesh`: each mesh axis
    named in the spec shards that dimension, the others replicate. A spec
    that names an axis whose size does not divide its dimension gives
    all-replicated placements. An axis of one device replicates (the same
    layout; DTensor refuses some views of a dimension sharded over one
    device, such as a batch of one row)."""
    out = [Replicate() for _ in mesh.mesh_dim_names]
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        i = mesh.mesh_dim_names.index(axis)
        if mesh.size(i) == 1:
            continue
        if shape[dim] % mesh.size(i):
            return [Replicate() for _ in mesh.mesh_dim_names]
        out[i] = Shard(dim)
    return out


def _map_with_path(fn, tree, path=()):
    """fn(path, leaf) over a tree of dicts, lists, tuples and NamedTuples,
    keeping each container's type."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
        if isinstance(tree, list):
            return out
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return fn(path, tree)


def shard_t3_params(params: dict, mesh: DeviceMesh) -> dict:
    """Place T3 params on the mesh under the tensor-parallel rules (every
    process passes the same full tensors)."""
    return _map_with_path(lambda path, t: distribute_tensor(
        t, mesh, placements(mesh, t3_param_spec(path), t.shape)), params)


def replicate(tree, mesh: DeviceMesh):
    return _map_with_path(lambda _, t: distribute_tensor(
        t, mesh, [Replicate() for _ in mesh.mesh_dim_names]), tree)


def shard_batch(tree, mesh: DeviceMesh):
    """Shard each leaf's leading (batch) axis over "data" (None leaves
    stay None); every process passes the same full batch."""
    dp = mesh.size(AXES.index("data"))

    def place(_, t):
        if t is None:
            return None
        if t.shape[0] % dp:
            raise ValueError(f"a batch of {t.shape[0]} rows over {dp} data shards")
        return distribute_tensor(t, mesh, placements(mesh, ("data",), t.shape))
    return _map_with_path(place, tree)


def local_rows(tree, mesh: DeviceMesh):
    """This process's rows of a full batch, as plain tensors: what
    `shard_batch` would place here (None leaves stay None)."""
    dp, r = mesh.size(AXES.index("data")), mesh.get_local_rank("data")

    def rows(_, t):
        if t is None:
            return None
        if t.shape[0] % dp:
            raise ValueError(f"a batch of {t.shape[0]} rows over {dp} data shards")
        return t.chunk(dp)[r]
    return _map_with_path(rows, tree)


def local_replicas(params, mesh: DeviceMesh):
    """Replicated DTensor params as this process's plain copies, for a loss
    over its own rows (`local_rows`): each copy's gradient flows back to its
    DTensor as this process's partial sum over "data", which is summed over
    the processes when the optimizer reads it. No op of the loss then goes
    through DTensor's dispatch (torch 2.11 has no rule for a convolution of
    a sharded input)."""
    grad_pl = [Partial() if name == "data" and mesh.size(i) > 1 else Replicate()
               for i, name in enumerate(mesh.mesh_dim_names)]
    return _map_with_path(lambda _, t: t.to_local(grad_placements=grad_pl), params)
