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

Serving under a mesh (the JAX package passes sharded params and inputs to
its engines; so does the port):
  * tensor-parallel decode: `t3_generate` over `shard_t3_params`; the
    projections stay DTensor ops, and each layer's attention runs on this
    process's heads as plain tensors (`HeadShards`) over a KV cache of
    those heads;
  * data-parallel batched decode: `t3_generate_batched` over `replicate`d
    params and a `shard_batch`ed request batch; each process decodes its
    own rows (`local_rows`) with plain copies of the params
    (`local_copies`), and the rows are gathered at the end
    (`gather_rows`).
"""
from __future__ import annotations

import os
import re
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

from ..utils.dtensor import full

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
    `shard_batch` would place here (None leaves stay None). A DTensor
    placed by `shard_batch` gives its local rows, any other DTensor the
    rows of its whole value."""
    def rows(_, t):
        if t is None:
            return None
        if isinstance(t, DTensor):
            if tuple(t.placements) == tuple(placements(mesh, ("data",), t.shape)):
                return t.to_local()
            t = t.full_tensor()
        lo, hi = row_range(t.shape[0], mesh)
        return t[lo:hi]
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


# ---------------------------------------------------------------------------
# decoding under a mesh
# ---------------------------------------------------------------------------

def tree_mesh(tree) -> Optional[DeviceMesh]:
    """The mesh of a tree's first leaf, None when it is a plain tensor: a
    tree is placed on a mesh whole (`shard_t3_params`, `replicate`) or not
    at all."""
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values() if isinstance(tree, dict) else tree), None)
    return tree.device_mesh if isinstance(tree, DTensor) else None


def local_heads(cfg, mesh: DeviceMesh) -> tuple:
    """(heads, KV heads) of a layer on each process when its projections
    are sharded over "model" (GPT-2's KV heads are its heads); refuses a
    mesh whose "model" size divides either count unevenly."""
    tp = mesh.size(AXES.index("model"))
    kv = cfg.num_heads if cfg.is_gpt else cfg.num_kv_heads
    if cfg.num_heads % tp or kv % tp:
        raise ValueError(f"a model axis of {tp} devices over {cfg.num_heads} heads "
                         f"and {kv} KV heads")
    return cfg.num_heads // tp, kv // tp


class HeadShards:
    """A decode layer's attention on this process's heads. `local(q, k, v)`
    takes the (B, H, t, hd) DTensors of a layer (replicated over "data")
    to plain tensors of this process's H / tp heads, by a local slice where
    an operand is replicated (GPT-2's q / k / v, split from its fused qkv);
    `join(attn)` takes the merged local heads (B, t, H / tp * hd) back to a
    DTensor sharded over "model", so that the row-parallel projection after
    it sums over the processes. `kv` is the local KV head count, the
    cache's."""

    def __init__(self, cfg, mesh: DeviceMesh):
        self.mesh = mesh
        self.kv = local_heads(cfg, mesh)[1]
        sharded = mesh.size(AXES.index("model")) > 1
        self._heads = tuple(Shard(1) if name == "model" and sharded else Replicate()
                            for name in mesh.mesh_dim_names)
        self._merged = tuple(Shard(2) if name == "model" and sharded else Replicate()
                             for name in mesh.mesh_dim_names)

    def local(self, q, k, v):
        return tuple(t.redistribute(self.mesh, self._heads).to_local() for t in (q, k, v))

    def join(self, attn: torch.Tensor):
        return DTensor.from_local(attn, self.mesh, self._merged, run_check=False)


def local_copies(tree):
    """Every DTensor leaf as its whole value, a plain tensor on this process
    (a replicated leaf is its local tensor; no collective runs)."""
    return _map_with_path(lambda _, t: full(t), tree)


def row_range(n: int, mesh: DeviceMesh) -> tuple:
    """[lo, hi): this process's rows of an n-row batch over "data"."""
    dp, r = mesh.size(AXES.index("data")), mesh.get_local_rank("data")
    if n % dp:
        raise ValueError(f"a batch of {n} rows over {dp} data shards")
    return r * n // dp, (r + 1) * n // dp


def gather_rows(t: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The inverse of `local_rows`: every process's rows of a plain tensor,
    all-gathered over "data" in the mesh's order, on every process."""
    i = AXES.index("data")
    if mesh.size(i) == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(mesh.size(i))]
    dist.all_gather(parts, t.contiguous(), group=mesh.get_group(i))
    return torch.cat(parts)


def same_everywhere(t: torch.Tensor) -> bool:
    """Whether a plain tensor holds the same values on every process of the
    world (one all-gather; every process gets the same answer)."""
    if dist.get_world_size() == 1:
        return True
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.contiguous())
    return all(torch.equal(p, parts[0]) for p in parts)
