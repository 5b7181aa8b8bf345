"""Training steps for T3 and the S3Gen flow, and their sharded forms over a
(data, model) DTensor mesh (the counterpart of
chatterbox_tpu/parallel/train.py).

The optimizer is `torch.optim.AdamW` (betas 0.9 / 0.999, eps 1e-8 outside
the square root, decoupled decay lr * wd * p, bias correction from step 1:
optax.adamw's update) on every leaf, around which this module copies
optax's arithmetic by hand:
  * the learning rate is optax.warmup_cosine_decay_schedule's curve
    (linear from 0 over the warm-up, then cosine to 0 at total_steps), read
    at the count of updates made before this one, so with a warm-up the
    first update has lr 0;
  * gradients are clipped as optax.clip_by_global_norm clips them: each
    scaled by the bound over the global norm of all leaves when the norm
    reaches the bound, else left as it is (torch's clip_grad_norm_ adds
    1e-6 to the norm); the factor stays on the device, so no host read
    comes between the backward pass and the update;
  * a leaf the loss does not reach gets a zero gradient, so it still
    decays and its moments still age, as in optax.
The T3 step runs on DTensors, whose dispatch inserts the tensor-parallel
collectives, with the attention on each process's own rows and heads
(`local_attention`); the flow's data-parallel step runs on each process's
rows and its plain parameter copies, and sums the loss's terms over "data"
itself.
A step runs the loss forward and backward, then one update in place: the
state's tensors are reused, as the JAX package donates its state.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import implicit_replication

from ..models.s3gen.flow import (TOKEN_MEL_RATIO, FlowDims, FlowDraws, draw_flow_noise,
                                 flow_compute_loss, flow_init, flow_loss_terms)
from ..models.t3 import backbone as bb
from ..models.t3 import model as t3m
from ..models.t3.config import T3Config
from ..nn import core as nn
from ..utils.dtensor import full, local
from .mesh import AXES, local_replicas, local_rows, replicate, shard_batch, shard_t3_params


def leaves(tree) -> list:
    """The tensors of a parameter tree, in its key order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


class TrainState:
    """The parameters (a tree of leaf tensors that require grad), the AdamW
    over their local tensors (`locals`: a DTensor's shard on this process,
    a plain tensor itself, in the tree's leaf order), the number of
    processes that hold each local shard (`copies`), and `step`, the number
    of updates made. AdamW's state is keyed by the local tensors. `copies`
    is None when no parameter is a DTensor."""

    def __init__(self, params: dict, adamw: torch.optim.AdamW, locals_: list,
                 copies: Optional[list], step: int = 0):
        self.params, self.adamw, self.step = params, adamw, step
        self.locals, self.copies = locals_, copies


def _copies(p: torch.Tensor) -> int:
    if not isinstance(p, DTensor):
        return 1
    return math.prod(p.device_mesh.size(i) for i, pl in enumerate(p.placements)
                     if isinstance(pl, Replicate))


class Optimizer:
    """AdamW with optax's schedule and global-norm clipping (see the module
    docstring). `init(params)` starts a TrainState; `update(state)` makes
    one update from the gradients the last backward pass left. AdamW runs
    on the local tensors (its element-wise update is the same on a shard),
    so its multi-tensor kernels see plain tensors."""

    def __init__(self, lr: float, warmup_steps: int, total_steps: int,
                 weight_decay: float, clip_norm: float):
        self.lr, self.warmup_steps, self.total_steps = lr, warmup_steps, total_steps
        self.weight_decay, self.clip_norm = weight_decay, clip_norm

    def schedule(self, count: int) -> float:
        """The learning rate of the update made after `count` updates, in
        float32 as optax computes it."""
        if not (self.warmup_steps or self.total_steps):
            return self.lr
        f32 = np.float32
        warm = max(self.warmup_steps, 1)
        decay = max(self.total_steps, self.warmup_steps + 1) - warm
        if count < warm:
            frac = f32(1) - f32(min(max(count, 0), warm)) / f32(warm)
            return float(f32(-self.lr) * frac + f32(self.lr))
        c = f32(min(count - warm, decay))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(decay)))
        return float(f32(self.lr) * cosine)

    @torch.no_grad()
    def init(self, params: dict) -> TrainState:
        ps = leaves(params)
        for p in ps:
            p.requires_grad_(True)
        locals_ = [local(p) for p in ps]
        adamw = torch.optim.AdamW(locals_, lr=self.schedule(0), betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=self.weight_decay)
        sharded = any(isinstance(p, DTensor) for p in ps)
        return TrainState(params, adamw, locals_, [_copies(p) for p in ps] if sharded else None)

    @torch.no_grad()
    def update(self, state: TrainState) -> None:
        for p, lp in zip(leaves(state.params), state.locals):
            g = p.grad
            if g is None:
                g = torch.zeros_like(lp)
            elif isinstance(g, DTensor):
                if g.placements != p.placements:
                    g = g.redistribute(p.device_mesh, p.placements)
                g = g.to_local()
            p.grad = None
            lp.grad = g
        if self.clip_norm:
            grads = [lp.grad for lp in state.locals]
            norm = global_norm(grads, state.copies)
            torch._foreach_mul_(grads, self.clip_norm / norm.clamp(min=self.clip_norm))
        for group in state.adamw.param_groups:
            group["lr"] = self.schedule(state.step)
        state.adamw.step()
        state.adamw.zero_grad(set_to_none=True)
        state.step += 1


def make_optimizer(lr: float = 1e-4, *, warmup_steps: int = 0, total_steps: int = 0,
                   weight_decay: float = 0.01, clip_norm: float = 0.0) -> Optimizer:
    """AdamW, with a linear-warmup + cosine-decay schedule when warmup_steps
    or total_steps is set (else the constant lr), and global-norm gradient
    clipping when clip_norm is set."""
    return Optimizer(lr, warmup_steps, total_steps, weight_decay, clip_norm)


def global_norm(grads: list, copies: Optional[list] = None) -> torch.Tensor:
    """sqrt of the sum of every element's square over all the tensors
    (float32, on their device). With `copies` (the local shards of
    DTensors, and the number of processes that hold each), each tensor's
    sum is divided by its copies and the total summed over the world in
    one all-reduce."""
    sq = torch.stack(torch._foreach_norm([g.float() for g in grads])) ** 2
    if copies is None:
        return sq.sum().sqrt()
    total = (sq / torch.tensor(copies, dtype=sq.dtype, device=sq.device)).sum()
    if dist.get_world_size() > 1:
        dist.all_reduce(total)
    return total.sqrt()


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def local_attention(q, k, v, mask):
    """`backbone_train`'s attention over DTensors: each process attends
    over its own rows and heads (q's placements, with any shard of the
    sequence or head_dim axes gathered, taken by q, k and v) and the result
    keeps them. Rows and heads attend independently, so no collective runs,
    and DTensor's propagation through the batched products (which torch
    2.11 refuses in the backward for a batch and heads both sharded) is
    avoided. Plain tensors go to `train_attention` as they are."""
    if not isinstance(q, DTensor):
        return bb.train_attention(q, k, v, mask)
    mesh = q.device_mesh
    pl = tuple(p if not p.is_shard() or p.dim < 2 else Replicate() for p in q.placements)
    q, k, v = (t.redistribute(mesh, pl) for t in (q, k, v))
    out = bb.train_attention(q.to_local(), k.to_local(), v.to_local(), mask)
    return DTensor.from_local(out, mesh, pl, run_check=False)


def t3_train_step(state: TrainState, hp: T3Config, optimizer: Optimizer,
                  cond: t3m.T3CondTensors, text_tokens: torch.Tensor,
                  text_lens: torch.Tensor, speech_tokens: torch.Tensor,
                  speech_lens: torch.Tensor):
    """One AdamW update on loss_text + loss_speech, each layer recomputed
    in the backward pass; plain tensors, or DTensors on a mesh. Returns
    (state, {"loss_text", "loss_speech"}), the losses before the update as
    0-d tensors."""
    with implicit_replication():
        lt, ls = t3m.t3_loss(state.params, hp, cond, text_tokens, text_lens,
                             speech_tokens, speech_lens, remat=True, attn=local_attention)
        (lt + ls).backward()
    optimizer.update(state)
    return state, {"loss_text": full(lt).detach(), "loss_speech": full(ls).detach()}


def flow_train_step(state: TrainState, optimizer: Optimizer,
                    generator: Optional[torch.Generator], token, token_len, feat, feat_len,
                    embedding, dims: FlowDims, remat: bool = True, draws=None):
    """One AdamW update on the masked CFM loss (`flow_compute_loss`, its
    random numbers from `generator` or `draws`), on plain tensors. Returns
    (state, {"loss_cfm"})."""
    loss = flow_compute_loss(state.params, generator, token=token, token_len=token_len,
                             feat=feat, feat_len=feat_len, embedding=embedding,
                             dims=dims, remat=remat, draws=draws)
    loss.backward()
    optimizer.update(state)
    return state, {"loss_cfm": loss.detach()}


# ---------------------------------------------------------------------------
# sharded steps over a (data, model) mesh
# ---------------------------------------------------------------------------

def build_sharded_train_step(hp: T3Config, mesh, lr: float = 1e-4, **opt_kw):
    """Returns (step, init_state): step(state, cond, text, text_lens,
    speech, speech_lens) takes full batches on every process, shards them
    over "data" and updates the state in place; init_state(seed) draws T3
    params (`t3_init` on the mesh's device type) and shards them by the
    tensor-parallel rules."""
    optimizer = make_optimizer(lr, **opt_kw)

    def step(state, cond, text_tokens, text_lens, speech_tokens, speech_lens):
        cond, text_tokens, text_lens, speech_tokens, speech_lens = shard_batch(
            (cond, text_tokens, text_lens, speech_tokens, speech_lens), mesh)
        return t3_train_step(state, hp, optimizer, cond, text_tokens, text_lens,
                             speech_tokens, speech_lens)

    def init_state(seed: int = 0) -> TrainState:
        params = t3m.t3_init(hp, seed=seed, device=mesh.device_type)
        return optimizer.init(shard_t3_params(params, mesh))

    step.optimizer = optimizer
    return step, init_state


def build_sharded_flow_train_step(dims: FlowDims, mesh, lr: float = 1e-4,
                                  remat: bool = True, **opt_kw):
    """The flow's data-parallel step: params replicated over the mesh, the
    batch and its random numbers split over "data". Returns (step,
    init_state): step(state, generator, token, token_len, feat, feat_len,
    embedding, draws=None) takes full batches on every process and draws
    the whole batch's FlowDraws from `generator` (seeded alike on each)
    unless `draws` gives them; each process computes the loss's terms on
    its rows with its own parameter copies (`local_replicas`), the frame
    count is summed over "data", and the gradients are summed when the
    optimizer reads them. init_state(seed, meanflow=False) draws flow
    params (the CFM flow by default, as the JAX package trains)."""
    optimizer = make_optimizer(lr, **opt_kw)
    data = mesh.get_group(AXES.index("data")) if mesh.size(AXES.index("data")) > 1 else None

    def step(state, generator, token, token_len, feat, feat_len, embedding, draws=None):
        if draws is None:
            draws = draw_flow_noise(generator, token.shape[0], TOKEN_MEL_RATIO * token.shape[1])
        draws = FlowDraws(*(d.to(token.device) for d in draws))
        token, token_len, feat, feat_len, embedding, draws = local_rows(
            (token, token_len, feat, feat_len, embedding, draws), mesh)
        num, count = flow_loss_terms(local_replicas(state.params, mesh), None, token=token,
                                     token_len=token_len, feat=feat, feat_len=feat_len,
                                     embedding=embedding, dims=dims, remat=remat, draws=draws)
        count = count.detach()
        if data is not None:
            dist.all_reduce(count, group=data)
        loss = (num / (count + 1e-8)).float()
        loss.backward()
        optimizer.update(state)
        loss = loss.detach()
        if data is not None:
            dist.all_reduce(loss, group=data)
        return state, {"loss_cfm": loss}

    def init_state(seed: int = 0, meanflow: bool = False) -> TrainState:
        params = flow_init(nn.Init(seed, mesh.device_type), meanflow=meanflow, dims=dims)
        return optimizer.init(replicate(params, mesh))

    step.optimizer = optimizer
    return step, init_state
