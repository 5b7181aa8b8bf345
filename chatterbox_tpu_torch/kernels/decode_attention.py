"""Single-query decode attention over the KV cache: the kernels and their
plain versions.

Three wrappers keep the signatures of chatterbox_tpu/ops/pallas_attention.py:

  decode_attention_streamed(q, k, v, cur_len, lo=None)                 B3
      bf16 cache, keys at lo[b] <= pos <= cur_len[b]; T % TT == 0
  decode_attention_streamed_int8(q, k_q, k_s, v_q, v_s, cur_len, lo=None)
      int8 cache with a bf16 scale per (row, head, position); K's scale
      multiplies the scores, V's the softmax weights       B4; T % TT == 0
  decode_attention(q, k, v, cur_len)                                   B7
      keys at pos <= cur_len[b], any cache length

q is (B, H, 1, D) bf16 or f32 and the result has q's type and shape; k, v
are (B, H, T, D) bf16 (int8 for B4); k_s, v_s (B, H, T) bf16; cur_len and
lo (B,) integers. The three share one CUDA template (csrc/decode_attention.cu;
B7 is it with lo = 0), but each keeps its own wrapper, plain version and
launch count.

The plain versions follow the Pallas arithmetic, not `nn.mha`: f32 scores
times 1/sqrt(D), keys outside the window masked, an online max / sum over
TT-key tiles in f32 with the new max clamped at -3e38, the weights not
rounded before the value product, the denominator clamped at 1e-30. B7's
plain version is the whole-slice softmax of `_decode_attn_kernel`.

Dispatch: a CPU tensor takes the plain version, a CUDA tensor launches the
kernel, and anything else raises. `launches` counts the kernel launches of
each wrapper.

Precondition of the windowed kernels (as in the JAX package): lo[b] <=
cur_len[b]; an empty window gives 0. `check_window` checks it on the host,
from host values, where an engine builds lo and cur_len.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .fused_layer import _check, _check_device

launches = {"decode_attention_streamed": 0, "decode_attention_streamed_int8": 0,
            "decode_attention": 0}

TT = 256                       # cache tile of the streamed kernels
HEAD_DIMS = (32, 64, 128)      # head widths the CUDA template is built for
M_FLOOR = -3.0e38              # the Pallas kernels' clamp of the running max

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        from .build import load
        lib = load("decode_attention")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.decode_attention_launch.argtypes = [P, I, P, P, I, P, P, P, P, P,
                                                I, I, I, I, P]
        lib.decode_attention_launch.restype = I
        _lib = lib
    return _lib


def check_window(lo, cur_len) -> None:
    """Raise unless lo[b] <= cur_len[b] for every row. lo is a sequence of
    host ints, cur_len a host int (shared) or a sequence of them."""
    lo = [int(x) for x in lo]
    cur = ([int(cur_len)] * len(lo) if isinstance(cur_len, int)
           else [int(x) for x in cur_len])
    bad = [(b, l, c) for b, (l, c) in enumerate(zip(lo, cur)) if l > c]
    if bad:
        raise ValueError(f"empty attention window (lo > cur_len) in rows "
                         f"{[b for b, _, _ in bad]}: {bad}")


# ---------------------------------------------------------------------------
# plain versions (the arithmetic of the Pallas kernels, in PyTorch)
# ---------------------------------------------------------------------------

def _flash_plain(q, k, v, cur_len, lo, k_s=None, v_s=None):
    B, H, _, D = q.shape
    T = k.shape[2]
    qf = q[:, :, 0].float()
    scale = 1.0 / math.sqrt(D)
    cur = cur_len.to(q.device).long()[:, None, None]
    first = (torch.zeros_like(cur) if lo is None
             else lo.to(q.device).long()[:, None, None])
    m = torch.full((B, H, 1), -math.inf, device=q.device)
    l = torch.zeros((B, H, 1), device=q.device)
    acc = torch.zeros((B, H, D), device=q.device)
    for t0 in range(0, T, TT):
        sl = slice(t0, t0 + TT)
        s = torch.einsum("bhtd,bhd->bht", k[:, :, sl].float(), qf) * scale
        if k_s is not None:
            s = s * k_s[:, :, sl].float()
        pos = torch.arange(t0, t0 + s.shape[-1], device=q.device)
        valid = (pos >= first) & (pos <= cur)
        s = torch.where(valid, s, -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True)).clamp(min=M_FLOOR)
        alpha = torch.exp(m - m_new)
        p = torch.where(valid, torch.exp(s - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        if v_s is not None:
            p = p * v_s[:, :, sl].float()
        acc = acc * alpha + torch.einsum("bht,bhtd->bhd", p, v[:, :, sl].float())
        m = m_new
    return (acc / l.clamp(min=1e-30)).to(q.dtype)[:, :, None]


def decode_attention_streamed_plain(q, k, v, cur_len, lo=None):
    return _flash_plain(q, k, v, cur_len, lo)


def decode_attention_streamed_int8_plain(q, k_q, k_s, v_q, v_s, cur_len, lo=None):
    return _flash_plain(q, k_q, v_q, cur_len, lo, k_s, v_s)


def decode_attention_plain(q, k, v, cur_len):
    T, D = k.shape[2], q.shape[-1]
    s = torch.einsum("bhd,bhtd->bht", q[:, :, 0].float(), k.float()) * (1.0 / math.sqrt(D))
    valid = torch.arange(T, device=q.device) <= cur_len.to(q.device).long()[:, None, None]
    s = torch.where(valid, s, torch.finfo(torch.float32).min)
    p = torch.where(valid, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    p = p / p.sum(-1, keepdim=True)
    return torch.einsum("bht,bhtd->bhd", p, v.float()).to(q.dtype)[:, :, None]


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

_Q = (torch.bfloat16, torch.float32)
_BF16 = (torch.bfloat16,)
_I8 = (torch.int8,)
_INT = (torch.int32,)


def _launch(name, q, k, v, cur_len, lo, k_s=None, v_s=None, tiled=True):
    B, H, one, D = q.shape
    T = k.shape[2]
    if one != 1:
        raise ValueError(f"{name}: one query per row, got {one}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {D} not in {HEAD_DIMS}")
    if tiled and T % TT:
        raise ValueError(f"{name}: cache length {T} not a multiple of {TT}")
    dev = q.device
    int8 = k_s is not None
    _check("q", q, (B, H, 1, D), _Q, dev)
    for n, t in (("k", k), ("v", v)):
        _check(n, t, (B, H, T, D), _I8 if int8 else _BF16, dev)
    if int8:
        for n, t in (("k_s", k_s), ("v_s", v_s)):
            _check(n, t, (B, H, T), _BF16, dev)
    cur_len = cur_len.to(device=dev, dtype=torch.int32).contiguous()
    _check("cur_len", cur_len, (B,), _INT, dev)
    if lo is not None:
        lo = lo.to(device=dev, dtype=torch.int32).contiguous()
        _check("lo", lo, (B,), _INT, dev)
    out = torch.empty_like(q)
    err = _kernel().decode_attention_launch(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k.data_ptr(), v.data_ptr(),
        int(int8), k_s.data_ptr() if int8 else None,
        v_s.data_ptr() if int8 else None, cur_len.data_ptr(),
        None if lo is None else lo.data_ptr(), out.data_ptr(), B, H, T, D,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launches[name] += 1
    return out


def decode_attention_streamed(q, k, v, cur_len, lo=None):
    """B3: (B, H, 1, D) attention of q over the bf16 cache k, v (B, H, T, D),
    T % TT == 0, keys at lo[b] <= pos <= cur_len[b] (lo defaults to 0)."""
    if not _check_device(q):
        return decode_attention_streamed_plain(q, k, v, cur_len, lo)
    return _launch("decode_attention_streamed", q, k, v, cur_len, lo)


def decode_attention_streamed_int8(q, k_q, k_s, v_q, v_s, cur_len, lo=None):
    """B4: as B3 over the int8 cache k_q, v_q (B, H, T, D) with scales k_s,
    v_s (B, H, T) bf16."""
    if not _check_device(q):
        return decode_attention_streamed_int8_plain(q, k_q, k_s, v_q, v_s, cur_len, lo)
    return _launch("decode_attention_streamed_int8", q, k_q, v_q, cur_len, lo, k_s, v_s)


def decode_attention(q, k, v, cur_len):
    """B7: (B, H, 1, D) attention of q over the bf16 cache k, v (B, H, T, D),
    any T, keys at pos <= cur_len[b]."""
    if not _check_device(q):
        return decode_attention_plain(q, k, v, cur_len)
    return _launch("decode_attention", q, k, v, cur_len, None, tiled=False)
