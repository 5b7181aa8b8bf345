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
lo (B,) integers. The three share one CUDA kernel (csrc/decode_attention.cu
`split_decode_kernel`, templated over the cache type; B7 is B3's with lo =
0): each (row, head) window split over `split_count(B, H, T)` blocks of a
thread-block cluster (`split_count_int8` for B4), chosen from the cache
shape alone so that the launch does not depend on cur_len. Each keeps its
own wrapper, plain version and launch count.

The plain versions follow the Pallas arithmetic, not `nn.mha`: f32 scores
times 1/sqrt(D), keys outside the window masked, an online max / sum over
TT-key tiles in f32 with the new max clamped at -3e38, the weights not
rounded before the value product, the denominator clamped at 1e-30. B7's
plain version is the whole-slice softmax of `_decode_attn_kernel`.

`split_window_plain` is the split kernel's arithmetic in PyTorch (each
split's max, sum and accumulator, then their merge; for the int8 cache its
chunks on multiples of 8 keys), for the tests; the CPU route keeps the plain
versions above.

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

from .fused_layer import _check, _check_device, count_launch

launches = {"decode_attention_streamed": 0, "decode_attention_streamed_int8": 0,
            "decode_attention": 0}

TT = 256                       # cache tile of the streamed kernels
HEAD_DIMS = (32, 64, 128)      # head widths the CUDA kernels are built for
M_FLOOR = -3.0e38              # the Pallas kernels' clamp of the running max
MAX_SPLITS = 16                # the largest cluster (above 8: non-portable)
SPLIT_CAP = 8                  # split_count's limit: the portable cluster size
SPLIT_KEYS = 80                # least keys split_count gives a split of a full cache
SPLIT_KEYS_INT8 = 160          # the same for the int8 cache (split_count_int8)
SPLIT_CAP_INT8 = 4             # split_count_int8's limit
SPLIT_BLOCKS = 256             # split_count stops doubling at this many blocks
SPLIT_BLOCKS_INT8 = 128        # split_count_int8 stops doubling at this many blocks

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        from .build import load
        lib = load("decode_attention")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.split_decode_launch.argtypes = [P, I, P, P, P, P, P, P, P, I, I, I, I, I, P]
        lib.split_decode_launch.restype = I
        _lib = lib
    return _lib


def split_count(B: int, H: int, T: int) -> int:
    """S, the blocks one (row, head) window is split over, from the cache
    shape alone (never from cur_len): doubled from 1 while the grid has
    fewer than SPLIT_BLOCKS blocks and a full cache would still give each
    split at least SPLIT_KEYS keys, up to SPLIT_CAP. The constants come from
    chip_smoke.py's sweep of S on an H100 (PERF.md): 8 at Turbo's
    single stream (16 heads, 768 keys), 4 at the 520M pair (512), 2 at
    eight batched rows."""
    return _splits(B, H, T, SPLIT_KEYS)


def split_count_int8(B: int, H: int, T: int) -> int:
    """S of the int8 cache (B4), as split_count with SPLIT_KEYS_INT8 keys,
    SPLIT_BLOCKS_INT8 blocks and up to SPLIT_CAP_INT8: an int8 key is half
    the bytes, and chip_smoke.py's sweeps of B4 on an H100 (PERF.md) found 4
    splits best at Turbo's single stream (768 and 1536 keys), 2 at the 520M
    pair and 1 at eight batched rows."""
    return _splits(B, H, T, SPLIT_KEYS_INT8, SPLIT_CAP_INT8, SPLIT_BLOCKS_INT8)


def _splits(B, H, T, keys, cap=SPLIT_CAP, blocks=SPLIT_BLOCKS):
    s = 1
    while s < cap and B * H * s < blocks and T >= 2 * s * keys:
        s *= 2
    return s


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


INT8_ALIGN = 8                 # keys the int8 kernel's chunks start on (16-byte scale copies)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def split_window_plain(q, k, v, cur_len, lo, splits, k_s=None, v_s=None):
    """The split kernel's arithmetic at `splits` blocks a window, in
    PyTorch (for the tests): the window [first, last] = [lo[b], min(cur_len[b],
    T - 1)] (lo None: from 0) cut into `splits` chunks of ceil(window /
    splits) keys from base = first, each chunk's max m, sum l and accumulator
    acc over its keys in f32, then the merge: sum_s acc_s e^(m_s - m) /
    max(sum_s l_s e^(m_s - m), 1e-30), an empty chunk weighing nothing.
    With k_s, v_s (B4's int8 cache): base is first rounded down to a
    multiple of INT8_ALIGN keys and the chunk rounded up to one (the keys
    below first masked), each score times K's scale, l over the weights and
    acc over the weights times V's scale. Reads cur_len and lo on the
    host."""
    B, H, _, D = q.shape
    T = k.shape[2]
    align = 1 if k_s is None else INT8_ALIGN
    s_all = torch.einsum("bhtd,bhd->bht", k.float(), q[:, :, 0].float()) * (1.0 / math.sqrt(D))
    if k_s is not None:
        s_all = s_all * k_s.float()
    out = torch.zeros((B, H, D), device=q.device)
    for b in range(B):
        first = 0 if lo is None else max(int(lo[b]), 0)
        last = min(int(cur_len[b]), T - 1)
        base = first // align * align
        chunk = _ceil(_ceil(max(last - base + 1, 0), splits), align) * align
        ms, ls, accs = [], [], []
        for s in range(splits):
            a = max(base + s * chunk, first)
            e = min(base + (s + 1) * chunk, last + 1)
            if e <= a:
                continue                   # an empty chunk weighs nothing
            sc = s_all[b, :, a:e]
            m = sc.amax(-1)
            p = torch.exp(sc - m[:, None])
            ms.append(m)
            ls.append(p.sum(-1))
            if v_s is not None:
                p = p * v_s[b, :, a:e].float()
            accs.append(torch.einsum("ht,htd->hd", p, v[b, :, a:e].float()))
        if not ms:
            continue                       # an empty window gives 0
        m_all = torch.stack(ms)
        c = torch.exp(m_all - m_all.amax(0))
        den = (torch.stack(ls) * c).sum(0)
        out[b] = (torch.stack(accs) * c[..., None]).sum(0) / den.clamp(min=1e-30)[:, None]
    return out.to(q.dtype)[:, :, None]


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

_Q = (torch.bfloat16, torch.float32)
_BF16 = (torch.bfloat16,)
_I8 = (torch.int8,)
_INT = (torch.int32,)


def _operands(name, q, k, v, cur_len, lo, k_s=None, v_s=None, tiled=True):
    """Check what the kernels take; returns (cur_len, lo) as int32 on q's
    device. The rows of K and V are D * 2 (bf16) or D (int8) bytes, whole
    multiples of 16 for D in HEAD_DIMS, so with 16-byte aligned tensors every
    chunk and piece a kernel copies starts 16-byte aligned. So do the int8
    cache's scale rows (contiguous, 16-byte aligned): its chunks start on
    multiples of INT8_ALIGN keys, and each piece's scale copy, rounded up to
    INT8_ALIGN keys, stays inside T (a multiple of TT)."""
    B, H, one, D = q.shape
    T = k.shape[2]
    if one != 1:
        raise ValueError(f"{name}: one query per row, got {one}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {D} not in {HEAD_DIMS}")
    if tiled and T % TT:
        raise ValueError(f"{name}: cache length {T} not a multiple of {TT}")
    if max(B, H) > 65535:
        raise ValueError(f"{name}: {B} rows x {H} heads exceed the grid")
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
    return cur_len, lo


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _launch_split(name, q, k, v, cur_len, lo, splits=None, tiled=True, k_s=None, v_s=None):
    B, H, _, D = q.shape
    T = k.shape[2]
    cur_len, lo = _operands(name, q, k, v, cur_len, lo, k_s, v_s, tiled=tiled)
    S = (split_count if k_s is None else split_count_int8)(B, H, T) if splits is None else splits
    if not 1 <= S <= MAX_SPLITS:
        raise ValueError(f"{name}: {S} splits, the kernel takes 1..{MAX_SPLITS}")
    out = torch.empty_like(q)
    err = _kernel().split_decode_launch(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k.data_ptr(), v.data_ptr(),
        _ptr(k_s), _ptr(v_s), cur_len.data_ptr(), _ptr(lo), out.data_ptr(), B, H, T, D, S,
        _stream(q.device))
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    count_launch(launches, name)
    return out


def decode_attention_streamed(q, k, v, cur_len, lo=None):
    """B3: (B, H, 1, D) attention of q over the bf16 cache k, v (B, H, T, D),
    T % TT == 0, keys at lo[b] <= pos <= cur_len[b] (lo defaults to 0)."""
    if not _check_device(q):
        return decode_attention_streamed_plain(q, k, v, cur_len, lo)
    return _launch_split("decode_attention_streamed", q, k, v, cur_len, lo)


def decode_attention_streamed_split(q, k, v, cur_len, lo, splits):
    """B3's kernel (CUDA tensors only) at a given split count, for timing
    split_count's choice; counts as a B3 launch."""
    if not _check_device(q):
        raise ValueError("decode_attention_streamed_split launches the kernel: CUDA tensors only")
    return _launch_split("decode_attention_streamed", q, k, v, cur_len, lo, splits)


def decode_attention_streamed_int8(q, k_q, k_s, v_q, v_s, cur_len, lo=None):
    """B4: as B3 over the int8 cache k_q, v_q (B, H, T, D) with scales k_s,
    v_s (B, H, T) bf16."""
    if not _check_device(q):
        return decode_attention_streamed_int8_plain(q, k_q, k_s, v_q, v_s, cur_len, lo)
    return _launch_split("decode_attention_streamed_int8", q, k_q, v_q, cur_len, lo,
                         k_s=k_s, v_s=v_s)


def decode_attention_streamed_int8_split(q, k_q, k_s, v_q, v_s, cur_len, lo, splits):
    """B4's kernel (CUDA tensors only) at a given split count, for timing
    split_count_int8's choice; counts as a B4 launch."""
    if not _check_device(q):
        raise ValueError("decode_attention_streamed_int8_split launches the kernel: CUDA "
                         "tensors only")
    return _launch_split("decode_attention_streamed_int8", q, k_q, v_q, cur_len, lo, splits,
                         k_s=k_s, v_s=v_s)


def decode_attention(q, k, v, cur_len):
    """B7: (B, H, 1, D) attention of q over the bf16 cache k, v (B, H, T, D),
    any T, keys at pos <= cur_len[b]."""
    if not _check_device(q):
        return decode_attention_plain(q, k, v, cur_len)
    return _launch_split("decode_attention", q, k, v, cur_len, None, tiled=False)
