"""The fused decode-layer kernels and their plain versions.

Six functions carry every fused decode step, two per layer:

GPT-2 (Turbo), int8 weights:
  ln_qkv_int8           out = (bf16(LN1(x)) @ Wqkv) * s + bias            (B, 3D)
  attnout_ln_mlp_int8   r = x + (bf16(a) @ Wo) * so + bo
                        h = bf16(gelu_new((bf16(LN2(r)) @ W1) * s1 + b1))
                        out = r + b2 + sum over hidden tiles t of
                              (h_t @ W2_t) * s2                            (B, D)
GPT-2 (Turbo), int4 weights ("int4_fused"; group scales per 256 rows):
  ln_qkv_int4           out = bias + bf16(LN1(x)) @ Wqkv                  (B, 3D)
  attnout_ln_mlp_int4   r = x + bf16(a) @ Wo + bo
                        out = r + b2 + bf16(gelu_new(b1 + bf16(LN2(r)) @ W1))
                                       @ W2                                (B, D)
llama (520M CFG), int8 weights:
  rms_qkv_int8          out = (bf16(RMSNorm(x) * g) @ [Wq|Wk|Wv]) * s      (B, N)
  attnout_rms_glu_int8  r = x + (bf16(a) @ Wo) * so;  y = bf16(RMSNorm(r) * g2)
                        h = bf16(silu((y @ Wg) * sg) * ((y @ Wu) * su))
                        out = r + sum over hidden tiles t of (h_t @ Wd_t) * sd
                                                                          (B, D)

They replace the Pallas TPU kernels of the same names in
chatterbox_tpu/ops/fused_layer.py; the CUDA sources are csrc/fused_layer.cu
(int8) and csrc/int4.cu (int4, beside B8 of kernels/int4_matmul.py). The
library of csrc/fused_layer.cu also holds B11 (kernels/fused_mlp.py).
Weights are stored OUT-MAJOR, the contraction contiguous (`*_t`), the
layout the CUDA kernels stream:
  * int8: (N, K) int8 with one scale per output column;
  * int4, row split (Wqkv, Wo, W2): (N, K/2) packed bytes, byte [n, r]
    holding W[r, n] in the low nibble and W[r + K/2, n] in the high one,
    and scales (N, K/2/256) for each half (`*_slo`, `*_shi`);
  * int4, column split (W1): (I/2, D) packed bytes, byte [c, r] holding
    W1[r, c] low and W1[r, c + I/2] high, scales (I/2, D/256) each.
Biases and norm parameters are (N,) float32; outputs are float32.

Each kernel call takes 1 to MAX_B = 16 rows (one request, a CFG pair, or
the batched engine's rows).

Dispatch: a CPU tensor takes the plain PyTorch version (`*_plain`), a CUDA
tensor launches the kernel, and anything else raises. `launches` counts the
kernel calls made by each wrapper (one per layer and step; each second-half
kernel is three CUDA launches on one stream). The CUDA kernels sum in other
orders than the Pallas grids; the `*_split_plain` versions spell those
orders out for the tensor-core kernels, and the tests hold them against the
Pallas kernels.
"""
from __future__ import annotations

import ctypes
import threading

import torch

launches = {"ln_qkv_int8": 0, "attnout_ln_mlp_int8": 0,
            "rms_qkv_int8": 0, "attnout_rms_glu_int8": 0,
            "ln_qkv_int4": 0, "attnout_ln_mlp_int4": 0}
_count_lock = threading.Lock()


def count_launch(counter: dict, name: str) -> None:
    """Count one launch of `name` in `counter` (under a lock: the serving
    loops launch kernels from their own thread)."""
    with _count_lock:
        counter[name] += 1


MAX_B = 16           # rows a kernel call takes (csrc: row instances 2-16)
K_STEP = 512         # contraction bytes a warp reads per iteration
SMEM_LIMIT = 227 * 1024   # dynamic shared memory a block opts in to
WARPS = 8
GROUP = 256          # contraction rows per int4 scale (INT4_GROUP)
QKV_COLS = 32        # output columns per block of the B1 / B5 kernel
# The tensor-core phases of B6, B2 and B11 (csrc/fused_layer.cu,
# tc_int8_kernel), tiled from chip_smoke.py's sweeps on an H100 (PERF.md):
# attn-out and down blocks own TC_COLS output columns; attn-out splits its
# contraction over the fewest blocks of a cluster that fit shared memory,
# down over the most (up to TC_MAX_SPLITS) that divide its hidden tiles;
# B6's norm + gate/up block owns GLU_UNITS hidden units (half as many where
# those do not fit), B2 / B11's norm + fc_in block the first of GELU_UNITS
# that divides I and fits; TC_PDL launches the phases after the first by
# programmatic dependent launch. B9 (csrc/int4.cu, B8's kernel with a
# LayerNorm) owns the first of QKV4_COLS output columns a block that divides
# N and fits, from its own sweep. B10's three phases (the same kernel) own
# the first of MLP4_ATTN_COLS, MLP4_FC_IN_COLS* (packed columns: two hidden
# units each; fewer at up to MLP4_FEW_ROWS rows, where the LayerNorm every
# block computes is cheap) and MLP4_DOWN_COLS that divide their width and
# fit; fc_out splits its packed rows over the fewest blocks (1, 2 or
# TC_MAX_SPLITS) that leave each at most MLP4_DOWN_SPAN rows and fit;
# MLP4_PDL launches the last two phases by programmatic dependent launch.
TC_COLS = 16
TC_MAX_SPLITS = 4
TC_CHUNK = 64        # contraction entries of one step of a warp
GLU_UNITS = 32
GELU_UNITS = (64, 32, 16)
TC_PDL = True
QKV4_COLS = (32, 16, 64)
MLP4_ATTN_COLS = (16, 32)
MLP4_FEW_ROWS = 4
MLP4_FC_IN_COLS_FEW, MLP4_FC_IN_COLS = (16, 32, 64), (32, 16, 64)
MLP4_DOWN_COLS = (16, 32)
MLP4_DOWN_SPAN = 512
MLP4_PDL = True

_lib = None
_int4_lib = None


def _kernels():
    global _lib
    if _lib is None:
        from .build import load
        lib = load("fused_layer")
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ln_qkv_int8_launch.argtypes = [P, I, P, P, P, P, P, P, I, I, I, F, P]
        lib.ln_qkv_int8_launch.restype = I
        lib.attnout_ln_mlp_int8_launch.argtypes = [
            P, P, I, P, P, P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, F, I, I, I, I, P]
        lib.attnout_ln_mlp_int8_launch.restype = I
        lib.rms_qkv_int8_launch.argtypes = [P, I, P, P, P, P, I, I, I, F, P]
        lib.rms_qkv_int8_launch.restype = I
        lib.norm_qkv_int8_smem.argtypes = [I, I, I]
        lib.norm_qkv_int8_smem.restype = ctypes.c_size_t
        lib.attnout_rms_glu_int8_launch.argtypes = [
            P, P, I, P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, F, I, I, I, I, P]
        lib.attnout_rms_glu_int8_launch.restype = I
        lib.fused_mlp_int8_launch.argtypes = [P, I, P, P, P, P, P, P, P, P, P, P,
                                              I, I, I, I, I, I, P]
        lib.fused_mlp_int8_launch.restype = I
        _lib = lib
    return _lib


def int4_kernels():
    """The library of csrc/int4.cu (B8, B9, B10), built at first use."""
    global _int4_lib
    if _int4_lib is None:
        from .build import load
        lib = load("int4")
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.matmul_int4_launch.argtypes = [P, I, P, P, P, P, I, I, I, I, I, I, P]
        lib.matmul_int4_launch.restype = I
        lib.ln_qkv_int4_launch.argtypes = [P, I, P, P, P, P, P, P, P, I, I, I, I, F, P]
        lib.ln_qkv_int4_launch.restype = I
        lib.attnout_ln_mlp_int4_launch.argtypes = [
            P, P, I, P, P, P, P, P, P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, F,
            I, I, I, I, I, P]
        lib.attnout_ln_mlp_int4_launch.restype = I
        _int4_lib = lib
    return _int4_lib


# ---------------------------------------------------------------------------
# plain versions (the arithmetic of the Pallas kernels, in PyTorch)
# ---------------------------------------------------------------------------

def _ln_bf16(x: torch.Tensor, g, b, eps: float) -> torch.Tensor:
    """LayerNorm in f32 (mean, then mean squared deviation), rounded to bf16
    and returned as f32 values."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * g + b
    return y.to(torch.bfloat16).float()


def _rms_bf16(x: torch.Tensor, g, eps: float) -> torch.Tensor:
    """RMSNorm in f32 times g, rounded to bf16 and returned as f32 values."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps) * g
    return y.to(torch.bfloat16).float()


def _dot_i8(x_f32: torch.Tensor, w_t: torch.Tensor) -> torch.Tensor:
    """(B, K) f32 @ (N, K) int8 out-major weight -> (B, N) f32 sums."""
    return x_f32 @ w_t.float().T


def _gelu_new_f32(u):
    c = 0.7978845608028654
    return 0.5 * u * (1.0 + torch.tanh(c * (u + 0.044715 * u * u * u)))


def ln_qkv_int8_plain(x, g, b, w_t, s, bias, eps: float):
    y = _ln_bf16(x, g, b, eps)
    return _dot_i8(y, w_t) * s + bias


def attnout_ln_mlp_int8_plain(a, xres, wo_t, so, bo, g2, be2, w1_t, s1, b1,
                              w2_t, s2, b2, eps: float, tw: int = 1024):
    a16 = a.to(torch.bfloat16).float()
    r = xres.float() + _dot_i8(a16, wo_t) * so + bo
    y2 = _ln_bf16(r, g2, be2, eps)
    u = _dot_i8(y2, w1_t) * s1 + b1
    h = _gelu_new_f32(u).to(torch.bfloat16).float()
    # W2's scale multiplies each hidden tile's partial sum, added onto r + b2
    # in order, as in the Pallas kernel's grid steps
    out = r + b2
    for j in range(0, h.shape[1], tw):
        out = out + _dot_i8(h[:, j:j + tw], w2_t[:, j:j + tw]) * s2
    return out


def rms_qkv_int8_plain(x, g, w_t, s, eps: float):
    return _dot_i8(_rms_bf16(x, g, eps), w_t) * s


def attnout_rms_glu_int8_plain(a, xres, wo_t, so, g2, wg_t, sg, wu_t, su,
                               wd_t, sd, eps: float, tw: int = 1024):
    a16 = a.to(torch.bfloat16).float()
    r = xres.float() + _dot_i8(a16, wo_t) * so
    y2 = _rms_bf16(r, g2, eps)
    ug = _dot_i8(y2, wg_t) * sg
    uu = _dot_i8(y2, wu_t) * su
    h = (ug * torch.sigmoid(ug) * uu).to(torch.bfloat16).float()
    out = r
    # Wd's scale multiplies each hidden tile's partial sum, as in the Pallas
    # kernel's grid steps
    for j in range(0, h.shape[1], tw):
        out = out + _dot_i8(h[:, j:j + tw], wd_t[:, j:j + tw]) * sd
    return out


def _warp_dot_i8(x_f32, w_t, k0: int, k1: int):
    """x[:, k0:k1] @ W[k0:k1] summed as a block of the tensor-core kernel
    sums it: WARPS contiguous runs of TC_CHUNK-wide chunks, added in warp
    order."""
    span = k1 - k0
    per_warp = -(-(span // TC_CHUNK) // WARPS) * TC_CHUNK
    out = torch.zeros((x_f32.shape[0], w_t.shape[0]))
    for w in range(WARPS):
        a, b = k0 + min(w * per_warp, span), k0 + min((w + 1) * per_warp, span)
        if a < b:
            out = out + _dot_i8(x_f32[:, a:b], w_t[:, a:b])
    return out


def attnout_rms_glu_int8_split_plain(a, xres, wo_t, so, g2, wg_t, sg, wu_t, su,
                                     wd_t, sd, eps: float, tw: int, attn_splits: int):
    """attnout_rms_glu_int8 summed in the CUDA kernel's order: attn-out's
    contraction cut over `attn_splits` blocks (the first number of
    glu_tiling), each block's sum over its warps (_warp_dot_i8), the
    blocks' sums added in order before the scale; gate and up each one
    block's sum; each tw-wide tile of down one block's sum over its warps,
    scaled and added onto r in tile order (the blocks a down slab is split
    over only decide which block sums which tile)."""
    D, I = a.shape[1], wg_t.shape[0]
    a16 = a.to(torch.bfloat16).float()
    span = D // attn_splits
    acc = torch.zeros((a.shape[0], D))
    for s in range(attn_splits):
        acc = acc + _warp_dot_i8(a16, wo_t, s * span, (s + 1) * span)
    r = xres.float() + acc * so
    y2 = _rms_bf16(r, g2, eps)
    ug = _warp_dot_i8(y2, wg_t, 0, D) * sg
    uu = _warp_dot_i8(y2, wu_t, 0, D) * su
    h = (ug * torch.sigmoid(ug) * uu).to(torch.bfloat16).float()
    out = r
    for j in range(0, I, tw):
        out = out + _warp_dot_i8(h, wd_t, j, j + tw) * sd
    return out


def attnout_ln_mlp_int8_split_plain(a, xres, wo_t, so, bo, g2, be2, w1_t, s1, b1,
                                    w2_t, s2, b2, eps: float, tw: int, attn_splits: int):
    """attnout_ln_mlp_int8 summed in the CUDA kernel's order, as B6's
    (attnout_rms_glu_int8_split_plain): attn-out's contraction cut over
    `attn_splits` blocks, their sums added in order before the scale, then
    bo; fc_in one block's sum over its warps; each tw-wide tile of fc_out
    one block's sum over its warps, scaled and added onto r + b2 in tile
    order."""
    D, I = a.shape[1], w1_t.shape[0]
    a16 = a.to(torch.bfloat16).float()
    span = D // attn_splits
    acc = torch.zeros((a.shape[0], D))
    for s in range(attn_splits):
        acc = acc + _warp_dot_i8(a16, wo_t, s * span, (s + 1) * span)
    r = xres.float() + acc * so + bo
    y2 = _ln_bf16(r, g2, be2, eps)
    h = _gelu_new_f32(_warp_dot_i8(y2, w1_t, 0, D) * s1 + b1).to(torch.bfloat16).float()
    out = r + b2
    for j in range(0, I, tw):
        out = out + _warp_dot_i8(h, w2_t, j, j + tw) * s2
    return out


def unpack_int4(w: torch.Tensor, dtype=torch.float32):
    """Nibble-packed int8 bytes -> (low, high) values in [-7, 7] as `dtype`,
    by int32 arithmetic as the Pallas kernels do (torch's int8 shifts wrap):
    low = ((b & 15) ^ 8) - 8, high = b >> 4 (arithmetic)."""
    w32 = w.to(torch.int32)
    return (((w32 & 15) ^ 8) - 8).to(dtype), (w32 >> 4).to(dtype)


def group_dots(x: torch.Tensor, w_t: torch.Tensor, s_t: torch.Tensor) -> torch.Tensor:
    """(G, B, N): x (B, K) f32 against the out-major weight values w_t
    (N, K), one f32 product per group of K / G contraction rows, each times
    that group's scales s_t[:, g] (s_t (N, G))."""
    N, K = w_t.shape
    G = s_t.shape[1]
    xg = x.reshape(x.shape[0], G, K // G).transpose(0, 1)
    wg = w_t.reshape(N, G, K // G).permute(1, 2, 0)
    return torch.bmm(xg, wg) * s_t.T.float()[:, None, :]


def row_split_dots(x: torch.Tensor, wp_t: torch.Tensor, slo_t, shi_t):
    """Row-split int4 product of x (B, K) f32 with the out-major packed
    weight wp_t (N, K/2): the scaled group products (G, B, N) of the low
    half (x[:, :K/2] with the low nibbles) and of the high half."""
    K2 = wp_t.shape[1]
    lo, hi = unpack_int4(wp_t)
    return group_dots(x[:, :K2], lo, slo_t), group_dots(x[:, K2:], hi, shi_t)


def ln_qkv_int4_plain(x, g, b, wp_t, slo_t, shi_t, bias, eps: float):
    """out = bias, then + (low + high) group by group, as the Pallas grid
    accumulates."""
    lo, hi = row_split_dots(_ln_bf16(x, g, b, eps), wp_t, slo_t, shi_t)
    out = bias.float().expand(x.shape[0], -1)
    for k in range(lo.shape[0]):
        out = out + (lo[k] + hi[k])
    return out


def int4_block_sum(xb, lo, hi, s_lo, s_hi, k0: int, k1: int, start, colsplit: bool = False):
    """start + the row-split int4 product over packed rows [k0, k1), summed
    as a block of B8 / B9 / B10's tensor-core kernel sums it: its WARPS
    warps take contiguous runs of TC_CHUNK-row chunks; a warp adds, for each
    256-row group its run meets, (x_lo @ lo) * s_lo + (x_hi @ hi) * s_hi over
    the rows of that group onto its running sum; the warps' sums are added
    onto `start` in warp order. xb (B, K) f32, lo / hi (K/2, N) nibble
    values, s_lo / s_hi (K/2/256, N). With `colsplit` (B10's fc_in) both
    nibbles meet the same rows of xb (B, K), lo / hi (K, N) and s_lo / s_hi
    (K/256, N), and the low and high products sum apart: start is the pair
    (low, high) and so is the result."""
    K2 = 0 if colsplit else lo.shape[0]
    span = k1 - k0
    per_warp = -(-(span // TC_CHUNK) // WARPS) * TC_CHUNK
    total = start
    for w in range(WARPS):
        a, b = k0 + min(w * per_warp, span), k0 + min((w + 1) * per_warp, span)
        run_lo = run_hi = torch.zeros_like(total[0] if colsplit else total)
        while a < b:
            g = a // GROUP
            e = min(b, (g + 1) * GROUP)
            lo_g = xb[:, a:e] @ lo[a:e] * s_lo[g]
            hi_g = xb[:, K2 + a:K2 + e] @ hi[a:e] * s_hi[g]
            if colsplit:
                run_lo, run_hi = run_lo + lo_g, run_hi + hi_g
            else:                          # the two halves' sum, then onto the run
                run_lo = run_lo + (lo_g + hi_g)
            a = e
        total = (total[0] + run_lo, total[1] + run_hi) if colsplit else total + run_lo
    return total


def ln_qkv_int4_split_plain(x, g, b, wp_t, slo_t, shi_t, bias, eps: float):
    """ln_qkv_int4 summed in the CUDA kernel's order (int4_block_sum over all
    the packed rows, onto the bias). The tiling (columns a block) and the
    row tiles change no sum."""
    lo, hi = unpack_int4(wp_t.T)
    return int4_block_sum(_ln_bf16(x, g, b, eps), lo, hi, slo_t.T, shi_t.T, 0, wp_t.shape[1],
                          bias.float().expand(x.shape[0], -1))


def attnout_ln_mlp_int4_plain(a, xres, wo_t, so_lo, so_hi, bo, g2, be2, w1c_t,
                              s1_lo, s1_hi, b1, w2_t, s2_lo, s2_hi, b2, eps: float):
    """The Pallas kernel's order: the attention projection's low and high
    halves added group by group; each hidden unit's sum starts at its bias;
    the output starts at r + b2 and takes W2's low and high halves group by
    group (the hidden tiles cover the groups in order)."""
    B = a.shape[0]
    lo, hi = row_split_dots(a.to(torch.bfloat16).float(), wo_t, so_lo, so_hi)
    acc = torch.zeros_like(lo[0])
    for k in range(lo.shape[0]):
        acc = acc + lo[k]
        acc = acc + hi[k]
    r = xres.float() + acc + bo
    y2 = _ln_bf16(r, g2, be2, eps)
    IH = w1c_t.shape[0]
    lo1, hi1 = unpack_int4(w1c_t)
    ua, ub = group_dots(y2, lo1, s1_lo), group_dots(y2, hi1, s1_hi)
    u = [b1[:IH].float().expand(B, -1), b1[IH:].float().expand(B, -1)]
    for k in range(ua.shape[0]):
        u = [u[0] + ua[k], u[1] + ub[k]]
    h = _gelu_new_f32(torch.cat(u, dim=-1)).to(torch.bfloat16).float()
    lo2, hi2 = row_split_dots(h, w2_t, s2_lo, s2_hi)
    out = r + b2
    for k in range(lo2.shape[0]):
        out = out + lo2[k]
        out = out + hi2[k]
    return out


def attnout_ln_mlp_int4_split_plain(a, xres, wo_t, so_lo, so_hi, bo, g2, be2, w1c_t,
                                    s1_lo, s1_hi, b1, w2_t, s2_lo, s2_hi, b2, eps: float,
                                    down_splits: int):
    """attnout_ln_mlp_int4 summed in the CUDA kernel's order (int4_block_sum
    for each phase): attn-out one block's sum over its warps, then r = (xres
    + sum) + bo; each packed column of fc_in one block's two sums (low and
    high nibbles) over its warps onto their units' biases; fc_out's packed
    rows cut over `down_splits` blocks, their sums added in order onto
    r + b2 (one block: its warps' sums onto r + b2). The columns a block
    owns change no sum."""
    B = a.shape[0]
    IH = w1c_t.shape[0]
    lo, hi = unpack_int4(wo_t.T)
    zeros = torch.zeros((B, wo_t.shape[0]))
    acc = int4_block_sum(a.to(torch.bfloat16).float(), lo, hi, so_lo.T, so_hi.T, 0,
                         wo_t.shape[1], zeros)
    r = (xres.float() + acc) + bo
    lo1, hi1 = unpack_int4(w1c_t.T)
    u = int4_block_sum(_ln_bf16(r, g2, be2, eps), lo1, hi1, s1_lo.T, s1_hi.T, 0,
                       w1c_t.shape[1], (b1[:IH].float().expand(B, -1),
                                        b1[IH:].float().expand(B, -1)), colsplit=True)
    h = _gelu_new_f32(torch.cat(u, dim=-1)).to(torch.bfloat16).float()
    lo2, hi2 = unpack_int4(w2_t.T)
    start = r + b2
    if down_splits == 1:
        return int4_block_sum(h, lo2, hi2, s2_lo.T, s2_hi.T, 0, IH, start)
    span = IH // down_splits
    for s in range(down_splits):
        start = start + int4_block_sum(h, lo2, hi2, s2_lo.T, s2_hi.T, s * span,
                                       (s + 1) * span, torch.zeros_like(start))
    return start


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(name, t, shape, dtypes, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


_ACT = (torch.bfloat16, torch.float32)
_F32 = (torch.float32,)
_I8 = (torch.int8,)


def _check_device(x):
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {x.device}")


def _shape_limits(B, K, what):
    if not 1 <= B <= MAX_B:
        raise ValueError(f"{what}: batch {B} outside 1..{MAX_B}")
    if K % K_STEP:
        raise ValueError(f"{what}: contraction {K} is not a multiple of {K_STEP}")


def norm_qkv_smem(B: int, D: int, rms: bool) -> int:
    """Shared memory bytes of one B1 / B5 block at B rows of width D, as the
    CUDA library computes them (builds it at first use)."""
    return _kernels().norm_qkv_int8_smem(B, D, int(rms))


def _qkv_limits(B, D, N, rms, what):
    _shape_limits(B, D, what)
    if N % QKV_COLS:
        raise ValueError(f"{what}: width {N} is not a multiple of {QKV_COLS}")
    if norm_qkv_smem(B, D, rms) > SMEM_LIMIT:
        raise ValueError(f"{what}: a block's shared memory exceeds {SMEM_LIMIT} bytes")


def tc_smem(B: int, cols: int, splits: int, K: int, tiles: int) -> int:
    """Shared memory bytes of one block of the tensor-core phases of B2, B6
    and B11 at B rows (csrc/fused_layer.cu, tc_smem): cols weight columns over K /
    splits contraction entries, the contraction cut in `tiles` tiles."""
    NB = 8 if B <= 8 else 16
    span = K // splits
    return 16 + cols * span + NB * (span + 8) * 2 + (WARPS + tiles) * NB * cols * 4


def _tc_splits(B, K, tiles, order):
    """The first split in `order` of a TC_ATTN_OUT / TC_DOWN column slab
    (contraction K cut in `tiles` tiles, or one tile a block where None)
    whose blocks take whole tiles of TC_CHUNK multiples and fit shared
    memory; None if none does."""
    for s in order:
        t = tiles or s
        if (t % s == 0 and K % t == 0 and (K // t) % TC_CHUNK == 0
                and tc_smem(B, TC_COLS, s, K, t) <= SMEM_LIMIT):
            return s
    return None


def _mlp_tiling(B, D, I, tiles, units, cols_per_unit, pdl):
    """(attn_splits, units, down_splits, pdl): attn-out split over the fewest
    blocks that fit, down over the most that divide its `tiles` (None: a
    tile a block), and the first hidden units a norm block in `units` that
    divide I and fit. None where no tiling fits."""
    splits = (1, 2, TC_MAX_SPLITS)
    attn = _tc_splits(B, D, None, splits)
    down = _tc_splits(B, I, tiles, splits[::-1])
    unit = next((u for u in units if I % u == 0
                 and tc_smem(B, cols_per_unit * u, 1, D, 1) <= SMEM_LIMIT), None)
    if None in (attn, unit, down):
        return None
    return attn, unit, down, pdl


def glu_tiling(B: int, D: int, I: int, tw: int):
    """(attn_splits, glu_units, down_splits, pdl) of B6 at B rows: the
    blocks an attn-out and a down column slab are split over, the hidden
    units a norm + gate/up block owns, and whether the last two phases go by
    programmatic dependent launch. None where no tiling fits."""
    return _mlp_tiling(B, D, I, I // tw, (GLU_UNITS, GLU_UNITS // 2), 2, TC_PDL)


def gelu_tiling(B: int, D: int, I: int, tw):
    """(attn_splits, gelu_units, down_splits, pdl) of B2 at B rows (tw its
    hidden tile), as glu_tiling's, the norm + fc_in block owning gelu_units
    hidden units; with tw None, of B11, whose down blocks each take a tile
    of I / down_splits units of their own (B11 has no attn-out). None where
    no tiling fits."""
    return _mlp_tiling(B, D, I, None if tw is None else I // tw, GELU_UNITS, 1, TC_PDL)


def tc_phases_limits(what, B, D, I, tiles, attn_splits, norm_cols, down_splits):
    """Raise ValueError unless the tensor-core phases of B2 / B6 / B11 take
    this tiling: attn-out (attn_splits None: none) and down split 1, 2 or
    TC_MAX_SPLITS ways, each block whole tiles of TC_CHUNK multiples, and
    every block (the norm phase's of norm_cols weight columns) within shared
    memory."""
    splits = (1, 2, TC_MAX_SPLITS)
    attn = attn_splits or 1
    if (attn not in splits or down_splits not in splits or tiles % down_splits
            or (D // attn) % TC_CHUNK or (I // tiles) % TC_CHUNK):
        raise ValueError(f"{what}: tiling ({attn_splits}, {down_splits} splits) does not "
                         f"fit D {D}, I {I}, {tiles} hidden tiles")
    smem = [tc_smem(B, norm_cols, 1, D, 1), tc_smem(B, TC_COLS, down_splits, I, tiles)]
    if attn_splits:
        smem.append(tc_smem(B, TC_COLS, attn, D, attn))
    if max(smem) > SMEM_LIMIT:
        raise ValueError(f"{what}: a block's shared memory exceeds {SMEM_LIMIT} bytes")


def int4_smem(cols: int, splits: int, K2: int, B: int = 8, ln: bool = False,
              colsplit: bool = False) -> int:
    """Shared memory bytes of one block of the int4 tensor-core kernel at B
    rows (csrc/int4.cu, int4_tc_smem): B8 or B10's row-split phases, with ln
    B9, with ln and colsplit B10's LN2 + fc_in; cols (packed) columns, K2
    packed rows split over `splits` blocks."""
    NB = 8 if B <= 8 else 16
    span = K2 // splits
    row = K2 if colsplit else 2 * K2
    return (16 + (2 * row * 4 if ln else 0) + 2 * cols * (K2 // GROUP) * 4 + cols * span
            + NB * ((1 if colsplit else 2) * span + 8) * 2
            + (WARPS + splits) * NB * (2 if colsplit else 1) * cols * 4)


def ln_qkv_int4_tiling(B: int, D: int, N: int):
    """Output columns a B9 block owns at B rows: the first of QKV4_COLS that
    divides N and fits shared memory; None if none does."""
    return next((c for c in QKV4_COLS if N % c == 0
                 and int4_smem(c, 1, D // 2, B, ln=True) <= SMEM_LIMIT), None)


def _mlp4_smem(B, D, IH, attn_cols, fc_in_cols, down_cols, down_splits):
    """Shared memory bytes of a block of each of B10's three phases."""
    return (int4_smem(attn_cols, 1, D // 2, B), int4_smem(fc_in_cols, 1, D, B, True, True),
            int4_smem(down_cols, down_splits, IH, B))


def int4_mlp_tiling(B: int, D: int, I: int):
    """(attn_cols, fc_in_cols, down_cols, down_splits, pdl) of B10 at B rows:
    the first of MLP4_ATTN_COLS, MLP4_FC_IN_COLS_FEW (B <= MLP4_FEW_ROWS)
    or MLP4_FC_IN_COLS, and MLP4_DOWN_COLS that divide their phase's width
    (D, I / 2 packed columns, D) and fit shared memory, fc_out's packed rows
    (I / 2) over the fewest blocks (1, 2 or TC_MAX_SPLITS) that leave each
    at most MLP4_DOWN_SPAN rows in whole TC_CHUNK-row chunks and fit (the
    most that do, where none leaves so few), and MLP4_PDL. None where no
    tiling fits."""
    IH = I // 2
    fits = lambda cols, width, **kw: next(  # noqa: E731
        (c for c in cols if width % c == 0 and int4_smem(c, B=B, **kw) <= SMEM_LIMIT), None)
    attn = fits(MLP4_ATTN_COLS, D, splits=1, K2=D // 2)
    fc_in = fits(MLP4_FC_IN_COLS_FEW if B <= MLP4_FEW_ROWS else MLP4_FC_IN_COLS, IH, splits=1,
                 K2=D, ln=True, colsplit=True)
    down = next((c for c in MLP4_DOWN_COLS if D % c == 0), None)
    if None in (attn, fc_in, down):
        return None
    ok = [s for s in (1, 2, TC_MAX_SPLITS)
          if IH % (s * TC_CHUNK) == 0 and int4_smem(down, s, IH, B) <= SMEM_LIMIT]
    if not ok:
        return None
    return attn, fc_in, down, next((s for s in ok if IH // s <= MLP4_DOWN_SPAN), ok[-1]), MLP4_PDL


def int4_mlp_limits(what, B, D, I, attn_cols, fc_in_cols, down_cols, down_splits):
    """Raise ValueError unless B10's kernel takes this tiling at B rows:
    each phase's (packed) columns one of its instances dividing its width,
    fc_out split 1, 2 or TC_MAX_SPLITS ways into whole TC_CHUNK-row chunks,
    and every block within shared memory."""
    IH = I // 2
    if (attn_cols not in MLP4_ATTN_COLS or D % attn_cols or fc_in_cols not in MLP4_FC_IN_COLS
            or IH % fc_in_cols or down_cols not in MLP4_DOWN_COLS or D % down_cols
            or down_splits not in (1, 2, TC_MAX_SPLITS) or IH % (down_splits * TC_CHUNK)):
        raise ValueError(f"{what}: tiling ({attn_cols}, {fc_in_cols}, {down_cols}, "
                         f"{down_splits}) does not fit D {D}, I {I}")
    if max(_mlp4_smem(B, D, IH, attn_cols, fc_in_cols, down_cols, down_splits)) > SMEM_LIMIT:
        raise ValueError(f"{what}: a block's shared memory exceeds {SMEM_LIMIT} bytes")


def ln_qkv_int8(x, g, b, w_t, s, bias, eps: float):
    """x (B, D) bf16/f32 -> (bf16(LN(x)) @ W) * s + bias, (B, N) f32.
    w_t (N, D) int8 out-major; g, b (D,) and s, bias (N,) f32."""
    if not _check_device(x):
        return ln_qkv_int8_plain(x, g, b, w_t, s, bias, eps)
    B, D = x.shape
    N = w_t.shape[0]
    _qkv_limits(B, D, N, False, "ln_qkv_int8")
    dev = x.device
    _check("x", x, (B, D), _ACT, dev)
    for name, t in (("g", g), ("b", b)):
        _check(name, t, (D,), _F32, dev)
    _check("w_t", w_t, (N, D), _I8, dev)
    for name, t in (("s", s), ("bias", bias)):
        _check(name, t, (N,), _F32, dev)
    out = torch.empty((B, N), dtype=torch.float32, device=dev)
    err = _kernels().ln_qkv_int8_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), g.data_ptr(),
        b.data_ptr(), w_t.data_ptr(), s.data_ptr(), bias.data_ptr(),
        out.data_ptr(), B, D, N, eps,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"ln_qkv_int8 launch failed: CUDA error {err}")
    count_launch(launches, "ln_qkv_int8")
    return out


def attnout_ln_mlp_int8(a, xres, wo_t, so, bo, g2, be2, w1_t, s1, b1,
                        w2_t, s2, b2, eps: float, tw: int = 1024):
    """Second half of a GPT-2 decode layer: a, xres (B, D) bf16/f32 (same
    type) -> new residual stream (B, D) f32. wo_t (D, D), w1_t (I, D),
    w2_t (D, I) int8 out-major; the rest (D,) or (I,) f32; tw is the hidden
    tile W2's scale applies to (the JAX package's 1024)."""
    if not _check_device(a):
        return attnout_ln_mlp_int8_plain(a, xres, wo_t, so, bo, g2, be2, w1_t,
                                         s1, b1, w2_t, s2, b2, eps, tw)
    tiling = gelu_tiling(a.shape[0], a.shape[1], w1_t.shape[0], tw)
    if tiling is None:
        raise ValueError("attnout_ln_mlp_int8: no tiling of the kernel fits these shapes")
    return attnout_ln_mlp_int8_tiled(a, xres, wo_t, so, bo, g2, be2, w1_t, s1, b1, w2_t,
                                     s2, b2, eps, tw, *tiling)


def _mlp_tile_limits(B, D, I, tw, what):
    _shape_limits(B, D, what)
    _shape_limits(B, I, what)
    if tw % K_STEP or I % tw:
        raise ValueError(f"{what}: tile {tw} must be a multiple of {K_STEP} dividing {I}")


def attnout_ln_mlp_int8_tiled(a, xres, wo_t, so, bo, g2, be2, w1_t, s1, b1, w2_t, s2, b2,
                              eps: float, tw: int, attn_splits: int, gelu_units: int,
                              down_splits: int, pdl: bool):
    """B2's kernel at a given tiling (gelu_tiling's four numbers;
    chip_smoke.py sweeps them). A CUDA a only."""
    B, D = a.shape
    I = w1_t.shape[0]
    _mlp_tile_limits(B, D, I, tw, "attnout_ln_mlp_int8")
    if gelu_units not in GELU_UNITS:
        raise ValueError(f"attnout_ln_mlp_int8: {gelu_units} hidden units a block is not "
                         f"one of {GELU_UNITS}")
    tc_phases_limits("attnout_ln_mlp_int8", B, D, I, I // tw, attn_splits, gelu_units,
                     down_splits)
    dev = a.device
    _check("a", a, (B, D), _ACT, dev)
    _check("xres", xres, (B, D), (a.dtype,), dev)
    _check("wo_t", wo_t, (D, D), _I8, dev)
    _check("w1_t", w1_t, (I, D), _I8, dev)
    _check("w2_t", w2_t, (D, I), _I8, dev)
    for name, t in (("so", so), ("bo", bo), ("g2", g2), ("be2", be2),
                    ("s2", s2), ("b2", b2)):
        _check(name, t, (D,), _F32, dev)
    for name, t in (("s1", s1), ("b1", b1)):
        _check(name, t, (I,), _F32, dev)
    r_buf = torch.empty((B, D), dtype=torch.float32, device=dev)
    h_buf = torch.empty((B, I), dtype=torch.bfloat16, device=dev)
    out = torch.empty((B, D), dtype=torch.float32, device=dev)
    err = _kernels().attnout_ln_mlp_int8_launch(
        a.data_ptr(), xres.data_ptr(), int(a.dtype == torch.bfloat16),
        wo_t.data_ptr(), so.data_ptr(), bo.data_ptr(), g2.data_ptr(),
        be2.data_ptr(), w1_t.data_ptr(), s1.data_ptr(), b1.data_ptr(),
        w2_t.data_ptr(), s2.data_ptr(), b2.data_ptr(), r_buf.data_ptr(),
        h_buf.data_ptr(), out.data_ptr(), B, D, I, tw, eps, attn_splits, gelu_units,
        down_splits, int(pdl), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"attnout_ln_mlp_int8 launch failed: CUDA error {err}")
    count_launch(launches, "attnout_ln_mlp_int8")
    return out


def rms_qkv_int8(x, g, w_t, s, eps: float):
    """x (B, D) bf16/f32 -> (bf16(RMSNorm(x) * g) @ W) * s, (B, N) f32.
    w_t (N, D) int8 out-major; g (D,) and s (N,) f32."""
    if not _check_device(x):
        return rms_qkv_int8_plain(x, g, w_t, s, eps)
    B, D = x.shape
    N = w_t.shape[0]
    _qkv_limits(B, D, N, True, "rms_qkv_int8")
    dev = x.device
    _check("x", x, (B, D), _ACT, dev)
    _check("g", g, (D,), _F32, dev)
    _check("w_t", w_t, (N, D), _I8, dev)
    _check("s", s, (N,), _F32, dev)
    out = torch.empty((B, N), dtype=torch.float32, device=dev)
    err = _kernels().rms_qkv_int8_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), g.data_ptr(),
        w_t.data_ptr(), s.data_ptr(), out.data_ptr(), B, D, N, eps,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"rms_qkv_int8 launch failed: CUDA error {err}")
    count_launch(launches, "rms_qkv_int8")
    return out


def attnout_rms_glu_int8(a, xres, wo_t, so, g2, wg_t, sg, wu_t, su, wd_t, sd,
                         eps: float, tw: int = 1024):
    """Second half of a llama decode layer: a (merged attention output) and
    xres (B, D) bf16/f32 (same type) -> new residual stream (B, D) f32.
    wo_t (D, D), wg_t / wu_t (I, D), wd_t (D, I) int8 out-major; so, g2, sd
    (D,) and sg, su (I,) f32; tw is the hidden tile Wd's scale applies to."""
    if not _check_device(a):
        return attnout_rms_glu_int8_plain(a, xres, wo_t, so, g2, wg_t, sg, wu_t,
                                          su, wd_t, sd, eps, tw)
    tiling = glu_tiling(a.shape[0], a.shape[1], wg_t.shape[0], tw)
    if tiling is None:
        raise ValueError("attnout_rms_glu_int8: no tiling of the kernel fits these shapes")
    return attnout_rms_glu_int8_tiled(a, xres, wo_t, so, g2, wg_t, sg, wu_t, su, wd_t,
                                      sd, eps, tw, *tiling)


def attnout_rms_glu_int8_tiled(a, xres, wo_t, so, g2, wg_t, sg, wu_t, su, wd_t, sd,
                               eps: float, tw: int, attn_splits: int, glu_units: int,
                               down_splits: int, pdl: bool):
    """B6's kernel at a given tiling (glu_tiling's four numbers;
    chip_smoke.py sweeps them). A CUDA a only."""
    B, D = a.shape
    I = wg_t.shape[0]
    _mlp_tile_limits(B, D, I, tw, "attnout_rms_glu_int8")
    if glu_units not in (GLU_UNITS, GLU_UNITS // 2):
        raise ValueError(f"attnout_rms_glu_int8: {glu_units} hidden units a block is not "
                         f"{GLU_UNITS} or {GLU_UNITS // 2}")
    tc_phases_limits("attnout_rms_glu_int8", B, D, I, I // tw, attn_splits, 2 * glu_units,
                     down_splits)
    dev = a.device
    _check("a", a, (B, D), _ACT, dev)
    _check("xres", xres, (B, D), (a.dtype,), dev)
    _check("wo_t", wo_t, (D, D), _I8, dev)
    _check("wg_t", wg_t, (I, D), _I8, dev)
    _check("wu_t", wu_t, (I, D), _I8, dev)
    _check("wd_t", wd_t, (D, I), _I8, dev)
    for name, t in (("so", so), ("g2", g2), ("sd", sd)):
        _check(name, t, (D,), _F32, dev)
    for name, t in (("sg", sg), ("su", su)):
        _check(name, t, (I,), _F32, dev)
    r_buf = torch.empty((B, D), dtype=torch.float32, device=dev)
    h_buf = torch.empty((B, I), dtype=torch.bfloat16, device=dev)
    out = torch.empty((B, D), dtype=torch.float32, device=dev)
    err = _kernels().attnout_rms_glu_int8_launch(
        a.data_ptr(), xres.data_ptr(), int(a.dtype == torch.bfloat16),
        wo_t.data_ptr(), so.data_ptr(), g2.data_ptr(), wg_t.data_ptr(),
        sg.data_ptr(), wu_t.data_ptr(), su.data_ptr(), wd_t.data_ptr(),
        sd.data_ptr(), r_buf.data_ptr(), h_buf.data_ptr(), out.data_ptr(),
        B, D, I, tw, eps, attn_splits, glu_units, down_splits, int(pdl),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"attnout_rms_glu_int8 launch failed: CUDA error {err}")
    count_launch(launches, "attnout_rms_glu_int8")
    return out


def _int4_limits(B, K2, what):
    if not 1 <= B <= MAX_B:
        raise ValueError(f"{what}: batch {B} outside 1..{MAX_B}")
    if K2 <= 0 or K2 % GROUP:
        raise ValueError(f"{what}: packed half {K2} is not a multiple of {GROUP} rows")


def ln_qkv_int4(x, g, b, wp_t, slo_t, shi_t, bias, eps: float):
    """x (B, D) bf16/f32 -> bias + bf16(LN(x)) @ W, (B, N) f32. W is int4,
    row split, out-major: wp_t (N, D/2) int8, slo_t / shi_t (N, D/512) f32;
    g, b (D,) and bias (N,) f32."""
    if not _check_device(x):
        return ln_qkv_int4_plain(x, g, b, wp_t, slo_t, shi_t, bias, eps)
    cols = ln_qkv_int4_tiling(x.shape[0], x.shape[1], wp_t.shape[0])
    if cols is None:
        raise ValueError("ln_qkv_int4: no tiling of the kernel fits these shapes")
    return ln_qkv_int4_tiled(x, g, b, wp_t, slo_t, shi_t, bias, eps, cols)


def ln_qkv_int4_tiled(x, g, b, wp_t, slo_t, shi_t, bias, eps: float, cols: int):
    """B9's kernel at `cols` output columns a block (chip_smoke.py sweeps
    them). A CUDA x only."""
    B, D = x.shape
    N = wp_t.shape[0]
    _int4_limits(B, D // 2, "ln_qkv_int4")
    if D % 2:
        raise ValueError(f"ln_qkv_int4: width {D} is odd")
    if cols not in QKV4_COLS or N % cols:
        raise ValueError(f"ln_qkv_int4: {cols} columns a block (one of {QKV4_COLS}) do not "
                         f"divide {N}")
    if int4_smem(cols, 1, D // 2, B, ln=True) > SMEM_LIMIT:
        raise ValueError(f"ln_qkv_int4: a block's shared memory exceeds {SMEM_LIMIT} bytes")
    dev = x.device
    _check("x", x, (B, D), _ACT, dev)
    for name, t in (("g", g), ("b", b)):
        _check(name, t, (D,), _F32, dev)
    _check("wp_t", wp_t, (N, D // 2), _I8, dev)
    for name, t in (("slo_t", slo_t), ("shi_t", shi_t)):
        _check(name, t, (N, D // 2 // GROUP), _F32, dev)
    _check("bias", bias, (N,), _F32, dev)
    out = torch.empty((B, N), dtype=torch.float32, device=dev)
    err = int4_kernels().ln_qkv_int4_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), g.data_ptr(), b.data_ptr(),
        wp_t.data_ptr(), slo_t.data_ptr(), shi_t.data_ptr(), bias.data_ptr(),
        out.data_ptr(), B, D, N, cols, eps, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"ln_qkv_int4 launch failed: CUDA error {err}")
    count_launch(launches, "ln_qkv_int4")
    return out


def attnout_ln_mlp_int4(a, xres, wo_t, so_lo, so_hi, bo, g2, be2, w1c_t, s1_lo,
                        s1_hi, b1, w2_t, s2_lo, s2_hi, b2, eps: float):
    """Second half of an int4 GPT-2 decode layer: a, xres (B, D) bf16/f32
    (same type) -> new residual stream (B, D) f32. Out-major int4: wo_t
    (D, D/2) and w2_t (D, I/2) row split with scales (D, D/512) and
    (D, I/512); w1c_t (I/2, D) column split with scales (I/2, D/256); bo,
    g2, be2, b2 (D,) and b1 (I,) f32."""
    if not _check_device(a):
        return attnout_ln_mlp_int4_plain(a, xres, wo_t, so_lo, so_hi, bo, g2, be2,
                                         w1c_t, s1_lo, s1_hi, b1, w2_t, s2_lo,
                                         s2_hi, b2, eps)
    tiling = int4_mlp_tiling(a.shape[0], a.shape[1], 2 * w1c_t.shape[0])
    if tiling is None:
        raise ValueError("attnout_ln_mlp_int4: no tiling of the kernel fits these shapes")
    return attnout_ln_mlp_int4_tiled(a, xres, wo_t, so_lo, so_hi, bo, g2, be2, w1c_t, s1_lo,
                                     s1_hi, b1, w2_t, s2_lo, s2_hi, b2, eps, *tiling)


def attnout_ln_mlp_int4_tiled(a, xres, wo_t, so_lo, so_hi, bo, g2, be2, w1c_t, s1_lo,
                              s1_hi, b1, w2_t, s2_lo, s2_hi, b2, eps: float, attn_cols: int,
                              fc_in_cols: int, down_cols: int, down_splits: int, pdl: bool):
    """B10's kernel at a given tiling (int4_mlp_tiling's five numbers;
    chip_smoke.py sweeps them). A CUDA a only."""
    B, D = a.shape
    IH = w1c_t.shape[0]
    I = 2 * IH
    _int4_limits(B, D // 2, "attnout_ln_mlp_int4")
    _int4_limits(B, IH, "attnout_ln_mlp_int4")
    int4_mlp_limits("attnout_ln_mlp_int4", B, D, I, attn_cols, fc_in_cols, down_cols,
                    down_splits)
    dev = a.device
    _check("a", a, (B, D), _ACT, dev)
    _check("xres", xres, (B, D), (a.dtype,), dev)
    _check("wo_t", wo_t, (D, D // 2), _I8, dev)
    _check("w1c_t", w1c_t, (IH, D), _I8, dev)
    _check("w2_t", w2_t, (D, IH), _I8, dev)
    for name, t, shape in (("so_lo", so_lo, (D, D // 2 // GROUP)),
                           ("so_hi", so_hi, (D, D // 2 // GROUP)),
                           ("s1_lo", s1_lo, (IH, D // GROUP)),
                           ("s1_hi", s1_hi, (IH, D // GROUP)),
                           ("s2_lo", s2_lo, (D, IH // GROUP)),
                           ("s2_hi", s2_hi, (D, IH // GROUP)),
                           ("bo", bo, (D,)), ("g2", g2, (D,)), ("be2", be2, (D,)),
                           ("b1", b1, (I,)), ("b2", b2, (D,))):
        _check(name, t, shape, _F32, dev)
    r_buf = torch.empty((B, D), dtype=torch.float32, device=dev)
    h_buf = torch.empty((B, I), dtype=torch.bfloat16, device=dev)
    out = torch.empty((B, D), dtype=torch.float32, device=dev)
    err = int4_kernels().attnout_ln_mlp_int4_launch(
        a.data_ptr(), xres.data_ptr(), int(a.dtype == torch.bfloat16),
        wo_t.data_ptr(), so_lo.data_ptr(), so_hi.data_ptr(), bo.data_ptr(),
        g2.data_ptr(), be2.data_ptr(), w1c_t.data_ptr(), s1_lo.data_ptr(),
        s1_hi.data_ptr(), b1.data_ptr(), w2_t.data_ptr(), s2_lo.data_ptr(),
        s2_hi.data_ptr(), b2.data_ptr(), r_buf.data_ptr(), h_buf.data_ptr(),
        out.data_ptr(), B, D, I, eps, attn_cols, fc_in_cols, down_cols, down_splits, int(pdl),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"attnout_ln_mlp_int4 launch failed: CUDA error {err}")
    count_launch(launches, "attnout_ln_mlp_int4")
    return out


# ---------------------------------------------------------------------------
# operands
# ---------------------------------------------------------------------------

FUSED_KEYS = ("g1", "b1", "qkv_wt", "qkv_s", "qkv_b", "wo_t", "wo_s", "wo_b",
              "g2", "b2", "w1_t", "s1", "fc1_b", "w2_t", "s2", "fc2_b")


def prepare_fused_gpt2_layer_int8(lp: dict) -> dict:
    """Fused-kernel operands from an int8-quantized GPT-2 layer dict
    ({"ln1","qkv","attn_out","ln2","fc_in","fc_out"}, linears carrying
    {"w_q","w_scale","b"}). The weights move to out-major storage and the
    layer's own "w_q" is replaced by a transposed view of it (one copy)."""
    f32 = lambda t: t.float().contiguous()
    fused = {"g1": f32(lp["ln1"]["g"]), "b1": f32(lp["ln1"]["b"]),
             "g2": f32(lp["ln2"]["g"]), "b2": f32(lp["ln2"]["b"])}
    names = {"qkv": ("qkv_wt", "qkv_s", "qkv_b"),
             "attn_out": ("wo_t", "wo_s", "wo_b"),
             "fc_in": ("w1_t", "s1", "fc1_b"),
             "fc_out": ("w2_t", "s2", "fc2_b")}
    for name, (kw, ks, kb) in names.items():
        p = lp[name]
        if "w_q" not in p:
            raise ValueError(f"{name}: quantize int8 first")
        fused[kw] = p["w_q"].T.contiguous()
        fused[ks] = f32(p["w_scale"])
        fused[kb] = f32(p["b"])
        p["w_q"] = fused[kw].T
    return fused


def apply_fused_gpt2_qkv_int8(fl: dict, x2d, eps: float):
    """(B, D) -> (B, 3D) f32."""
    return ln_qkv_int8(x2d, fl["g1"], fl["b1"], fl["qkv_wt"], fl["qkv_s"],
                       fl["qkv_b"], eps)


def apply_fused_gpt2_mlp_int8(fl: dict, attn2d, xres2d, eps: float):
    """(B, D) attention output + residual -> new residual (B, D) f32."""
    return attnout_ln_mlp_int8(
        attn2d, xres2d, fl["wo_t"], fl["wo_s"], fl["wo_b"], fl["g2"],
        fl["b2"], fl["w1_t"], fl["s1"], fl["fc1_b"], fl["w2_t"], fl["s2"],
        fl["fc2_b"], eps)


LLAMA_FUSED_KEYS = ("g1", "qkv_wt", "qkv_s", "wo_t", "wo_s", "g2", "wg_t", "sg",
                    "wu_t", "su", "wd_t", "sd")


def fused_llama_supported(cfg) -> bool:
    """The shapes the llama kernel pair takes: 512-multiple contractions and
    q|k|v width, hidden width a multiple of the 512 tile, H * head_dim == D."""
    D, I = cfg.hidden_size, cfg.intermediate_size
    N = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    return (not cfg.is_gpt and D % K_STEP == 0 and N % K_STEP == 0
            and I % 512 == 0 and cfg.num_heads * cfg.head_dim == D)


def llama_mlp_tile(cfg) -> int:
    return 1024 if cfg.intermediate_size % 1024 == 0 else 512


def prepare_fused_llama_layer_int8(lp: dict) -> dict:
    """Fused-kernel operands from an int8-quantized llama layer dict
    ({"input_ln","q","k","v","o","post_ln","gate","up","down"}, linears
    carrying {"w_q","w_scale"}). q|k|v are stored once as one out-major
    (N, D) weight; the layer's q, k and v "w_q" (used by prefill) become
    transposed row-slice views of it, and the other weights move to
    out-major storage that their layer's "w_q" views (one copy each)."""
    for name in ("q", "k", "v", "o", "gate", "up", "down"):
        if "w_q" not in lp[name]:
            raise ValueError(f"{name}: quantize int8 first")
    f32 = lambda t: t.float().contiguous()
    qkv_wt = torch.cat([lp[n]["w_q"].T for n in ("q", "k", "v")]).contiguous()
    fused = {"g1": f32(lp["input_ln"]["g"]), "qkv_wt": qkv_wt,
             "qkv_s": f32(torch.cat([lp[n]["w_scale"] for n in ("q", "k", "v")])),
             "g2": f32(lp["post_ln"]["g"])}
    row = 0
    for n in ("q", "k", "v"):
        width = lp[n]["w_q"].shape[1]
        lp[n]["w_q"] = qkv_wt[row:row + width].T
        row += width
    for name, (kw, ks) in {"o": ("wo_t", "wo_s"), "gate": ("wg_t", "sg"),
                           "up": ("wu_t", "su"), "down": ("wd_t", "sd")}.items():
        fused[kw] = lp[name]["w_q"].T.contiguous()
        fused[ks] = f32(lp[name]["w_scale"])
        lp[name]["w_q"] = fused[kw].T
    return fused


def apply_fused_llama_qkv_int8(fl: dict, x2d, eps: float):
    """(B, D) -> (B, (H + 2 KV) * head_dim) f32."""
    return rms_qkv_int8(x2d, fl["g1"], fl["qkv_wt"], fl["qkv_s"], eps)


def apply_fused_llama_mlp_int8(fl: dict, attn2d, xres2d, eps: float, tw: int):
    """(B, D) attention output + residual -> new residual (B, D) f32."""
    return attnout_rms_glu_int8(
        attn2d, xres2d, fl["wo_t"], fl["wo_s"], fl["g2"], fl["wg_t"], fl["sg"],
        fl["wu_t"], fl["su"], fl["wd_t"], fl["sd"], eps, tw)


# int4 GPT-2 operands ("int4_fused"): (layer linear, its packed-weight and
# scale leaves) -> (fused keys of weight, low and high scales, bias)
INT4_FUSED_LAYOUT = {
    "qkv": (("w_q4", "w_scale4_lo", "w_scale4_hi"), ("qkv_wpt", "qkv_slo", "qkv_shi", "qkv_b")),
    "attn_out": (("w_q4", "w_scale4_lo", "w_scale4_hi"), ("wo_wpt", "wo_slo", "wo_shi", "wo_b")),
    "fc_in": (("w_q4c", "w_scale4c_lo", "w_scale4c_hi"), ("w1c_t", "s1_lo", "s1_hi", "fc1_b")),
    "fc_out": (("w_q4", "w_scale4_lo", "w_scale4_hi"), ("w2p_t", "s2_lo", "s2_hi", "fc2_b")),
}


def fused_gpt2_supported(cfg) -> bool:
    """The widths the int4 GPT-2 kernel pair takes (the JAX package's
    tiles): D a multiple of 512, 3D of its 512-column tile, I/2 of its
    512-unit hidden tile."""
    return cfg.is_gpt and gpt2_int4_widths_ok(cfg.hidden_size, cfg.intermediate_size)


def gpt2_int4_widths_ok(D: int, I: int) -> bool:
    return (D % (2 * GROUP) == 0 and (3 * D) % 512 == 0 and I % 2 == 0
            and (I // 2) % 512 == 0)


def prepare_fused_gpt2_layer(lp: dict) -> dict:
    """Fused-kernel operands from an int4_fused GPT-2 layer dict
    ({"ln1","qkv","attn_out","ln2","fc_in","fc_out"}; qkv, attn_out and
    fc_out row split {"w_q4","w_scale4_lo","w_scale4_hi","b"}, fc_in column
    split {"w_q4c","w_scale4c_lo","w_scale4c_hi","b"}). Packed weights and
    scales move to out-major storage and the layer's own leaves become
    transposed views of it (no copy where they already are)."""
    for name, ((kw, _, _), _) in INT4_FUSED_LAYOUT.items():
        if kw not in lp[name]:
            raise ValueError(f"{name}: quantize int4_fused first (needs {kw!r})")
    f32 = lambda t: t.float().contiguous()
    fused = {"g1": f32(lp["ln1"]["g"]), "b1": f32(lp["ln1"]["b"]),
             "g2": f32(lp["ln2"]["g"]), "b2": f32(lp["ln2"]["b"])}
    for name, (leaves, (fw, fs_lo, fs_hi, fb)) in INT4_FUSED_LAYOUT.items():
        p = lp[name]
        for leaf, key in zip(leaves, (fw, fs_lo, fs_hi)):
            fused[key] = p[leaf].T.contiguous()
            p[leaf] = fused[key].T
        fused[fb] = f32(p["b"])
    return fused


def apply_fused_gpt2_qkv(fl: dict, x2d, eps: float):
    """(B, D) -> (B, 3D) f32 (B9)."""
    return ln_qkv_int4(x2d, fl["g1"], fl["b1"], fl["qkv_wpt"], fl["qkv_slo"],
                       fl["qkv_shi"], fl["qkv_b"], eps)


def apply_fused_gpt2_mlp(fl: dict, attn2d, xres2d, eps: float):
    """(B, D) attention output + residual -> new residual (B, D) f32 (B10)."""
    return attnout_ln_mlp_int4(
        attn2d, xres2d, fl["wo_wpt"], fl["wo_slo"], fl["wo_shi"], fl["wo_b"],
        fl["g2"], fl["b2"], fl["w1c_t"], fl["s1_lo"], fl["s1_hi"], fl["fc1_b"],
        fl["w2p_t"], fl["s2_lo"], fl["s2_hi"], fl["fc2_b"], eps)
