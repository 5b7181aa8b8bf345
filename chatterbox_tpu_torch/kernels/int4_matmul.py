"""Int4 weight-only products for `nn.linear`: B8 for decode-sized inputs and
the dense paths for larger ones.

  matmul_int4(x, w, s_lo, s_hi,          B8: x of 1-8 rows; replaces the
              out_dtype=torch.float32)   Pallas kernel matmul_int4
                                         (chatterbox_tpu/ops/int4_matmul.py)
  matmul_int4_dense(x, w, s_lo, s_hi)    the JAX package's matmul_int4_xla
  matmul_int4c_dense(x, w, s_lo, s_hi)   the JAX package's matmul_int4c_xla

Weights keep the JAX package's layout at these functions:
  * row split (`w_q4`): w (K/2, N) int8, byte [r, n] holding W[r, n] in the
    low nibble and W[r + K/2, n] in the high one; s_lo, s_hi (K/2/256, N)
    f32, one scale per 256 rows of each half and output column;
  * column split (`w_q4c`): w (K, N/2), byte [r, c] holding W[r, c] low and
    W[r, c + N/2] high; s_lo, s_hi (K/256, N/2).
The kernel streams them out-major: on a CUDA tensor w.T, s_lo.T and s_hi.T
must be contiguous, which is how utils/quantize.py and convert/from_jax.py
store them (the leaves are transposed views of (N, K/2) and (N, K/512)
storage).

B8's arithmetic (the Pallas kernel's): x rounded to bf16; for each group g
of 256 packed rows, acc_lo = x[:, rows of g] @ lo_g and acc_hi =
x[:, K/2 + rows of g] @ hi_g are f32 sums of exact products; out = the sum
over g, in order, of acc_lo * s_lo[g] + acc_hi * s_hi[g]; (B, N) f32,
rounded once to `out_dtype` when that is bf16 (nn.linear passes x's type:
the same values as casting the f32 result, without a launch of its own).
The kernel sums in another order (matmul_int4_split_plain spells it out):
the packed rows cut over `splits` blocks and eight warps a block, each
group's sums scaled where a warp's run of rows leaves it.

The dense paths are plain PyTorch, as the JAX package computes them outside
any kernel, and they round elsewhere: the weights are dequantized in x's
type (value times scale, rounded to bf16 for bf16 x), each half's product
is rounded to x's type, the halves are added in x's type, and the sum is
cast to f32. So the same weight gives slightly different results for
inputs of at most 8 rows and for larger ones, in both packages.

Dispatch of matmul_int4: a CPU tensor takes the plain version, a CUDA
tensor launches the kernel (csrc/int4.cu) at the tiling int4_tiling picks,
anything else raises. `launches` counts the kernel's launches.
"""
from __future__ import annotations

import torch

from .fused_layer import (GROUP, SMEM_LIMIT, _ACT, _F32, _I8, _check, _check_device,
                          count_launch, int4_block_sum, int4_kernels, int4_smem,
                          row_split_dots, unpack_int4)

launches = {"matmul_int4": 0}

MAX_ROWS = 8          # rows nn.linear sends to B8 (the JAX package's cut)
TN = 512              # output-column tile of the Pallas kernel
CHUNK = 64            # packed rows of one step of a warp (the MMA's k permutation)
# The kernel's tiling, from chip_smoke.py's sweep on an H100 (PERF.md):
# output columns a block owns, and the packed rows a block takes at most
# (more are split over a cluster of up to MAX_SPLITS blocks), fewer at more
# rows, where staging x grows with the rows.
INT4_COLS_NARROW, INT4_COLS_WIDE = 16, 32    # N <= 1024, wider N
INT4_SPAN, INT4_SPAN_MANY_ROWS = 1024, 512   # packed rows a block: B <= 4, B > 4
MAX_SPLITS = 4
_OUT = (torch.float32, torch.bfloat16)


def int4_supported(in_dim: int, out_dim: int) -> bool:
    """The shapes the JAX package packs in int4 (its kernel's tiles): the
    contraction a multiple of two 256-row groups, the output of 512."""
    return in_dim % (2 * GROUP) == 0 and out_dim % TN == 0


def matmul_int4_plain(x, w, s_lo, s_hi, out_dtype=torch.float32):
    lo, hi = row_split_dots(x.to(torch.bfloat16).float(), w.T, s_lo.T, s_hi.T)
    out = torch.zeros_like(lo[0])
    for k in range(lo.shape[0]):
        out = out + (lo[k] + hi[k])
    return out.to(out_dtype)


def matmul_int4_split_plain(x, w, s_lo, s_hi, splits: int, out_dtype=torch.float32):
    """matmul_int4 summed in the kernel's order at `splits` blocks a column
    slab: block s takes packed rows [s K2/splits, (s + 1) K2/splits), its
    WARPS warps contiguous runs of CHUNK-row chunks of them; a warp adds,
    for each 256-row group its run meets, (x_lo @ lo) * s_lo + (x_hi @ hi)
    * s_hi over the rows of that group onto its running sum; the warps'
    sums are added in warp order, then the blocks' in block order."""
    K2, N = w.shape
    xb = x.to(torch.bfloat16).float()
    lo, hi = unpack_int4(w)
    span = K2 // splits
    total = torch.zeros((x.shape[0], N))
    for s in range(splits):
        total = total + int4_block_sum(xb, lo, hi, s_lo, s_hi, s * span, (s + 1) * span,
                                       torch.zeros_like(total))
    return total.to(out_dtype)


def int4_tiling(K2: int, N: int, B: int):
    """(cols, splits) of B8 at B rows of a (K2 packed rows, N) weight:
    INT4_COLS_* output columns a block, and the packed rows split over the
    fewest blocks (1, 2 or MAX_SPLITS) that leave each at most INT4_SPAN*
    rows and fit shared memory, each block's share whole CHUNK-row chunks
    (the most that do, where none leaves so few)."""
    cols = INT4_COLS_NARROW if N <= 1024 else INT4_COLS_WIDE
    span = INT4_SPAN if B <= 4 else INT4_SPAN_MANY_ROWS
    ok = [s for s in (1, 2, MAX_SPLITS)
          if K2 % (s * CHUNK) == 0 and int4_smem(cols, s, K2) <= SMEM_LIMIT]
    return cols, next((s for s in ok if K2 // s <= span), ok[-1] if ok else 1)


def matmul_int4(x, w, s_lo, s_hi, out_dtype=torch.float32):
    """x (B <= 8, K) bf16/f32 @ row-split int4 w (K/2, N) -> (B, N) in
    out_dtype (f32 or bf16)."""
    if not _check_device(x):
        return matmul_int4_plain(x, w, s_lo, s_hi, out_dtype)
    return matmul_int4_tiled(x, w, s_lo, s_hi, out_dtype,
                             *int4_tiling(*w.shape, x.shape[0]))


def matmul_int4_tiled(x, w, s_lo, s_hi, out_dtype, cols: int, splits: int):
    """B8's kernel at a given tiling (cols output columns and `splits`
    blocks a column slab; chip_smoke.py sweeps them). A CUDA x only."""
    B, K = x.shape
    K2, N = w.shape
    if K != 2 * K2:
        raise ValueError(f"matmul_int4: x has {K} columns, w packs {2 * K2}")
    if not 1 <= B <= MAX_ROWS:
        raise ValueError(f"matmul_int4: batch {B} outside 1..{MAX_ROWS}")
    if K2 % GROUP:
        raise ValueError(f"matmul_int4: packed half {K2} is not a multiple of {GROUP} rows")
    if cols not in (16, 32) or N % cols or splits not in (1, 2, MAX_SPLITS) \
            or K2 % (splits * CHUNK):
        raise ValueError(f"matmul_int4: tiling ({cols} columns, {splits} splits) does not "
                         f"fit ({K2}, {N})")
    if int4_smem(cols, splits, K2) > SMEM_LIMIT:
        raise ValueError("matmul_int4: a block's shared memory exceeds "
                         f"{SMEM_LIMIT} bytes")
    if out_dtype not in _OUT:
        raise TypeError(f"matmul_int4: out_dtype {out_dtype} is not one of {_OUT}")
    dev = x.device
    _check("x", x, (B, K), _ACT, dev)
    _check("w.T", w.T, (N, K2), _I8, dev)
    _check("s_lo.T", s_lo.T, (N, K2 // GROUP), _F32, dev)
    _check("s_hi.T", s_hi.T, (N, K2 // GROUP), _F32, dev)
    out = torch.empty((B, N), dtype=out_dtype, device=dev)
    err = int4_kernels().matmul_int4_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(), s_lo.data_ptr(),
        s_hi.data_ptr(), out.data_ptr(), int(out_dtype == torch.bfloat16), B, K2, N,
        cols, splits, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"matmul_int4 launch failed: CUDA error {err}")
    count_launch(launches, "matmul_int4")
    return out


def _dequant(vals, scale, dtype):
    """(R, C) nibble values and (G, C) group scales -> (R, C) weights in
    `dtype`, each scale applied to its R / G rows."""
    R, C = vals.shape
    G = scale.shape[0]
    return (vals.reshape(G, R // G, C) * scale[:, None, :].to(dtype)).reshape(R, C)


def _product(x, w):
    """x @ w with f32 sums rounded once to x's type (XLA's dot)."""
    return (x.float() @ w.float()).to(x.dtype)


def matmul_int4_dense(x, w, s_lo, s_hi):
    """matmul_int4_xla: x (B, K) @ row-split int4 w (K/2, N) -> (B, N) f32."""
    K2 = w.shape[0]
    lo, hi = unpack_int4(w, x.dtype)
    return (_product(x[:, :K2], _dequant(lo, s_lo, x.dtype))
            + _product(x[:, K2:], _dequant(hi, s_hi, x.dtype))).float()


def matmul_int4c_dense(x, w, s_lo, s_hi):
    """matmul_int4c_xla: x (B, K) @ column-split int4 w (K, N/2) -> (B, N)
    f32."""
    lo, hi = unpack_int4(w, x.dtype)
    return torch.cat([_product(x, _dequant(lo, s_lo, x.dtype)),
                      _product(x, _dequant(hi, s_hi, x.dtype))], dim=-1).float()
