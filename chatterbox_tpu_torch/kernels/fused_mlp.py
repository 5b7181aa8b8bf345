"""B11: the fused int8 MLP block of a GPT-2 decode step, and its plain
version.

  fused_mlp_int8(x, ln_g, ln_b, w1_q, s1, b1, w2_q, s2, b2)
      = x + (bf16(gelu_new((bf16(LN(x)) @ W1) * s1 + b1)) @ W2) * s2 + b2

in x's type (B2 returns f32), LayerNorm eps fixed at 1e-5. It replaces the
Pallas kernel fused_mlp_int8 (chatterbox_tpu/ops/pallas_mlp.py), a library
kernel: nothing in the JAX package calls it outside its own test, and
nothing in this package calls it either. chip_smoke.py holds it against
its plain version on the Turbo int8 layers' ln2 / fc_in / fc_out. On the
card it is two phases of B2's tensor-core kernel (csrc/fused_layer.cu,
tc_int8_kernel): the LayerNorm + fc_in + gelu phase on x, then the down
phase with x as its residual, W2's scale applied once to the whole sum
(the Pallas kernel's one product) and the result in x's type.

Weights keep the JAX package's layout: w1_q (D, I) and w2_q (I, D) int8
with scales s1 (I,) and s2 (D,). On a CUDA tensor they must be stored
out-major (w1_q.T, w2_q.T contiguous), as the `w_q` leaves of an
int8_fused layer are; the vectors are f32. 1 to 16 rows.

Dispatch: a CPU tensor takes the plain version, a CUDA tensor launches the
kernel at the tiling gelu_tiling picks, anything else raises. `launches`
counts the kernel calls (each is two CUDA launches on one stream).
"""
from __future__ import annotations

import torch

from .fused_layer import (_ACT, _F32, _I8, GELU_UNITS, _check, _check_device,
                          _gelu_new_f32, _kernels, _ln_bf16, _mlp_tile_limits,
                          _warp_dot_i8, count_launch, gelu_tiling, tc_phases_limits)

launches = {"fused_mlp_int8": 0}

EPS = 1e-5


def fused_mlp_int8_plain(x, ln_g, ln_b, w1_q, s1, b1, w2_q, s2, b2):
    h = _ln_bf16(x, ln_g.float(), ln_b.float(), EPS)
    h1 = (h @ w1_q.float()) * s1.float() + b1.float()
    h1 = _gelu_new_f32(h1).to(torch.bfloat16).float()
    h2 = (h1 @ w2_q.float()) * s2.float() + b2.float()
    return (x.float() + h2).to(x.dtype)


def fused_mlp_int8_split_plain(x, ln_g, ln_b, w1_q, s1, b1, w2_q, s2, b2,
                               down_splits: int):
    """fused_mlp_int8 summed in the CUDA kernel's order: each hidden unit one
    block's sum over its warps (fused_layer._warp_dot_i8); fc_out's
    contraction cut over `down_splits` blocks, each one block's sum over its
    warps, the blocks' sums added in order, then scaled once and b2 added,
    then x."""
    D, I = w1_q.shape
    h = _ln_bf16(x, ln_g.float(), ln_b.float(), EPS)
    h1 = _warp_dot_i8(h, w1_q.T, 0, D) * s1.float() + b1.float()
    h1 = _gelu_new_f32(h1).to(torch.bfloat16).float()
    span = I // down_splits
    acc = torch.zeros((x.shape[0], w2_q.shape[1]))
    for s in range(down_splits):
        acc = acc + _warp_dot_i8(h1, w2_q.T, s * span, (s + 1) * span)
    return (x.float() + (acc * s2.float() + b2.float())).to(x.dtype)


def fused_mlp_int8(x, ln_g, ln_b, w1_q, s1, b1, w2_q, s2, b2):
    """x (B, D) bf16/f32 -> x + MLP(LN(x)), (B, D) in x's type."""
    if not _check_device(x):
        return fused_mlp_int8_plain(x, ln_g, ln_b, w1_q, s1, b1, w2_q, s2, b2)
    tiling = gelu_tiling(x.shape[0], x.shape[1], w1_q.shape[1], None)
    if tiling is None:
        raise ValueError("fused_mlp_int8: no tiling of the kernel fits these shapes")
    _, units, down, pdl = tiling
    return fused_mlp_int8_tiled(x, ln_g, ln_b, w1_q, s1, b1, w2_q, s2, b2, units, down, pdl)


def fused_mlp_int8_tiled(x, ln_g, ln_b, w1_q, s1, b1, w2_q, s2, b2, gelu_units: int,
                         down_splits: int, pdl: bool):
    """B11's kernel at a given tiling (the last three numbers of
    gelu_tiling; chip_smoke.py sweeps them). A CUDA x only."""
    B, D = x.shape
    I = w1_q.shape[1]
    _mlp_tile_limits(B, D, I, I, "fused_mlp_int8")
    if gelu_units not in GELU_UNITS:
        raise ValueError(f"fused_mlp_int8: {gelu_units} hidden units a block is not one "
                         f"of {GELU_UNITS}")
    tc_phases_limits("fused_mlp_int8", B, D, I, down_splits, None, gelu_units, down_splits)
    dev = x.device
    _check("x", x, (B, D), _ACT, dev)
    _check("w1_q.T", w1_q.T, (I, D), _I8, dev)
    _check("w2_q.T", w2_q.T, (D, I), _I8, dev)
    for name, t, n in (("ln_g", ln_g, D), ("ln_b", ln_b, D), ("s1", s1, I),
                       ("b1", b1, I), ("s2", s2, D), ("b2", b2, D)):
        _check(name, t, (n,), _F32, dev)
    h_buf = torch.empty((B, I), dtype=torch.bfloat16, device=dev)
    out = torch.empty_like(x)
    err = _kernels().fused_mlp_int8_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), ln_g.data_ptr(), ln_b.data_ptr(),
        w1_q.data_ptr(), s1.data_ptr(), b1.data_ptr(), w2_q.data_ptr(), s2.data_ptr(),
        b2.data_ptr(), h_buf.data_ptr(), out.data_ptr(), B, D, I, gelu_units, down_splits,
        int(pdl), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"fused_mlp_int8 launch failed: CUDA error {err}")
    count_launch(launches, "fused_mlp_int8")
    return out
