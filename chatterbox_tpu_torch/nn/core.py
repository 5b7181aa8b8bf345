"""Functional building blocks on torch tensors (the subset of
chatterbox_tpu/nn/core.py that the ported text-to-wav paths call).

Layouts follow the JAX package at every public function, so the two can be
compared like with like:
  * activations are channels-last (B, T, C);
  * linear weights are (in, out): `x @ w`;
  * int8 linear weights are {"w_q" (in, out) int8, "w_scale" (out,) f32};
  * int4 linear weights are nibble-packed as in the JAX package:
    {"w_q4" (in/2, out), "w_scale4_lo", "w_scale4_hi"} split by rows, or
    {"w_q4c" (in, out/2), "w_scale4c_lo", "w_scale4c_hi"} split by columns
    (kernels/int4_matmul.py), stored out-major underneath.
Convolution weights are the one exception: they are carried in torch's own
layout, (Cout, Cin, K) for a conv, (Cin, Cout, K) for a transposed conv and
(Cout, Cin, KH, KW) for a 2-D conv (convert/from_jax.py transposes them
once). LSTM weights keep the JAX layout, (in, 4H), gates in torch's order
(i, f, g, o).

Parameters are nested dicts of tensors, as in the JAX package.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.int4_matmul import (MAX_ROWS, matmul_int4, matmul_int4_dense,
                                   matmul_int4c_dense)
from ..utils.dtensor import settled

F32_MIN = torch.finfo(torch.float32).min


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """`x @ w` with XLA's result types: f32 products summed in f32, then
    rounded once to the result type (an int8 weight takes x's type; two
    float types promote). The JAX package's bf16 matmuls are computed this
    way on the CPU, where torch would otherwise round bf16 partial sums.
    A row-parallel product over a mesh is summed over its shards in f32
    before that rounding, as XLA sums it."""
    if w.dtype == torch.int8:
        out = x.dtype
    else:
        out = torch.promote_types(x.dtype, w.dtype)
    y = x.float() @ w.float()
    return (settled(y) if out != y.dtype else y).to(out)


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    if "w_q" in p:
        # weight-only int8: the product rounds to x's type, then the
        # per-output-channel scale is applied in that type
        y = matmul(x, p["w_q"])
        y = y * p["w_scale"].to(y.dtype)
    elif "w_q4" in p or "w_q4c" in p:
        # weight-only int4: inputs of at most 8 rows (decode) take B8, larger
        # ones (prefill) and the column split (a fused layer's fc_in at
        # prefill) the dense paths; the f32 result is cast to x's type (B8
        # rounds its f32 sums to x's type itself, so the cast is free there)
        x2 = x.reshape(-1, x.shape[-1])
        if "w_q4c" in p:
            y = matmul_int4c_dense(x2, p["w_q4c"], p["w_scale4c_lo"], p["w_scale4c_hi"])
        elif x2.shape[0] <= MAX_ROWS:
            y = matmul_int4(x2.contiguous(), p["w_q4"], p["w_scale4_lo"], p["w_scale4_hi"],
                            x.dtype)
        else:
            y = matmul_int4_dense(x2, p["w_q4"], p["w_scale4_lo"], p["w_scale4_hi"])
        y = y.to(x.dtype).reshape(*x.shape[:-1], -1)
    else:
        y = matmul(x, p["w"])
    if "b" in p:
        y = y + p["b"]
    return y


def embedding(p: dict, ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(ids, p["w"])


def layer_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    if x.dtype == torch.float32 and p["g"].dtype == torch.float32:
        return F.layer_norm(x, x.shape[-1:], p["g"], p["b"], eps)
    # low-precision input: the statistics are taken in f32 and rounded to
    # x's type, the normalisation runs in x's type (jnp.mean / jnp.var)
    xf = x.float()
    mu_f = xf.mean(-1, keepdim=True)
    var = ((xf - mu_f) ** 2).mean(-1, keepdim=True).to(x.dtype)
    y = (x - mu_f.to(x.dtype)) * torch.rsqrt(var + eps)
    return y * p["g"] + p["b"]


def rms_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """llama RMSNorm: normalise in f32, scale by g, cast back to x's type."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * p["g"].float()).to(x.dtype)


def batch_norm(p: dict, x: torch.Tensor, eps: float = 1e-5, affine: bool = True,
               dim: int = -1) -> torch.Tensor:
    """Inference-mode BatchNorm over the channel axis `dim` (the running
    statistics `mean` / `var`, then `g` / `b` unless affine is False)."""
    shape = [1] * x.dim()
    shape[dim] = -1
    y = (x - p["mean"].reshape(shape)) * torch.rsqrt(p["var"].reshape(shape) + eps)
    if affine:
        y = y * p["g"].reshape(shape) + p["b"].reshape(shape)
    return y


def silu(x):
    return x * torch.sigmoid(x)


def gelu_exact(x):
    return F.gelu(x)


def gelu_new(x):
    """GPT-2's gelu ('gelu_new' in HF): tanh approximation."""
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def mish(x):
    return x * torch.tanh(F.softplus(x))


def leaky_relu(x, slope: float = 0.1):
    return torch.where(x >= 0, x, x * slope)


def elu(x):
    return torch.where(x > 0, x, torch.expm1(x))


# ---------------------------------------------------------------------------
# convolutions
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def no_tf32_convs():
    """cuDNN (convolutions, the LSTM) without TF32 inside the block, so
    float32 stays float32 on the card."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _pads(padding):
    if isinstance(padding, int):
        return padding, padding
    return tuple(padding)


def conv1d_cf(p: dict, x: torch.Tensor, stride: int = 1, padding=0,
              dilation: int = 1) -> torch.Tensor:
    """Channels-first conv: x (B, C, T), weight (Cout, Cin, K).
    padding: int (symmetric) or (lo, hi)."""
    lo, hi = _pads(padding)
    if lo or hi:
        x = F.pad(x, (lo, hi))
    return F.conv1d(x, p["w"], p.get("b"), stride=stride, dilation=dilation)


def conv1d(p: dict, x: torch.Tensor, stride: int = 1, padding=0,
           dilation: int = 1) -> torch.Tensor:
    """x (B, T, C) channels-last, as in the JAX package."""
    return conv1d_cf(p, x.transpose(1, 2), stride, padding, dilation).transpose(1, 2)


def causal_conv1d(p: dict, x: torch.Tensor, k: int, dilation: int = 1):
    """Left-padded conv, channels-last."""
    return conv1d(p, x, padding=((k - 1) * dilation, 0), dilation=dilation)


def conv2d_cf(p: dict, x: torch.Tensor, stride=(1, 1), padding=(0, 0)) -> torch.Tensor:
    """Channels-first 2-D conv: x (B, C, H, W), weight (Cout, Cin, KH, KW)."""
    return F.conv2d(x, p["w"], p.get("b"), stride=stride, padding=padding)


def conv_transpose1d_cf(p: dict, x: torch.Tensor, stride: int,
                        padding: int = 0) -> torch.Tensor:
    """torch.nn.ConvTranspose1d: x (B, Cin, T), weight (Cin, Cout, K), as
    one ordinary convolution by phases: output phase r (positions r, r +
    stride, ...) is x convolved with taps r, r + stride, ... of the kernel,
    the phases stacked as output channels, then interleaved. cuDNN runs a
    transposed convolution as a backward-data pass, some of whose
    algorithms sum with atomics, so two runs could differ in the last bits;
    a forward convolution gives the same samples on every run."""
    w = p["w"]
    cin, cout, K = w.shape
    s = stride
    M = -(-K // s)                              # taps a phase
    wp = F.pad(w, (0, M * s - K)).reshape(cin, cout, M, s)       # [.., m, r] = w[.., r + m s]
    wc = wp.flip(2).permute(3, 1, 0, 2).reshape(s * cout, cin, M)
    T = x.shape[2]
    z = F.conv1d(F.pad(x, (M - 1, M - 1)), wc)                  # (B, s Cout, T + M - 1)
    z = z.reshape(x.shape[0], s, cout, T + M - 1).permute(0, 2, 3, 1).reshape(
        x.shape[0], cout, (T + M - 1) * s)
    y = z[:, :, padding:padding + (T - 1) * s + K - 2 * padding]
    return y if p.get("b") is None else y + p["b"][:, None]


# ---------------------------------------------------------------------------
# LSTM
# ---------------------------------------------------------------------------

def lstm(p: dict, x: torch.Tensor):
    """Multi-layer LSTM over x (B, T, C) (torch.lstm: cuDNN on the card).
    Returns (outputs (B, T, H), (h_n, c_n) each (layers, B, H))."""
    layers = p["layers"]
    H = layers[0]["w_hh"].shape[0]
    weights = [w.contiguous() for lp in layers
               for w in (lp["w_ih"].t(), lp["w_hh"].t(), lp["b_ih"], lp["b_hh"])]
    h0 = x.new_zeros((len(layers), x.shape[0], H))
    out, h_n, c_n = torch.lstm(x, (h0, h0), weights, True, len(layers), 0.0,
                               False, False, True)
    return out, (h_n, c_n)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head attention core, written out (not SDPA): q (B, H, Tq, D),
    k/v (B, H, Tk, D); mask is a boolean keep-mask broadcastable to
    (B, H, Tq, Tk). Scores and softmax in f32; the weights are rounded to
    v's type before the second product, whose result has v's type."""
    scores = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    if mask is not None:
        scores = torch.where(mask, scores, F32_MIN)
    probs = torch.softmax(scores, dim=-1)
    if mask is not None:
        probs = torch.where(mask, probs, 0.0)
    probs = probs.to(v.dtype)
    return (probs.float() @ v.float()).to(v.dtype)


def split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    B, T, C = x.shape
    return x.reshape(B, T, n_heads, C // n_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, H, T, D = x.shape
    return x.transpose(1, 2).reshape(B, T, H * D)


# ---------------------------------------------------------------------------
# initialisers (random weights from an explicit torch.Generator; on the
# "meta" device they only give shapes, which the converter checks against)
# ---------------------------------------------------------------------------

class Init:
    """Draws parameters on `device` from one seeded generator."""

    def __init__(self, seed: int, device="cuda"):
        self.device = torch.device(device)
        self.gen = (None if self.device.type == "meta"
                    else torch.Generator(device=self.device).manual_seed(seed))

    def uniform(self, shape, bound: float) -> torch.Tensor:
        if self.gen is None:
            return torch.empty(shape, device=self.device)
        u = torch.rand(shape, generator=self.gen, device=self.device)
        return (u * 2.0 - 1.0) * bound

    def normal(self, shape, std: float = 1.0) -> torch.Tensor:
        if self.gen is None:
            return torch.empty(shape, device=self.device)
        return torch.randn(shape, generator=self.gen, device=self.device) * std

    def const(self, shape, value: float) -> torch.Tensor:
        return torch.full(shape, value, device=self.device)

    def linear(self, in_dim: int, out_dim: int, bias: bool = True) -> dict:
        bound = 1.0 / math.sqrt(in_dim)
        p = {"w": self.uniform((in_dim, out_dim), bound)}
        if bias:
            p["b"] = self.uniform((out_dim,), bound)
        return p

    def embedding(self, num: int, dim: int, std: float = 0.02) -> dict:
        return {"w": self.normal((num, dim), std)}

    def layer_norm(self, dim: int) -> dict:
        return {"g": self.const((dim,), 1.0), "b": self.const((dim,), 0.0)}

    def rms_norm(self, dim: int) -> dict:
        return {"g": self.const((dim,), 1.0)}

    def conv1d(self, in_ch: int, out_ch: int, k: int, bias: bool = True) -> dict:
        bound = 1.0 / math.sqrt(in_ch * k)
        p = {"w": self.uniform((out_ch, in_ch, k), bound)}
        if bias:
            p["b"] = self.uniform((out_ch,), bound)
        return p

    def conv2d(self, in_ch: int, out_ch: int, k: int, bias: bool = True) -> dict:
        bound = 1.0 / math.sqrt(in_ch * k * k)
        p = {"w": self.uniform((out_ch, in_ch, k, k), bound)}
        if bias:
            p["b"] = self.uniform((out_ch,), bound)
        return p

    def batch_norm(self, ch: int) -> dict:
        return {"g": self.const((ch,), 1.0), "b": self.const((ch,), 0.0),
                "mean": self.const((ch,), 0.0), "var": self.const((ch,), 1.0)}

    def lstm(self, input_size: int, hidden: int, num_layers: int) -> dict:
        bound = 1.0 / math.sqrt(hidden)
        return {"layers": [{
            "w_ih": self.uniform((input_size if i == 0 else hidden, 4 * hidden), bound),
            "w_hh": self.uniform((hidden, 4 * hidden), bound),
            "b_ih": self.uniform((4 * hidden,), bound),
            "b_hh": self.uniform((4 * hidden,), bound),
        } for i in range(num_layers)]}

    def conv_transpose1d(self, in_ch: int, out_ch: int, k: int,
                         bias: bool = True) -> dict:
        bound = 1.0 / math.sqrt(in_ch * k)
        p = {"w": self.uniform((in_ch, out_ch, k), bound)}
        if bias:
            p["b"] = self.uniform((out_ch,), bound)
        return p
