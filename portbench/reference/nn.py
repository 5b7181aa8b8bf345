"""Frozen reference copy of chatterbox_tpu_torch/nn/core.py at commit f7b8e4d,
plain PyTorch / numpy, importing nothing of the program under test.

Functional building blocks on torch tensors (the subset that
S3Gen, the S3 tokenizer and CAMPPlus call).

Layouts follow the JAX package at every public function, so the two can be
compared like with like:
  * activations are channels-last (B, T, C);
  * linear weights are (in, out): `x @ w`.
Convolution weights are the one exception: they are carried in torch's own
layout, (Cout, Cin, K) for a conv, (Cin, Cout, K) for a transposed conv and
(Cout, Cin, KH, KW) for a 2-D conv (convert/from_jax.py transposes them
once).

Parameters are nested dicts of tensors, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


F32_MIN = torch.finfo(torch.float32).min


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """`x @ w` with f32 products summed in f32, then rounded once to the
    promoted result type."""
    out = torch.promote_types(x.dtype, w.dtype)
    y = x.float() @ w.float()
    return y.to(out)


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
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


def mish(x):
    return x * torch.tanh(F.softplus(x))


def leaky_relu(x, slope: float = 0.1):
    return torch.where(x >= 0, x, x * slope)


def elu(x):
    return torch.where(x > 0, x, torch.expm1(x))


# ---------------------------------------------------------------------------
# convolutions
# ---------------------------------------------------------------------------

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

    def conv_transpose1d(self, in_ch: int, out_ch: int, k: int,
                         bias: bool = True) -> dict:
        bound = 1.0 / math.sqrt(in_ch * k)
        p = {"w": self.uniform((in_ch, out_ch, k), bound)}
        if bias:
            p["b"] = self.uniform((out_ch,), bound)
        return p
