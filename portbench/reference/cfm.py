"""Frozen reference copy of chatterbox_tpu_torch/models/s3gen/cfm.py at commit f7b8e4d,
plain PyTorch / numpy, importing nothing of the program under test.

Flow-matching solvers of the S3Gen mel decoder (the counterpart of
chatterbox_tpu/models/s3gen/cfm.py). The starting noise z is an argument,
drawn by the caller.
  * meanflow (Turbo/Nano): a linear t-span and Euler steps whose estimator
    sees both step endpoints (t, r), no CFG;
  * CFM (520M): a cosine t-span and Euler steps with classifier-free
    guidance folded into one batch-2B estimator call per step, the
    unconditional half with mu, spks and cond zeroed.
Both take an optional `mask` (B, T) of each row's valid frames (the batched
vocode; the CFG solver doubles it with the batch). The estimator runs in
its parameters' type (bfloat16 for the batched vocode's bf16 flow) while
the Euler state stays float32.
"""
from __future__ import annotations

import numpy as np
import torch

from .unet import unet_apply

INFERENCE_CFG_RATE = 0.7


def t_span_linear(n_timesteps: int) -> np.ndarray:
    return np.linspace(0.0, 1.0, n_timesteps + 1, dtype=np.float32)


def t_span_cosine(n_timesteps: int) -> np.ndarray:
    t = np.linspace(0.0, 1.0, n_timesteps + 1)
    return (1.0 - np.cos(t * 0.5 * np.pi)).astype(np.float32)


def solve_euler_meanflow(params: dict, z, mu, spks, cond, n_timesteps: int = 2,
                         n_heads: int = 8, mask=None) -> torch.Tensor:
    """z, mu, cond (B, T, 80); spks (B, 80) -> mels (B, T, 80)."""
    span = t_span_linear(n_timesteps)
    B = mu.shape[0]
    x = z
    for i in range(n_timesteps):
        t, r = float(span[i]), float(span[i + 1])
        t_in = torch.full((B,), t, dtype=x.dtype, device=x.device)
        r_in = torch.full((B,), r, dtype=x.dtype, device=x.device)
        dxdt = unet_apply(params, x, mu, t_in, spks, cond, r=r_in, n_heads=n_heads,
                          mask=mask).to(x.dtype)
        x = x + float(span[i + 1] - span[i]) * dxdt
    return x


def solve_euler_cfg(params: dict, z, mu, spks, cond, n_timesteps: int = 10,
                    cfg_rate: float = INFERENCE_CFG_RATE,
                    n_heads: int = 8, mask=None) -> torch.Tensor:
    """z, mu, cond (B, T, 80); spks (B, 80) -> mels (B, T, 80), with
    d = (1 + cfg_rate) d_cond - cfg_rate d_uncond at every step."""
    span = t_span_cosine(n_timesteps)
    B = mu.shape[0]
    mu_in = torch.cat([mu, torch.zeros_like(mu)])
    spks_in = torch.cat([spks, torch.zeros_like(spks)])
    cond_in = torch.cat([cond, torch.zeros_like(cond)])
    mask_in = None if mask is None else torch.cat([mask, mask])
    x = z
    for i in range(n_timesteps):
        t_in = torch.full((2 * B,), float(span[i]), dtype=x.dtype, device=x.device)
        d = unet_apply(params, torch.cat([x, x]), mu_in, t_in, spks_in, cond_in,
                       n_heads=n_heads, mask=mask_in).to(x.dtype)
        d = (1.0 + cfg_rate) * d[:B] - cfg_rate * d[B:]
        x = x + float(span[i + 1] - span[i]) * d
    return x
