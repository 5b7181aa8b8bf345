"""Meanflow solver of the S3Gen mel decoder (the counterpart of the meanflow
half of chatterbox_tpu/models/s3gen/cfm.py): a plain linear t-span and Euler
steps whose estimator sees both step endpoints (t, r), no CFG. The starting
noise z is an argument, drawn by the caller."""
from __future__ import annotations

import numpy as np
import torch

from .unet import unet_apply


def t_span_linear(n_timesteps: int) -> np.ndarray:
    return np.linspace(0.0, 1.0, n_timesteps + 1, dtype=np.float32)


def solve_euler_meanflow(params: dict, z, mu, spks, cond, n_timesteps: int = 2,
                         n_heads: int = 8) -> torch.Tensor:
    """z, mu, cond (B, T, 80); spks (B, 80) -> mels (B, T, 80)."""
    span = t_span_linear(n_timesteps)
    B = mu.shape[0]
    x = z
    for i in range(n_timesteps):
        t, r = float(span[i]), float(span[i + 1])
        t_in = torch.full((B,), t, dtype=x.dtype, device=x.device)
        r_in = torch.full((B,), r, dtype=x.dtype, device=x.device)
        dxdt = unet_apply(params, x, mu, t_in, spks, cond, r=r_in, n_heads=n_heads)
        x = x + float(span[i + 1] - span[i]) * dxdt
    return x
