"""HiFT's harmonic source as one CUDA call (csrc/hift_source.cu): f0 and the
source noise in, the tanh of the merged harmonics out.

It replaces no TPU kernel: the JAX package computes the source in plain jnp
(chatterbox_tpu/models/s3gen/hift.py, hift_source, `jnp.cumsum` over every
sample). On the card the port's plain version sums its float64 phase with
`torch.cumsum` along the sample axis, a scan of one thread to each (row,
harmonic); this kernel scans the frames instead and closes the sum inside
each frame, in float64 still (models/s3gen/hift.py,
hift_source_framewise_plain, spells out its order on the CPU).

Dispatch is models/s3gen/hift.py's `hift_source`: a CUDA float32 f0 calls
`harmonic_source` here, a CPU one keeps the plain code. `launches` counts
the calls (each is two CUDA launches on one stream, the frame scan and the
per-sample pass). The wrapper reads nothing back from the card.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .fused_layer import count_launch

launches = {"hift_source": 0}

HARMONICS = 9        # the fundamental and 8 overtones (csrc: HARMONICS)
_INT_MAX = 2 ** 31 - 1

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        from .build import load
        lib = load("hift_source")
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.hift_source_launch.argtypes = [P, P, P, I, I, P, I, I, I, P, P, P, P, I, I, I,
                                           F, F, F, F, F, P]
        lib.hift_source_launch.restype = I
        _lib = lib
    return _lib


def _operand(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"hift_source: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"hift_source: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"hift_source: {name} has shape {tuple(t.shape)}, expected {shape}")
    if any(not 0 <= s <= _INT_MAX for s in t.stride()):
        raise ValueError(f"hift_source: {name}'s strides {t.stride()} do not fit the kernel")


def harmonic_source(f0: torch.Tensor, phase: torch.Tensor, noise_u: torch.Tensor,
                    w: torch.Tensor, b: torch.Tensor, phase_carry, *, frame: int,
                    sample_rate: int, sine_amp: float, noise_std: float,
                    threshold: float) -> torch.Tensor:
    """f0 (B, T) float32 -> source (B, T*frame, 1) float32 on f0's device.

    phase (B, 1, 9) and noise_u (B, T*frame, 9) float32, any strides;
    w (9, 1) and b (1,) float32, the source merge's linear; phase_carry
    None or (B, 9), taken as float64 (the sum of f/sr before this window).
    The constants are HiFT's: samples a frame, the sample rate, the sine
    amplitude, the voiced noise's std and the voiced f0 threshold."""
    dev = f0.device
    if f0.dim() != 2:
        raise ValueError(f"hift_source: f0 has shape {tuple(f0.shape)}, expected (B, T)")
    B, T = f0.shape
    n = T * frame
    if T < 1 or not 1 <= B <= 65535 or -(-n // 256) > _INT_MAX:
        raise ValueError(f"hift_source: f0 of shape {tuple(f0.shape)} is outside the kernel")
    _operand("f0", f0, (B, T), torch.float32, dev)
    _operand("noise.phase", phase, (B, 1, HARMONICS), torch.float32, dev)
    _operand("noise.noise_u", noise_u, (B, n, HARMONICS), torch.float32, dev)
    _operand("m_source_linear w", w, (HARMONICS, 1), torch.float32, dev)
    _operand("m_source_linear b", b, (1,), torch.float32, dev)
    f0, w, b = f0.contiguous(), w.contiguous(), b.contiguous()
    carry = None
    if phase_carry is not None:
        carry = torch.as_tensor(phase_carry, device=dev, dtype=torch.float64)
        _operand("phase_carry", carry, (B, HARMONICS), torch.float64, dev)
        carry = carry.contiguous()
    start = torch.empty((B, T, HARMONICS), dtype=torch.float64, device=dev)
    out = torch.empty((B, n, 1), dtype=torch.float32, device=dev)
    f32 = np.float32
    err = _kernel().hift_source_launch(
        f0.data_ptr(), None if carry is None else carry.data_ptr(), phase.data_ptr(),
        phase.stride(0), phase.stride(2), noise_u.data_ptr(), *noise_u.stride(),
        w.data_ptr(), b.data_ptr(), start.data_ptr(), out.data_ptr(), B, T, frame,
        float(f32(1.0) / f32(sample_rate)), float(f32(2.0 * np.pi)), sine_amp, noise_std,
        threshold, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"hift_source launch failed: CUDA error {err}")
    count_launch(launches, "hift_source")
    return out
