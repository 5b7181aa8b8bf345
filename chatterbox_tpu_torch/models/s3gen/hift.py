"""HiFT vocoder: neural source filter + iSTFT head (the counterpart of
chatterbox_tpu/models/s3gen/hift.py).

f0 predictor -> x480 f0 upsample -> harmonic sine source -> source STFT
(n_fft 16, hop 4) fused into a 3-stage ConvTranspose upsampler (8, 5, 3)
with Snake resblocks -> conv_post -> exp-magnitude / sin-phase iSTFT ->
clamp +-0.99. The STFT is torch.stft with the periodic Hann window; the
iSTFT is torch.istft's computation written out (`_istft`), without its
host read. Inside the decoder the layout is channels-first
(B, C, T); the public functions keep the JAX package's (B, T, C).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ...kernels.hift_source import harmonic_source
from ...nn import core as nn

UPSAMPLE_RATES = (8, 5, 3)
UPSAMPLE_KERNELS = (16, 11, 7)
SOURCE_RES_KERNELS = (7, 7, 11)
RES_KERNELS = (3, 7, 11)
RES_DILATIONS = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
ISTFT_NFFT = 16
ISTFT_HOP = 4
NB_HARMONICS = 8
BASE_CHANNELS = 512
SINE_AMP = 0.1
NOISE_STD = 0.003
VOICED_THRESHOLD = 10.0
AUDIO_LIMIT = 0.99
SAMPLE_RATE = 24000
TOTAL_UPSAMPLE = 8 * 5 * 3 * ISTFT_HOP  # 480 samples per mel frame
DOWN_CUM = (15, 3, 1)


class SourceNoise(NamedTuple):
    """The random numbers of the harmonic source."""
    phase: torch.Tensor     # (B, 1, NB_HARMONICS+1) uniform in [-pi, pi)
    noise_u: torch.Tensor   # (B, T_mel*480, NB_HARMONICS+1) standard normal

    @classmethod
    def draw(cls, B: int, n_frames: int, generator, device) -> "SourceNoise":
        h = NB_HARMONICS + 1
        u = torch.rand((B, 1, h), generator=generator, device=device)
        phase = (u * 2.0 - 1.0) * torch.pi
        noise_u = torch.randn((B, n_frames * TOTAL_UPSAMPLE, h),
                              generator=generator, device=device)
        return cls(phase, noise_u)


def _resblock_init(init: nn.Init, ch: int, k: int, dilations) -> dict:
    return {"convs1": [init.conv1d(ch, ch, k) for _ in dilations],
            "convs2": [init.conv1d(ch, ch, k) for _ in dilations],
            "alpha1": [init.const((ch,), 1.0) for _ in dilations],
            "alpha2": [init.const((ch,), 1.0) for _ in dilations]}


def _snake_cf(x, alpha, eps: float = 1e-9):
    a = alpha[None, :, None]
    s = torch.sin(x * a)
    return x + s * s / (a + eps)


def _resblock_apply(p: dict, x: torch.Tensor, k: int, dilations) -> torch.Tensor:
    """Snake-activated residual block, channels-first."""
    for i, d in enumerate(dilations):
        xt = _snake_cf(x, p["alpha1"][i])
        xt = nn.conv1d_cf(p["convs1"][i], xt, padding=(k * d - d) // 2, dilation=d)
        xt = _snake_cf(xt, p["alpha2"][i])
        xt = nn.conv1d_cf(p["convs2"][i], xt, padding=(k - 1) // 2)
        x = x + xt
    return x


def hift_init(init: nn.Init, base_channels: int = BASE_CHANNELS) -> dict:
    ch = max(base_channels, 8)
    p = {
        "f0_predictor": {
            "convs": [init.conv1d(80 if i == 0 else ch, ch, 3) for i in range(5)],
            "classifier": init.linear(ch, 1)},
        "m_source_linear": init.linear(NB_HARMONICS + 1, 1),
        "conv_pre": init.conv1d(80, base_channels, 7),
        "ups": [], "source_downs": [], "source_resblocks": [], "resblocks": [],
    }
    for i, (u, k) in enumerate(zip(UPSAMPLE_RATES, UPSAMPLE_KERNELS)):
        ch_out = base_channels // (2 ** (i + 1))
        p["ups"].append(init.conv_transpose1d(base_channels // (2 ** i), ch_out, k))
        dc = DOWN_CUM[i]
        p["source_downs"].append(init.conv1d(ISTFT_NFFT + 2, ch_out,
                                             1 if dc == 1 else dc * 2))
        p["source_resblocks"].append(
            _resblock_init(init, ch_out, SOURCE_RES_KERNELS[i], RES_DILATIONS[i]))
        for k_r, d_r in zip(RES_KERNELS, RES_DILATIONS):
            p["resblocks"].append(_resblock_init(init, ch_out, k_r, d_r))
    p["conv_post"] = init.conv1d(base_channels // 8, ISTFT_NFFT + 2, 7)
    return p


def f0_predictor_apply(p: dict, mel: torch.Tensor) -> torch.Tensor:
    """(B, T, 80) mel -> (B, T) f0 in Hz."""
    x = mel.transpose(1, 2)
    for c in p["convs"]:
        x = nn.elu(nn.conv1d_cf(c, x, padding=1))
    return torch.abs(nn.linear(p["classifier"], x.transpose(1, 2)))[..., 0]


def hift_source(params: dict, f0: torch.Tensor, noise: SourceNoise,
                phase_carry: Optional[torch.Tensor] = None) -> torch.Tensor:
    """f0 (B, T_mel) -> source signal (B, T_mel*480, 1). The harmonic phase
    is summed in float64 (exact enough at any length), the rest in f32.

    phase_carry (B, NB_HARMONICS+1): the sum of f/sr over every sample
    before this window, added to the float64 sum, so that a streaming
    caller continues the harmonic phase across windows.

    A CUDA float32 f0 takes the CUDA kernel (kernels/hift_source.py, the
    order of hift_source_framewise_plain), a CPU f0 the plain code below;
    any other raises."""
    if f0.device.type == "cuda" and f0.dtype == torch.float32:
        lin = params["m_source_linear"]
        return harmonic_source(f0, noise.phase, noise.noise_u, lin["w"], lin["b"],
                               phase_carry, frame=TOTAL_UPSAMPLE, sample_rate=SAMPLE_RATE,
                               sine_amp=SINE_AMP, noise_std=NOISE_STD,
                               threshold=VOICED_THRESHOLD)
    if f0.device.type != "cpu":
        raise ValueError(f"hift_source: no path for a {f0.dtype} f0 on {f0.device}")
    return _source_from_phase(params, f0, harmonic_phase(f0, phase_carry), noise)


def _harmonic_steps(f0: torch.Tensor) -> torch.Tensor:
    """f0 (B, T) -> f/sr of each harmonic, (B, T, NB_HARMONICS+1) float32."""
    harmonics = torch.arange(1, NB_HARMONICS + 2, dtype=torch.float32,
                             device=f0.device)
    return f0[..., None] * harmonics / SAMPLE_RATE


def harmonic_phase(f0: torch.Tensor, phase_carry=None) -> torch.Tensor:
    """The plain source's harmonic phase in cycles, mod 1: the float64
    cumsum of f/sr over every sample, plus the carry; (B, T*480,
    NB_HARMONICS+1) float64."""
    f_mat = torch.repeat_interleave(_harmonic_steps(f0), TOTAL_UPSAMPLE, dim=1)
    cum = torch.cumsum(f_mat.double(), dim=1)
    if phase_carry is not None:
        cum = cum + torch.as_tensor(phase_carry, device=f0.device).double()[:, None, :]
    return torch.remainder(cum, 1.0)


def harmonic_phase_framewise(f0: torch.Tensor, phase_carry=None) -> torch.Tensor:
    """harmonic_phase in the CUDA kernel's order. f0 repeats over a frame's
    480 samples, so the phase at sample j of frame k is C_k + (j + 1) x_k,
    x_k the frame's f/sr; the frame starts C_k = frac(carry + frac(sum over
    k' < k of frac(480 x_k'))) are scanned over the frames alone. Each
    term and each partial sum kept mod 1 lies in [0, 1) on the grid of 32
    times the smallest x's ulp, 2^-52 or coarser for any f0 above 1.4e-6
    Hz, so every addition of the scan is exact in float64 and its order
    (here one frame after another, on the card runs of frames a thread and
    a scan of the runs) gives the same bits."""
    B, T = f0.shape
    x = _harmonic_steps(f0).double()                                  # (B, T, H)
    step = torch.remainder(TOTAL_UPSAMPLE * x, 1.0)
    start = torch.zeros_like(x)
    for k in range(1, T):
        start[:, k] = torch.remainder(start[:, k - 1] + step[:, k - 1], 1.0)
    if phase_carry is not None:
        start = torch.remainder(
            torch.as_tensor(phase_carry, device=f0.device).double()[:, None, :] + start, 1.0)
    j = torch.arange(1, TOTAL_UPSAMPLE + 1, dtype=torch.float64, device=f0.device)
    cum = start[:, :, None, :] + j[None, None, :, None] * x[:, :, None, :]
    return torch.remainder(cum, 1.0).reshape(B, T * TOTAL_UPSAMPLE, -1)


def hift_source_framewise_plain(params: dict, f0: torch.Tensor, noise: SourceNoise,
                                phase_carry: Optional[torch.Tensor] = None) -> torch.Tensor:
    """hift_source with its phase summed in the CUDA kernel's order
    (harmonic_phase_framewise); the rest as the plain code."""
    return _source_from_phase(params, f0, harmonic_phase_framewise(f0, phase_carry), noise)


def _source_from_phase(params: dict, f0: torch.Tensor, frac_phase: torch.Tensor,
                       noise: SourceNoise) -> torch.Tensor:
    """The source from the harmonic phase in cycles (mod 1, float64): the
    sines, the voiced / unvoiced noise, the merge's linear and tanh."""
    f0_up = torch.repeat_interleave(f0, TOTAL_UPSAMPLE, dim=1)        # (B, T)
    theta = 2.0 * torch.pi * frac_phase.float()
    phase = noise.phase.clone()
    phase[:, :, 0] = 0.0
    sine = SINE_AMP * torch.sin(theta + phase)
    uv = (f0_up > VOICED_THRESHOLD).float()[..., None]
    noise_amp = uv * NOISE_STD + (1.0 - uv) * SINE_AMP / 3.0
    sine = sine * uv + noise_amp * noise.noise_u
    return torch.tanh(nn.linear(params["m_source_linear"], sine))


def _hann(device) -> torch.Tensor:
    return torch.hann_window(ISTFT_NFFT, periodic=True, device=device)


def hift_decode(params: dict, mel: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """mel (B, T, 80), source s (B, T*480, 1) -> wav (B, T*480)."""
    win = _hann(mel.device)
    spec = torch.stft(s[..., 0], ISTFT_NFFT, ISTFT_HOP, ISTFT_NFFT, window=win,
                      center=True, pad_mode="reflect", return_complex=True)
    s_stft = torch.cat([spec.real, spec.imag], dim=1)               # (B, 18, F)

    x = nn.conv1d_cf(params["conv_pre"], mel.transpose(1, 2), padding=3)
    for i, (u, k) in enumerate(zip(UPSAMPLE_RATES, UPSAMPLE_KERNELS)):
        x = nn.leaky_relu(x, 0.1)
        x = nn.conv_transpose1d_cf(params["ups"][i], x, stride=u, padding=(k - u) // 2)
        if i == len(UPSAMPLE_RATES) - 1:
            x = torch.cat([x[:, :, 1:2], x], dim=2)   # reflection pad (1, 0)
        dc = DOWN_CUM[i]
        if dc == 1:
            si = nn.conv1d_cf(params["source_downs"][i], s_stft)
        else:
            si = nn.conv1d_cf(params["source_downs"][i], s_stft, stride=dc,
                              padding=dc // 2)
        si = _resblock_apply(params["source_resblocks"][i], si,
                             SOURCE_RES_KERNELS[i], RES_DILATIONS[i])
        x = x + si
        acc = None
        for j in range(len(RES_KERNELS)):
            r = _resblock_apply(params["resblocks"][i * len(RES_KERNELS) + j], x,
                                RES_KERNELS[j], RES_DILATIONS[j])
            acc = r if acc is None else acc + r
        x = acc / len(RES_KERNELS)

    x = nn.leaky_relu(x, 0.01)
    x = nn.conv1d_cf(params["conv_post"], x, padding=3)             # (B, 18, F)
    n_half = ISTFT_NFFT // 2 + 1
    magnitude = torch.clamp(torch.exp(x[:, :n_half]), max=1e2)
    phase = torch.sin(x[:, n_half:])
    spec_o = torch.complex(magnitude * torch.cos(phase), magnitude * torch.sin(phase))
    return torch.clamp(_istft(spec_o, win), -AUDIO_LIMIT, AUDIO_LIMIT)


def _istft(spec: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """torch.istft(spec, ISTFT_NFFT, ISTFT_HOP, ISTFT_NFFT, window=win,
    center=True) written out: each frame's inverse real FFT, windowed and
    overlap-added, divided by the window's squared overlap-add, the centre
    padding trimmed. torch.istft also checks the window's envelope on the
    host, a read that would wait for the device."""
    n_fft, hop = ISTFT_NFFT, ISTFT_HOP
    n_frames = spec.shape[-1]
    frames = torch.fft.irfft(spec.transpose(1, 2), n=n_fft) * win      # (B, F, n_fft)
    n = n_fft + hop * (n_frames - 1)

    def overlap_add(f):
        return F.fold(f.transpose(1, 2), (1, n), (1, n_fft), stride=(1, hop))[:, 0, 0]

    y = overlap_add(frames)
    env = overlap_add((win * win).expand(1, n_frames, n_fft))
    lo, hi = n_fft // 2, n - n_fft // 2
    return y[:, lo:hi] / env[:, lo:hi]


def hift_inference(params: dict, mel: torch.Tensor,
                   noise: Optional[SourceNoise] = None, generator=None,
                   cache_source: Optional[torch.Tensor] = None,
                   cache_len: Optional[int] = None,
                   phase_carry: Optional[torch.Tensor] = None):
    """mel (B, T, 80) -> (wav (B, T*480), source (B, T*480, 1), f0 (B, T)).

    cache_source replaces the start of the source, so that streamed
    windows join without a glitch:
      * cache_len None: cache_source is the exact prefix, (B, n, 1);
      * cache_len given: cache_source is a buffer at least as long as the
        source, and its first cache_len samples are taken.
    phase_carry goes to hift_source."""
    f0 = f0_predictor_apply(params["f0_predictor"], mel)
    if noise is None:
        noise = SourceNoise.draw(mel.shape[0], mel.shape[1], generator, mel.device)
    s = hift_source(params, f0, noise, phase_carry)
    if cache_source is not None:
        n = min(cache_source.shape[1] if cache_len is None else int(cache_len), s.shape[1])
        if n > 0:
            s = torch.cat([cache_source[:, :n].to(s.dtype), s[:, n:]], dim=1)
    return hift_decode(params, mel, s), s, f0
