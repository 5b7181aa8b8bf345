"""HiFT's harmonic source in the CUDA kernel's order
(models/s3gen/hift.py, harmonic_phase_framewise and
hift_source_framewise_plain) against the plain float64 cumsum, and the
kernel's wrapper (kernels/hift_source.py) on the CPU: the dispatch, the
launch count and the refusals. The kernel itself runs in
tests/test_torch_cuda.py.

The frame scan keeps every partial sum mod 1 and exact, so the framewise
phase is the exactly rounded one; the plain cumsum rounds once its sum
passes 2^17 cycles where a term has bits below 2^-35 (an f0 under about
6 Hz), and adds the carry to that large sum. Where the cumsum is exact
(voiced frames and silent ones, no carry) the two give the same float32
phases; elsewhere they part by at most 2^-24 cycles."""
from __future__ import annotations

import functools
import types

import numpy as np
import pytest
import torch

from chatterbox_tpu_torch.kernels import hift_source as KS
from chatterbox_tpu_torch.models.s3gen import hift as H

B, T = 2, 2000           # 40 s a row, 960 000 samples
T_CARRY = 500            # the carried case's frames (10 s a row)
SCALE = 80               # the exact phase in units of 2^-80 cycles


@functools.lru_cache(maxsize=None)
def f0_rows(unvoiced: str, T_: int = T) -> torch.Tensor:
    """(B, T_) f0: voiced 60-460 Hz, one unvoiced frame in 40, silent (0
    Hz) or low (0-10 Hz, as the f0 predictor gives where nothing is
    voiced)."""
    rng = np.random.default_rng(7)
    f0 = rng.uniform(60.0, 460.0, (B, T_)).astype(np.float32)
    n = T_ // 40
    for b in range(B):
        idx = rng.choice(T_, n, replace=False)
        f0[b, idx] = 0.0 if unvoiced == "silent" else rng.uniform(0.0, 10.0, n)
    return torch.from_numpy(f0)


def carry_rows(with_carry: bool):
    return torch.from_numpy(np.random.default_rng(8).random((B, 9))) if with_carry else None


def source_inputs(seed: int = 9, T_: int = T):
    g = torch.Generator().manual_seed(seed)
    params = {"m_source_linear": {"w": torch.randn((9, 1), generator=g),
                                  "b": torch.randn((1,), generator=g)}}
    return params, H.SourceNoise.draw(B, T_, g, "cpu")


def _exact(num_den) -> int:
    num, den = num_den
    assert (1 << SCALE) % den == 0          # every operand is on the 2^-80 grid
    return num * ((1 << SCALE) // den)


def _round_f32(u: int) -> float:
    """u * 2^-80 rounded once to float32 (to nearest, ties to even)."""
    shift = u.bit_length() - 24
    if shift > 0:
        q, rem = divmod(u, 1 << shift)
        if 2 * rem > 1 << shift or (2 * rem == 1 << shift and q & 1):
            q += 1
        u = q << shift
    return u / (1 << SCALE)


def exact_phases(f0: torch.Tensor, carry, samples: np.ndarray) -> np.ndarray:
    """The phase mod 1 at the given samples of each row and harmonic, summed
    exactly in integers and rounded once to float32: (B, len, 9)."""
    x = H._harmonic_steps(f0).numpy()                        # (B, T, 9) float32
    out = np.empty((B, len(samples), 9), np.float32)
    k_of = (samples // H.TOTAL_UPSAMPLE).tolist()
    j_of = (samples % H.TOTAL_UPSAMPLE).tolist()
    for b in range(B):
        for h in range(9):
            xs = [_exact(float(v).as_integer_ratio()) for v in x[b, :, h]]
            start = [_exact(float(carry[b, h]).as_integer_ratio()) if carry is not None else 0]
            for v in xs[:-1]:
                start.append(start[-1] + H.TOTAL_UPSAMPLE * v)
            mod = (1 << SCALE) - 1
            out[b, :, h] = [_round_f32((start[k] + (j + 1) * xs[k]) & mod)
                            for k, j in zip(k_of, j_of)]
    return out


def sample_points(T_: int) -> np.ndarray:
    """Samples where rounding would show: each frame's first and last of
    some frames, the ends, and random ones."""
    rng = np.random.default_rng(10)
    n = T_ * H.TOTAL_UPSAMPLE
    frames = rng.choice(T_, 200, replace=False) * H.TOTAL_UPSAMPLE
    return np.unique(np.concatenate([[0, n - 1], frames, frames + H.TOTAL_UPSAMPLE - 1,
                                     rng.integers(0, n, 400)]))


@pytest.fixture(scope="module", params=[("silent", False), ("low", False), ("low", True)],
                ids=["silent", "low", "low-carry"])
def phases(request):
    """f0, the carry and both float32 phases of one case; the carried one
    at T_CARRY frames, where its rounding already shows."""
    unvoiced, with_carry = request.param
    f0, carry = f0_rows(unvoiced, T_CARRY if with_carry else T), carry_rows(with_carry)
    return dict(case=request.param, f0=f0, carry=carry,
                fw=H.harmonic_phase_framewise(f0, carry).float(),
                plain=H.harmonic_phase(f0, carry).float())


def test_framewise_phase_is_the_exactly_rounded_phase(phases):
    T_ = phases["f0"].shape[1]
    pts = sample_points(T_)
    assert phases["fw"].shape == (B, T_ * H.TOTAL_UPSAMPLE, 9)
    np.testing.assert_array_equal(phases["fw"][:, pts].numpy(),
                                  exact_phases(phases["f0"], phases["carry"], pts))


def test_framewise_phase_meets_the_float64_cumsum(phases):
    fw, plain = phases["fw"], phases["plain"]
    if phases["case"] == ("silent", False):
        # the float64 cumsum is exact here: every float32 phase the same
        assert torch.equal(fw, plain)
    else:
        # the cumsum's own rounding, about 1e-9 cycles: at most one float32
        # ulp below 1 apart
        assert (fw - plain).abs().max().item() <= 2.0 ** -24


def _frames(x: torch.Tensor, frames: torch.Tensor) -> torch.Tensor:
    """The samples of the given frames of a (B, T*480, C) tensor."""
    Bx, n, C = x.shape
    return x.reshape(Bx, n // H.TOTAL_UPSAMPLE, H.TOTAL_UPSAMPLE, C)[:, frames].reshape(Bx, -1, C)


def test_framewise_source_matches_the_plain_source(phases):
    """The source, a function of each sample alone, on every frame where the
    two phases part and on 100 others."""
    f0 = phases["f0"]
    params, noise = source_inputs(T_=f0.shape[1])
    parted = (phases["fw"] != phases["plain"]).reshape(B, f0.shape[1], -1).any(2).any(0)
    others = torch.from_numpy(np.random.default_rng(11).choice(f0.shape[1], 100, replace=False))
    frames = torch.unique(torch.cat([parted.nonzero()[:, 0], others]))
    noise = H.SourceNoise(noise.phase, _frames(noise.noise_u, frames))
    fw = H._source_from_phase(params, f0[:, frames], _frames(phases["fw"], frames), noise)
    plain = H._source_from_phase(params, f0[:, frames], _frames(phases["plain"], frames), noise)
    assert fw.shape == (B, len(frames) * H.TOTAL_UPSAMPLE, 1)
    # a phase 2^-24 cycles apart moves a harmonic's sine by < 4e-8
    assert (fw - plain).abs().max().item() <= 1e-6


def test_frame_starts_do_not_depend_on_the_order_of_the_scan():
    """The kernel's order (runs of frames a thread, the runs' sums scanned
    in a tree) gives the sequential scan's bits."""
    x = H._harmonic_steps(f0_rows("low")).double()
    step = torch.remainder(H.TOTAL_UPSAMPLE * x, 1.0)
    seq = torch.zeros_like(step)
    for k in range(1, T):
        seq[:, k] = torch.remainder(seq[:, k - 1] + step[:, k - 1], 1.0)
    per = -(-T // 256)
    runs = torch.zeros((B, 256, 9), dtype=torch.float64)
    for r in range(256):
        for k in range(r * per, min(T, (r + 1) * per)):
            runs[:, r] = torch.remainder(runs[:, r] + step[:, k], 1.0)
    incl, d = runs.clone(), 1
    while d < 256:                                        # Kogge-Stone
        incl[:, d:] = torch.remainder(incl[:, d:] + incl[:, :-d].clone(), 1.0)
        d *= 2
    for r in range(1, 256):
        k0 = r * per
        if k0 < T:
            assert torch.equal(seq[:, k0], incl[:, r - 1])


def test_cpu_call_takes_the_plain_path_and_counts_nothing():
    f0 = f0_rows("low")[:, :24]
    params, _ = source_inputs()
    noise = H.SourceNoise.draw(B, 24, torch.Generator().manual_seed(1), "cpu")
    before = dict(KS.launches)
    out = H.hift_source(params, f0, noise)
    ref = H._source_from_phase(params, f0, H.harmonic_phase(f0), noise)
    assert torch.equal(out, ref) and KS.launches == before
    fw = H.hift_source_framewise_plain(params, f0, noise, carry_rows(True))
    assert (fw - H.hift_source(params, f0, noise, carry_rows(True))).abs().max() <= 1e-6
    assert KS.launches == before
    with pytest.raises(ValueError, match="no path"):
        H.hift_source(params, f0.to("meta"), noise)


class _Lib:
    """Stands in for the kernel library: records each launch's arguments
    and returns the given CUDA error code."""

    def __init__(self, err=0):
        self.err, self.calls = err, []

    def hift_source_launch(self, *args):
        self.calls.append(args)
        return self.err


def _operands(T_mel=3, B_=3, with_carry=True):
    g = torch.Generator().manual_seed(2)
    noise = H.SourceNoise.draw(B_, T_mel, g, "cpu")
    return dict(f0=torch.rand((B_, T_mel), generator=g) * 400, phase=noise.phase,
                noise_u=noise.noise_u, w=torch.randn((9, 1), generator=g),
                b=torch.randn((1,), generator=g),
                phase_carry=torch.rand((B_, 9), generator=g, dtype=torch.float64)
                if with_carry else None)


def _call(ops):
    ops = dict(ops)
    return KS.harmonic_source(ops.pop("f0"), ops.pop("phase"), ops.pop("noise_u"),
                              ops.pop("w"), ops.pop("b"), ops.pop("phase_carry"),
                              frame=H.TOTAL_UPSAMPLE, sample_rate=H.SAMPLE_RATE,
                              sine_amp=H.SINE_AMP, noise_std=H.NOISE_STD,
                              threshold=H.VOICED_THRESHOLD)


@pytest.fixture
def fake_lib(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    libs = {}

    def use(err):
        libs["lib"] = _Lib(err)
        monkeypatch.setattr(KS, "_kernel", lambda: libs["lib"])
        return libs["lib"]
    return use


def test_wrapper_launches_once_a_call_and_passes_the_strides(fake_lib):
    lib = fake_lib(0)
    ops = _operands(T_mel=3, B_=3)
    wide = torch.randn((3, 3 * H.TOTAL_UPSAMPLE, 18))
    ops["noise_u"] = wide[:, :, ::2]                     # a non-contiguous view
    before = KS.launches["hift_source"]
    out = _call(ops)
    assert out.shape == (3, 3 * H.TOTAL_UPSAMPLE, 1) and out.dtype == torch.float32
    assert KS.launches["hift_source"] == before + 1 and len(lib.calls) == 1
    a = lib.calls[0]
    assert a[6:9] == (3 * H.TOTAL_UPSAMPLE * 18, 18, 2)  # the noise's element strides
    assert a[3:5] == (9, 1)                              # the phase's row and harmonic
    assert a[13:16] == (3, 3, H.TOTAL_UPSAMPLE)
    assert a[16] == float(np.float32(1) / np.float32(24000))
    assert a[1] is not None and a[1] == ops["phase_carry"].data_ptr()
    _call(_operands(with_carry=False))
    assert lib.calls[1][1] is None
    fake_lib(700)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        _call(_operands())
    assert KS.launches["hift_source"] == before + 2


@pytest.mark.parametrize("fault,err", [
    ("f0 float64", TypeError), ("noise bf16", TypeError), ("w float64", TypeError),
    ("carry rows", ValueError), ("noise frames", ValueError), ("phase shape", ValueError),
    ("f0 3-D", ValueError), ("f0 empty", ValueError), ("noise on meta", ValueError)])
def test_wrapper_refuses_what_the_kernel_does_not_take(fake_lib, fault, err):
    lib = fake_lib(0)
    ops = _operands()
    if fault == "f0 float64":
        ops["f0"] = ops["f0"].double()
    elif fault == "noise bf16":
        ops["noise_u"] = ops["noise_u"].bfloat16()
    elif fault == "w float64":
        ops["w"] = ops["w"].double()
    elif fault == "carry rows":
        ops["phase_carry"] = ops["phase_carry"][:1]
    elif fault == "noise frames":
        ops["noise_u"] = ops["noise_u"][:, :-1]
    elif fault == "phase shape":
        ops["phase"] = ops["phase"][:, 0]
    elif fault == "f0 3-D":
        ops["f0"] = ops["f0"][..., None]
    elif fault == "f0 empty":
        ops["f0"] = ops["f0"][:, :0]
    else:
        ops["noise_u"] = ops["noise_u"].to("meta")
    with pytest.raises(err):
        _call(ops)
    assert lib.calls == []
