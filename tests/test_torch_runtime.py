"""The port's training WAV loader (chatterbox_tpu_torch/runtime: the native
threads of csrc/host/dataload.cpp over csrc/host/wavio.cpp, and the Python
reader where g++ is missing) held against the JAX package's
chatterbox_tpu/runtime: the same clips, in the same order, for the same
seed. The native loaders run the same C++ code, so their clips agree bit
for bit; the Python fallbacks draw the same numpy order."""
import numpy as np
import pytest
from scipy.io import wavfile

from chatterbox_tpu import runtime as jrt

from chatterbox_tpu_torch import runtime as rt
from chatterbox_tpu_torch.utils.audio_io import save_wav


@pytest.fixture(scope="module", autouse=True)
def jax_loader_build(tmp_path_factory):
    """The JAX package builds its loader next to its source at first use;
    build this module's copy elsewhere, so that it never races
    tests/test_runtime.py's build of the same file in another worker."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrt, "_DL_SO", tmp_path_factory.mktemp("jax_loader") / "_dataload.so")
        mp.setattr(jrt, "_DL_LIB", None)
        mp.setattr(jrt, "_DL_TRIED", False)
        yield


@pytest.fixture(scope="module")
def native(jax_loader_build):
    if rt.dataload_lib() is None or jrt.get_dataload_lib() is None:
        pytest.skip("no g++ here")


def _make(tmp_path, n=10):
    """n WAVs of 800 + 50 i samples: float32 mono, then 16-bit mono, then
    16-bit stereo in turn."""
    paths = []
    for i in range(n):
        t = np.arange(800 + 50 * i)
        w = (0.1 * np.sin(t * 0.05 * (1 + i / 7))).astype(np.float32)
        p = tmp_path / f"{i}.wav"
        if i % 3 == 0:
            save_wav(p, w, 16000)
        elif i % 3 == 1:
            wavfile.write(p, 16000, (w * 32767).astype(np.int16))
        else:
            st = np.stack([w, -0.5 * w], axis=1)
            wavfile.write(p, 24000, (st * 32767).astype(np.int16))
        paths.append(p)
    return paths


def _clips(loader):
    items = list(loader)
    loader.close()
    return items


def _assert_same(a, b):
    assert [p for _, p in a] == [p for _, p in b]
    for (wa, _), (wb, _) in zip(a, b):
        np.testing.assert_array_equal(wa, wb)


@pytest.mark.parametrize("seed,epochs,shuffle", [(7, 1, True), (8, 2, True), (0, 1, False)])
def test_native_order_and_clips_match_jax(native, tmp_path, seed, epochs, shuffle):
    paths = _make(tmp_path)
    kw = dict(n_threads=1, max_frames=4000, seed=seed, epochs=epochs, shuffle=shuffle)
    got = _clips(rt.WavLoader(paths, **kw))
    _assert_same(got, _clips(jrt.WavLoader(paths, **kw)))
    assert len(got) == 10 * epochs
    assert np.bincount([p for _, p in got], minlength=10).tolist() == [epochs] * 10
    if epochs == 2:       # each epoch reshuffles
        assert [p for _, p in got[:10]] != [p for _, p in got[10:]]


def test_native_lib_is_built_into_the_build_dir(native):
    assert rt.LIB.parent.name == "_build" and rt.LIB.exists()
    assert rt.WavLoader([__file__], max_frames=10).native


def test_max_frames_crops(native, tmp_path):
    paths = _make(tmp_path)
    got = _clips(rt.WavLoader(paths, n_threads=2, max_frames=600))
    assert len(got) == 10 and all(len(w) == 600 for w, _ in got)
    _assert_same(_clips(rt.WavLoader(paths, n_threads=1, max_frames=900, seed=3)),
                 _clips(jrt.WavLoader(paths, n_threads=1, max_frames=900, seed=3)))


def test_unreadable_files_skipped(native, tmp_path):
    paths = _make(tmp_path, n=4) + [tmp_path / "nope.wav"]
    (tmp_path / "junk.wav").write_bytes(b"RIFF not a wave file")
    paths.append(tmp_path / "junk.wav")
    ld = rt.WavLoader(paths, n_threads=2, max_frames=4000)
    assert sorted(p for _, p in ld) == [0, 1, 2, 3]
    assert ld.errors() == 2
    ld.close()


def test_no_drop_at_epoch_exhaustion(native, tmp_path):
    paths = _make(tmp_path, n=4)
    for it in range(30):
        got = sorted(p for _, p in _clips(rt.WavLoader(paths, n_threads=2, max_frames=4000,
                                                       seed=it)))
        assert got == [0, 1, 2, 3], f"iteration {it}: {got}"


def test_batched_wavs_padding_matches_jax(native, tmp_path):
    paths = _make(tmp_path)
    kw = dict(n_threads=1, max_frames=4000, seed=0)
    got = list(rt.batched_wavs(rt.WavLoader(paths, **kw), 4))
    want = list(jrt.batched_wavs(jrt.WavLoader(paths, **kw), 4))
    assert [b[0].shape[0] for b in got] == [4, 4, 2]
    assert len(got) == len(want)
    for (w, l, p), (jw, jl, jp) in zip(got, want):
        np.testing.assert_array_equal(w, jw)
        np.testing.assert_array_equal(l, jl)
        np.testing.assert_array_equal(p, jp)
        assert w.shape[1] == l.max()
        for i, n in enumerate(l):
            assert (w[i, n:] == 0).all()


def test_python_fallback_matches_jax_fallback_order(tmp_path, monkeypatch):
    """Without g++ both packages read lazily in the same numpy order; the
    port's reader scales 16-bit channels before averaging them, as the
    native reader does, so its clips equal the native loader's."""
    paths = _make(tmp_path, n=6)
    monkeypatch.setattr(rt, "dataload_lib", lambda: None)
    monkeypatch.setattr(jrt, "get_dataload_lib", lambda: None)
    kw = dict(max_frames=4000, epochs=2, seed=3)
    got = _clips(rt.WavLoader(paths, **kw))
    want = _clips(jrt.WavLoader(paths, **kw))
    assert not rt.WavLoader(paths, **kw).native
    assert [p for _, p in got] == [p for _, p in want] and len(got) == 12
    for (w, p), (jw, _) in zip(got, want):
        if p % 3 != 2:                      # mono: the same samples
            np.testing.assert_array_equal(w, jw)
    monkeypatch.undo()
    if rt.dataload_lib() is not None:
        native = {p: w for w, p in _clips(rt.WavLoader(paths, n_threads=1, max_frames=4000))}
        for w, p in got:
            np.testing.assert_allclose(w, native[p], rtol=0, atol=1e-7)


# ---------------------------------------------------------------------------
# the native reader decodes what utils/audio_io.read_wav decodes, and refuses
# (counted by errors()) the headers it cannot decode
# ---------------------------------------------------------------------------

def _riff(path, fmt_tag, channels, bits, block_align, data: bytes, rate=16000, sub=None):
    """A WAV written by hand: a fmt chunk of 16 bytes, or of 40 for
    WAVE_FORMAT_EXTENSIBLE with the subformat GUID of `sub`."""
    import struct
    fmt = struct.pack("<HHIIHH", fmt_tag, channels, rate, rate * block_align, block_align, bits)
    if sub is not None:
        guid = struct.pack("<H", sub) + b"\x00\x00\x00\x00\x10\x00\x80\x00\x00\xAA\x00\x38\x9B\x71"
        fmt += struct.pack("<HHI", 22, bits, (1 << channels) - 1) + guid
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
    body += b"data" + struct.pack("<I", len(data)) + data + b"\x00" * (len(data) % 2)
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)


def _pcm24(x: np.ndarray) -> bytes:
    """int32 samples in 24-bit range as packed little-endian 3-byte words."""
    b = x.astype("<i4").view(np.uint8).reshape(-1, 4)
    return b[:, :3].tobytes()


def _sine(channels: int) -> np.ndarray:
    t = np.arange(700)
    w = 0.5 * np.sin(t * 0.07)
    return w if channels == 1 else np.stack([w, 0.6 * w], axis=1)


@pytest.mark.parametrize("kind", ["u8", "i16", "i24", "i32", "f32", "f64", "ext24"])
@pytest.mark.parametrize("channels", [1, 2])
def test_native_reader_decodes_what_read_wav_decodes(tmp_path, kind, channels):
    """8-bit unsigned, 16-, 24- and 32-bit PCM, 32- and 64-bit float and a
    WAVE_FORMAT_EXTENSIBLE 24-bit file of a 0.5 sine: the native loader's
    clip is read_wav's within 1e-6, and neither is silent (a peak of
    0.5, or 0.4 for the stereo mean of the sine and 0.6 of it)."""
    from chatterbox_tpu_torch.utils.audio_io import read_wav
    if rt.dataload_lib() is None:
        pytest.skip("no g++ here")
    w = _sine(channels)
    p = tmp_path / f"{kind}.wav"
    if kind == "u8":
        wavfile.write(p, 16000, np.round(w * 127 + 128).astype(np.uint8))
    elif kind in ("i16", "i32"):
        bits = int(kind[1:])
        wavfile.write(p, 16000, np.round(w * (2 ** (bits - 1) - 1)).astype(f"int{bits}"))
    elif kind in ("f32", "f64"):
        wavfile.write(p, 16000, w.astype(f"float{kind[1:]}"))
    else:
        data = _pcm24(np.round(w * (2 ** 23 - 1)).astype(np.int32).reshape(-1))
        _riff(p, 0xFFFE if kind == "ext24" else 1, channels, 24, 3 * channels, data,
              sub=1 if kind == "ext24" else None)
    want, _ = read_wav(p)
    ld = rt.WavLoader([p], n_threads=1, max_frames=4000)
    assert ld.native
    got, errors = list(ld), ld.errors()
    ld.close()
    assert errors == 0 and len(got) == 1
    np.testing.assert_allclose(got[0][0], want, rtol=0, atol=1e-6)
    assert abs(np.abs(want).max() - (0.5 if channels == 1 else 0.4)) < 1e-2


@pytest.mark.parametrize("bits", [4, 12])
def test_native_reader_refuses_bits_not_a_multiple_of_8(tmp_path, bits):
    """PCM of 4 bits (a byte a sample) and of 12 bits (two bytes a sample):
    skipped and counted, not read as silence, beside a readable file."""
    if rt.dataload_lib() is None:
        pytest.skip("no g++ here")
    bad = tmp_path / "bad.wav"
    width = 1 if bits <= 8 else 2
    _riff(bad, 1, 1, bits, width, bytes(range(200)) * width)
    good = tmp_path / "good.wav"
    wavfile.write(good, 16000, (_sine(1) * 32767).astype(np.int16))
    ld = rt.WavLoader([bad, good], n_threads=2, max_frames=4000)
    got, errors = list(ld), ld.errors()
    ld.close()
    assert [p for _, p in got] == [1]
    assert errors == 1
