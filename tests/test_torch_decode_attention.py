"""The port's decode-attention functions (kernels/decode_attention.py: B3
`decode_attention_streamed`, B4 `decode_attention_streamed_int8`, B7
`decode_attention`) held against the Pallas kernels of
chatterbox_tpu/ops/pallas_attention.py in interpret mode, at the shapes of
tests/test_pallas_kernels.py; the split kernel's arithmetic
(`split_window_plain`, bf16 and int8 caches) against them too; and the int8
cache quantizer against the JAX one. The port's functions run as their
plain versions (CPU tensors).

Tolerances: with f32 inputs both sides compute the same f32 arithmetic in
another summation order (errors of ~1e-7 on outputs below 1): 1e-5. With
bf16 inputs the output is rounded to bf16, and an f32 difference in the last
bits can round to the neighbouring bf16 value: one bf16 ulp of the output's
magnitude (2**-7 relative, 8e-3)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from chatterbox_tpu.models.t3.backbone import quantize_kv as jquantize_kv  # noqa: E402
from chatterbox_tpu.ops import pallas_attention as J  # noqa: E402

from chatterbox_tpu_torch.kernels import decode_attention as A  # noqa: E402
from chatterbox_tpu_torch.models.t3.backbone import quantize_kv  # noqa: E402

TT = A.TT


def _both(a, dtype):
    """numpy f32 -> (jax array, torch tensor) of `dtype` ("f32" / "bf16")."""
    if dtype == "bf16":
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).bfloat16()
    return jnp.asarray(a), torch.from_numpy(a)


def _inputs(seed, B, H, T, D, dtype, scale=1.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32) * c for s, c in
               (((B, H, 1, D), 1.0), ((B, H, T, D), scale), ((B, H, T, D), scale)))
    return _both(q, dtype), _both(k, dtype), _both(v, dtype)


def _close(out, ref, dtype):
    out = out.float().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert out.shape == ref.shape and np.isfinite(out).all()
    if dtype == "bf16":
        np.testing.assert_allclose(out, ref, rtol=0, atol=2.0 ** -7 * np.abs(ref).max())
    else:
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


# (B, H, T, D, cur, lo): one- and two-tile rows; a dense row, a pad inside
# tile 0 and a pad past a whole tile (tests/test_pallas_kernels.py:82-83);
# a single-key window
STREAMED = [(2, 4, 2 * TT, 16, [7, TT + 13], None),
            (3, 4, 3 * TT, 16, [TT - 1, TT + 40, 2 * TT + 9], [0, 17, TT + 5]),
            (2, 2, TT, 64, [100, 200], [100, 3])]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,H,T,D,cur,lo", STREAMED)
def test_streamed_matches_pallas(B, H, T, D, cur, lo, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _inputs(B * T + D, B, H, T, D, dtype)
    jlo = None if lo is None else jnp.asarray(lo, jnp.int32)
    ref = J.decode_attention_streamed(jq, jk, jv, jnp.asarray(cur, jnp.int32),
                                      interpret=True, lo=jlo)
    before = dict(A.launches)
    out = A.decode_attention_streamed(tq, tk, tv, torch.tensor(cur),
                                      None if lo is None else torch.tensor(lo))
    assert out.dtype == tq.dtype and A.launches == before   # plain version on the CPU
    _close(out, ref, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,H,T,D,cur,lo", STREAMED)
def test_streamed_int8_matches_pallas(B, H, T, D, cur, lo, dtype):
    """Scales stored in bf16 as the int8 cache holds them; K's scale on the
    scores, V's on the weights after the running sum."""
    (jq, tq), (jk, _), (jv, _) = _inputs(B * T + D + 1, B, H, T, D, "f32", scale=0.3)
    if dtype == "bf16":
        jq, tq = jq.astype(jnp.bfloat16), tq.bfloat16()
    k_q, k_s = jquantize_kv(jk)
    v_q, v_s = jquantize_kv(jv)
    k_s, v_s = k_s[..., 0].astype(jnp.bfloat16), v_s[..., 0].astype(jnp.bfloat16)
    jlo = None if lo is None else jnp.asarray(lo, jnp.int32)
    ref = J.decode_attention_streamed_int8(jq, k_q, k_s, v_q, v_s,
                                           jnp.asarray(cur, jnp.int32),
                                           interpret=True, lo=jlo)
    t = lambda a: torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))
    out = A.decode_attention_streamed_int8(
        tq, torch.from_numpy(np.array(k_q)), t(k_s).bfloat16(),
        torch.from_numpy(np.array(v_q)), t(v_s).bfloat16(), torch.tensor(cur),
        None if lo is None else torch.tensor(lo))
    _close(out, ref, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,H,T,D,cur", [(2, 4, 32, 16, [10, 31]),
                                         (1, 4, 300, 64, [257])])
def test_whole_slice_matches_pallas(B, H, T, D, cur, dtype):
    """B7 at cache lengths that are not a multiple of the tile."""
    (jq, tq), (jk, tk), (jv, tv) = _inputs(T + D, B, H, T, D, dtype)
    ref = J.decode_attention(jq, jk, jv, jnp.asarray(cur, jnp.int32), interpret=True)
    out = A.decode_attention(tq, tk, tv, torch.tensor(cur))
    _close(out, ref, dtype)


# The split kernel's arithmetic (B3 / B7 on the card), split_window_plain,
# against the Pallas kernels. T = 768 (3 tiles); row 0 takes the case's
# window, row 1 the same lo with cur_len past the cache (clamped to T - 1).
SPLIT_T = 768
SPLITS = [1, 3, 8, 16]
LOS = {"lo 0": 0, "lo mid-chunk": 37, "lo one past a tile": TT + 1}


def _window(kind, S, lo):
    """Keys in the window: one, fewer than S (one at S = 1), S whole chunks
    of 24 keys (the window ends on a chunk boundary), or up to the end."""
    return {"one key": 1, "fewer than S": max(S - 1, 1), "chunk boundary": 24 * S,
            "whole T": SPLIT_T - lo}[kind]


_PALLAS = {}


def _split_case(n, lo, dtype):
    """(q, k, v, cur, lo) as torch tensors and the Pallas streamed kernel's
    output for a window of n keys from lo (computed once per window)."""
    (jq, tq), (jk, tk), (jv, tv) = _inputs(7, 2, 2, SPLIT_T, 64, "bf16")
    if dtype == "f32":
        jq, tq = jq.astype(jnp.float32), tq.float()
    cur, los = [lo + n - 1, SPLIT_T + 5], [lo, lo]
    key = (n, lo, dtype)
    if key not in _PALLAS:
        _PALLAS[key] = J.decode_attention_streamed(jq, jk, jv, jnp.asarray(cur, jnp.int32),
                                                   interpret=True,
                                                   lo=jnp.asarray(los, jnp.int32))
    return (tq, tk, tv, torch.tensor(cur), torch.tensor(los)), _PALLAS[key]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("lo_kind", list(LOS))
@pytest.mark.parametrize("window", ["one key", "fewer than S", "chunk boundary", "whole T"])
@pytest.mark.parametrize("S", SPLITS)
def test_split_window_matches_pallas(S, window, lo_kind, dtype):
    """Each split's (m, l, acc) and their merge give the Pallas kernel's
    result: bf16 cache, one bf16 ulp of the output for bf16 q (2**-7
    relative, chip_smoke's TOL_ATTN), 1e-5 for f32 q (summation order)."""
    lo = LOS[lo_kind]
    args, ref = _split_case(_window(window, S, lo), lo, dtype)
    out = A.split_window_plain(*args, S)
    assert out.dtype == args[0].dtype
    _close(out, ref, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("S", SPLITS)
def test_split_window_matches_whole_slice_pallas(S, dtype):
    """B7's form: lo None over a cache of 300 keys (not a multiple of the
    tile), one row with one key and one past the cache."""
    key = ("B7", dtype)
    (jq, tq), (jk, tk), (jv, tv) = _inputs(8, 2, 2, 300, 64, dtype)
    cur = [0, 310]
    if key not in _PALLAS:
        _PALLAS[key] = J.decode_attention(jq, jk, jv, jnp.asarray(cur, jnp.int32),
                                          interpret=True)
    _close(A.split_window_plain(tq, tk, tv, torch.tensor(cur), None, S), _PALLAS[key], dtype)


def test_split_window_of_an_empty_window_is_zero():
    (_, tq), (_, tk), (_, tv) = _inputs(9, 1, 2, TT, 64, "bf16")
    out = A.split_window_plain(tq, tk, tv, torch.tensor([40]), torch.tensor([41]), 8)
    assert out.shape == (1, 2, 1, 64) and not out.float().abs().max()


# The split kernel over the int8 cache (B4 on the card): chunks start on
# multiples of 8 keys, the keys below lo masked; the scales fold into the
# scores (K) and the weights (V). Per-row windows whose lo and cur are not
# multiples of 8 (the batched engine's left pads among them), at the row
# counts of the paths (Turbo 1, the 520M pair 2, eight batched rows).
INT8_ROWS = {1: ([5], [530]), 2: ([3, 0], [190, 301]),
             8: ([0, 3, 9, 17, 40, 100, 257, 300], [540, 539, 531, 700, 541, 766, 767, 301])}


def _int8_cache(seed, B, H, T, D, dtype):
    """(q, k_q, k_s, v_q, v_s) as JAX arrays and torch tensors, the scales
    in bf16 as the int8 cache holds them."""
    (jq, tq), (jk, _), (jv, _) = _inputs(seed, B, H, T, D, "f32", scale=0.3)
    if dtype == "bf16":
        jq, tq = jq.astype(jnp.bfloat16), tq.bfloat16()
    k_q, k_s = jquantize_kv(jk)
    v_q, v_s = jquantize_kv(jv)
    k_s, v_s = k_s[..., 0].astype(jnp.bfloat16), v_s[..., 0].astype(jnp.bfloat16)
    t = lambda a: torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))
    return ((jq, k_q, k_s, v_q, v_s),
            (tq, torch.from_numpy(np.array(k_q)), t(k_s).bfloat16(),
             torch.from_numpy(np.array(v_q)), t(v_s).bfloat16()))


def _int8_pallas(key, jops, cur, lo):
    if key not in _PALLAS:
        jq, k_q, k_s, v_q, v_s = jops
        _PALLAS[key] = J.decode_attention_streamed_int8(
            jq, k_q, k_s, v_q, v_s, jnp.asarray(cur, jnp.int32), interpret=True,
            lo=jnp.asarray(lo, jnp.int32))
    return _PALLAS[key]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B", sorted(INT8_ROWS))
@pytest.mark.parametrize("S", SPLITS)
def test_split_window_int8_matches_pallas(S, B, dtype):
    """Each split's (m, l, acc) over its 8-key-aligned chunk and their merge
    give the Pallas int8 kernel's result: 1e-5 for f32 q (summation order),
    one bf16 ulp of the output for bf16 q."""
    lo, cur = INT8_ROWS[B]
    jops, ops = _int8_cache(20 + B, B, 2, SPLIT_T, 64, dtype)
    ref = _int8_pallas(("int8", B, dtype), jops, cur, lo)
    q, k_q, k_s, v_q, v_s = ops
    out = A.split_window_plain(q, k_q, v_q, torch.tensor(cur), torch.tensor(lo), S, k_s, v_s)
    assert out.dtype == q.dtype
    _close(out, ref, dtype)


@pytest.mark.parametrize("lo", [3, 37, TT + 1])
@pytest.mark.parametrize("window", ["one key", "fewer than S", "chunk boundary", "whole T"])
@pytest.mark.parametrize("S", SPLITS)
def test_split_window_int8_at_unaligned_lower_bounds(S, window, lo):
    """The windows of test_split_window_matches_pallas from lower bounds
    that are not multiples of 8 (chunk 0 starts below lo): bf16 q, row 1
    with cur_len past the cache."""
    n = _window(window, S, lo)
    cur, los = [lo + n - 1, SPLIT_T + 5], [lo, lo]
    jops, ops = _int8_cache(30, 2, 2, SPLIT_T, 64, "bf16")
    ref = _int8_pallas(("int8", n, lo), jops, cur, los)
    q, k_q, k_s, v_q, v_s = ops
    _close(A.split_window_plain(q, k_q, v_q, torch.tensor(cur), torch.tensor(los), S, k_s,
                                v_s), ref, "bf16")


def test_split_window_int8_of_an_empty_window_is_zero():
    _, (q, k_q, k_s, v_q, v_s) = _int8_cache(31, 1, 2, TT, 64, "bf16")
    for lo, cur in ((41, 40), (8, 7)):            # lo unaligned and aligned
        out = A.split_window_plain(q, k_q, v_q, torch.tensor([cur]), torch.tensor([lo]), 8,
                                   k_s, v_s)
        assert out.shape == (1, 2, 1, 64) and not out.float().abs().max()


class _SplitLib:
    """Stands in for the attention library: records the split count and
    whether scales were passed to each launch."""

    def __init__(self):
        self.calls = []

    def split_decode_launch(self, *args):
        self.calls.append((args[13], args[4] is not None))
        return 0


def test_int8_launch_takes_its_split_count_from_the_cache_shape_only(monkeypatch):
    """B4's wrapper launches the split kernel with its scales at
    split_count_int8(B, H, T) whatever cur_len and lo hold, and counts the
    launch; the plain version is never called for a device tensor."""
    import types
    lib = _SplitLib()
    monkeypatch.setattr(A, "_kernel", lambda: lib)
    monkeypatch.setattr(A, "_check_device", lambda x: True)
    monkeypatch.setattr(A, "decode_attention_streamed_int8_plain",
                        lambda *a, **k: pytest.fail("plain version"))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    for B, T in ((1, 768), (2, 512), (8, 768), (1, 1536)):
        _, (q, k_q, k_s, v_q, v_s) = _int8_cache(32, B, 16, T, 64, "bf16")
        before = A.launches["decode_attention_streamed_int8"]
        for cur, lo in ((5, 0), (T - 1, 3), (T + 9, T // 2 + 1)):
            A.decode_attention_streamed_int8(q, k_q, k_s, v_q, v_s, torch.full((B,), cur),
                                             torch.full((B,), lo))
        assert lib.calls[-3:] == [(A.split_count_int8(B, 16, T), True)] * 3
        assert A.launches["decode_attention_streamed_int8"] == before + 3


@pytest.mark.parametrize("B,H,T,S", [(1, 16, 768, 8), (1, 16, 657, 8), (2, 16, 512, 4),
                                     (8, 16, 768, 2), (16, 16, 768, 1), (1, 16, 1536, 8),
                                     (1, 16, 64, 1), (1, 4, 256, 2)])
def test_split_count_depends_on_the_cache_shape_only(B, H, T, S):
    assert A.split_count(B, H, T) == S
    assert 1 <= S <= A.SPLIT_CAP <= A.MAX_SPLITS


# B4's count: half the bf16 cache's splits where a full cache would leave
# fewer than SPLIT_KEYS_INT8 keys a split (Turbo T=768, the 520M pair), at
# most SPLIT_CAP_INT8 (Turbo T=1536), and none past SPLIT_BLOCKS_INT8 blocks
# (eight rows).
@pytest.mark.parametrize("B,H,T,S", [(1, 16, 768, 4), (2, 16, 512, 2), (8, 16, 768, 1),
                                     (16, 16, 768, 1), (1, 16, 1536, 4), (1, 16, 2048, 4),
                                     (1, 16, 256, 1), (1, 4, 512, 2)])
def test_int8_split_count_depends_on_the_cache_shape_only(B, H, T, S):
    assert A.split_count_int8(B, H, T) == S
    assert S <= A.split_count(B, H, T) <= A.SPLIT_CAP
    assert S <= A.SPLIT_CAP_INT8


def test_streamed_refuses_an_unaligned_cache_on_the_kernel_route():
    """The tile precondition is the JAX package's; on the CPU the plain
    version runs whatever T, and a device that is neither CPU nor CUDA
    raises rather than falling back."""
    (_, tq), (_, tk), (_, tv) = _inputs(0, 1, 2, 100, 16, "f32")
    out = A.decode_attention_streamed(tq, tk, tv, torch.tensor([50]))
    assert out.shape == (1, 2, 1, 16)
    with pytest.raises(ValueError):
        A.decode_attention_streamed(tq.to("meta"), tk.to("meta"), tv.to("meta"),
                                    torch.tensor([50]))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_kv_matches_jax_exactly(dtype):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 4, 9, 16)).astype(np.float32) * 3
    x[0, 0, 0] = 0.0                               # an all-zero position
    jx, tx = _both(x, dtype)
    jq, js = jquantize_kv(jx)
    q, s = quantize_kv(tx)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q.dtype == torch.int8 and s.shape == (2, 4, 9, 1)


def test_window_check_raises_on_an_empty_window():
    A.check_window([0, 17, TT + 5], TT + 5)
    A.check_window([3, 4], [3, 9])
    with pytest.raises(ValueError, match="rows \\[1\\]"):
        A.check_window([0, 10], [5, 9])
    with pytest.raises(ValueError):
        A.check_window([300], 299)
