"""The port's int4 weight serving held against chatterbox_tpu on the JAX CPU
backend (its Pallas kernels in interpret mode; the port's kernels as their
plain versions, on CPU tensors): the packings and modes of utils/quantize.py,
B8 `matmul_int4` and the dense paths of kernels/int4_matmul.py, the int4
branches of `nn.linear`, B9 `ln_qkv_int4` and B10 `attnout_ln_mlp_int4` of
kernels/fused_layer.py, the converter, T3 in the `int4_fused` (Turbo) and
`int4` (520M family, CFG) modes, and ChatterboxTurboTTS on an int4_fused
T3."""
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from chatterbox_tpu.nn import core as jnn  # noqa: E402
from chatterbox_tpu.ops import fused_layer as JF  # noqa: E402
from chatterbox_tpu.ops import int4_matmul as JM  # noqa: E402
from chatterbox_tpu.ops import sampling as JS  # noqa: E402
from chatterbox_tpu.sampling.decode import t3_generate as jax_generate  # noqa: E402
from chatterbox_tpu.utils import quantize as JQ  # noqa: E402

from chatterbox_tpu_torch.convert.from_jax import t3_from_jax  # noqa: E402
from chatterbox_tpu_torch.kernels import fused_layer as K  # noqa: E402
from chatterbox_tpu_torch.kernels import int4_matmul as M  # noqa: E402
from chatterbox_tpu_torch.nn import core as nn  # noqa: E402
from chatterbox_tpu_torch.ops import sampling as S  # noqa: E402
from chatterbox_tpu_torch.sampling.decode import t3_generate  # noqa: E402
from chatterbox_tpu_torch.utils import quantize as Q  # noqa: E402
from tests import test_torch_t3 as T  # noqa: E402
from tests import test_torch_t3_llama as L  # noqa: E402

EPS = 1e-5


def _t(a):
    """JAX array -> torch tensor of the same values and type."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _om(a):
    """JAX array -> torch tensor of the same shape stored out-major (.T
    contiguous), as the port stores int4 leaves."""
    return _t(np.ascontiguousarray(np.asarray(a).T)).T


def _tt(a):
    """JAX array -> its transpose as a contiguous torch tensor (the fused
    kernels' out-major operands)."""
    return _t(np.ascontiguousarray(np.asarray(a).T))


def _act(rng, shape, dtype, scale=1.0):
    return jnp.asarray((rng.standard_normal(shape) * scale).astype(np.float32)).astype(dtype)


def _w(rng, shape, halves=False):
    """A float weight; with `halves`, values k/2 and a 7 at the top of every
    256-row group, so each group's scale is 1 and many values sit exactly on
    a rounding midpoint (rounded half to even)."""
    if not halves:
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)
    w = (rng.integers(-13, 14, shape) / 2).astype(np.float32)
    w[::256] = 7.0
    return w


# ---------------------------------------------------------------------------
# packings
# ---------------------------------------------------------------------------

# (384, 512): the degenerate group (one group per half / one over the rows)
@pytest.mark.parametrize("shape,split,halves", [
    ((1024, 512), "row", False), ((1024, 512), "row", True), ((384, 512), "row", False),
    ((512, 2048), "col", False), ((512, 2048), "col", True), ((384, 512), "col", False)])
def test_int4_packings_equal_jax(shape, split, halves):
    w = _w(np.random.default_rng(sum(shape)), shape, halves)
    jf, f = ((JQ.quantize_linear_weight_int4, Q.quantize_linear_weight_int4) if split == "row"
             else (JQ.quantize_linear_weight_int4_colsplit,
                   Q.quantize_linear_weight_int4_colsplit))
    ref, out = jf(jnp.asarray(w)), f(torch.from_numpy(w))
    for r, o, dt in zip(ref, out, (torch.int8, torch.float32, torch.float32)):
        assert o.dtype == dt
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    if halves:
        assert (out[1] == 1).all()


def test_unpack_int4_equals_jax_on_every_byte():
    b = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    for r, o in zip(JQ.unpack_int4(jnp.asarray(b)), Q.unpack_int4(torch.from_numpy(b))):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_quantize_tree_int4_packs_where_the_kernel_takes_the_shape():
    """(1024, 512) packs in int4; (768, 1536) (Nano's width) and (1024, 640)
    fall back to int8, in both packages. The int4 leaves are stored
    out-major."""
    rng = np.random.default_rng(3)
    tree = {"a": {"w": _w(rng, (1024, 512)), "b": np.zeros(512, np.float32)},
            "b": {"w": _w(rng, (768, 1536))}, "c": {"w": _w(rng, (1024, 640))}}
    ref = JQ.quantize_tree(jax.tree.map(jnp.asarray, tree), mode="int4")
    out = Q.quantize_tree({k: {n: torch.from_numpy(v) for n, v in d.items()}
                           for k, d in tree.items()}, mode="int4")
    assert set(out["a"]) == {"w_q4", "w_scale4_lo", "w_scale4_hi", "b"}
    assert set(out["b"]) == set(out["c"]) == {"w_q", "w_scale"}
    for k in tree:
        assert set(out[k]) == set(ref[k])
        for n in out[k]:
            np.testing.assert_array_equal(out[k][n].numpy(), np.asarray(ref[k][n]))
    assert out["a"]["w_q4"].T.is_contiguous() and out["a"]["w_scale4_lo"].T.is_contiguous()


# ---------------------------------------------------------------------------
# B8 and nn.linear
# ---------------------------------------------------------------------------

def _packed(rng, k, n):
    return JQ.quantize_linear_weight_int4(jnp.asarray(_w(rng, (k, n))))


# The plain version and the Pallas kernel sum the same exact f32 products
# (bf16 x times small integers) group by group; they agree to f32 summation
# order (1e-7 of outputs of order 1 measured).
@pytest.mark.parametrize("B,K,N,dtype", [(1, 1024, 512, jnp.bfloat16),
                                         (2, 1024, 1024, jnp.bfloat16),
                                         (8, 2048, 512, jnp.float32)])
def test_matmul_int4_plain_matches_pallas(B, K, N, dtype):
    rng = np.random.default_rng(B + K)
    wq, slo, shi = _packed(rng, K, N)
    x = _act(rng, (B, K), dtype)
    ref = np.asarray(JM.matmul_int4(x, wq, slo, shi, interpret=True))
    out = M.matmul_int4(_t(x), _om(wq), _om(slo), _om(shi))
    assert out.dtype == torch.float32 and out.shape == (B, N)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


# B8 writes its result in the type the caller names. With integer x and
# half-integer weights at scale 1 every f32 sum is exact in any order, so
# the bf16 result equals the Pallas kernel's f32 result rounded to bf16 bit
# for bit, ties to even included (sums such as 257.5 sit on a tie). With
# random inputs the f32 sums of the two orders may differ in their last
# bits, so there the bf16 result is held, bit for bit, to the f32 result of
# the same call cast to bf16: the cast it replaces in nn.linear.
@pytest.mark.parametrize("B,K,N,dtype", [(1, 1024, 512, jnp.bfloat16),
                                         (2, 2048, 1024, jnp.float32),
                                         (8, 1024, 512, jnp.bfloat16)])
def test_matmul_int4_bf16_out_matches_pallas_bit_for_bit(B, K, N, dtype):
    rng = np.random.default_rng(B + K + 1)
    wq, slo, shi = JQ.quantize_linear_weight_int4(jnp.asarray(_w(rng, (K, N), halves=True)))
    assert float(jnp.max(slo)) == float(jnp.min(shi)) == 1.0
    x = jnp.asarray(rng.integers(-40, 41, (B, K)).astype(np.float32)).astype(dtype)
    ref = JM.matmul_int4(x, wq, slo, shi, interpret=True).astype(jnp.bfloat16)
    out = M.matmul_int4(_t(x), _om(wq), _om(slo), _om(shi), torch.bfloat16)
    assert out.dtype == torch.bfloat16 and out.shape == (B, N)
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref.astype(jnp.float32)))
    x = _act(rng, (B, K), dtype)
    args = (_t(x), _om(wq), _om(slo), _om(shi))
    assert torch.equal(M.matmul_int4(*args, torch.bfloat16),
                       M.matmul_int4(*args).to(torch.bfloat16))


# The kernel's order of sums (packed rows split over 1, 2 or 4 blocks, eight
# warps a block, each group's sums scaled where a warp's run leaves the
# group) against the Pallas kernel, to f32 summation order as above; K =
# 1024 gives each warp a quarter of a group, K = 4096 one or more groups.
@pytest.mark.parametrize("B,K,N", [(2, 1024, 512), (8, 4096, 512), (1, 2048, 512)])
@pytest.mark.parametrize("splits", [1, 2, 4])
def test_matmul_int4_split_order_matches_pallas(B, K, N, splits):
    rng = np.random.default_rng(B + K + splits)
    wq, slo, shi = _packed(rng, K, N)
    x = _act(rng, (B, K), jnp.bfloat16)
    ref = np.asarray(JM.matmul_int4(x, wq, slo, shi, interpret=True))
    out = M.matmul_int4_split_plain(_t(x), _om(wq), _om(slo), _om(shi), splits)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("B", [1, 2, 8])
def test_int4_tiling_takes_whole_chunks_within_shared_memory(B):
    """Every 520M linear shape (q/k/v/o, gate/up, down) and wider ones: a
    tiling the kernel has, whole CHUNK-row chunks a block, within shared
    memory, and no block taking more packed rows than INT4_SPAN* unless
    MAX_SPLITS blocks already share them."""
    span = M.INT4_SPAN if B <= 4 else M.INT4_SPAN_MANY_ROWS
    for K, N in ((1024, 1024), (1024, 4096), (4096, 1024), (512, 512), (8192, 1024)):
        cols, splits = M.int4_tiling(K // 2, N, B)
        assert cols in (16, 32) and splits in (1, 2, M.MAX_SPLITS), (K, N)
        assert N % cols == 0 and (K // 2) % (splits * M.CHUNK) == 0, (K, N)
        assert M.int4_smem(cols, splits, K // 2) <= M.SMEM_LIMIT, (K, N)
        assert K // 2 // splits <= span or splits == M.MAX_SPLITS, (K, N)


# nn.linear casts the f32 product to x's type (bf16) and adds the bias in
# bf16. B8's rows agree to f32 rounding before the cast, so a value may land
# one bf16 ulp away (2**-8 of its magnitude, bias included); the dense paths
# repeat the JAX package's bf16 arithmetic (equal in the runs seen).
@pytest.mark.parametrize("rows,leaf", [((1, 5), "w_q4"), ((2, 6), "w_q4"), ((2, 6), "w_q4c")])
def test_linear_int4_branches_match_jax(rows, leaf):
    rng = np.random.default_rng(sum(rows) + len(leaf))
    K, N = 1024, 1024
    w = jnp.asarray(_w(rng, (K, N)))
    if leaf == "w_q4":
        packed, keys = JQ.quantize_linear_weight_int4(w), ("w_q4", "w_scale4_lo", "w_scale4_hi")
    else:
        packed = JQ.quantize_linear_weight_int4_colsplit(w)
        keys = ("w_q4c", "w_scale4c_lo", "w_scale4c_hi")
    b = jnp.asarray((rng.standard_normal(N) * 0.1).astype(np.float32)).astype(jnp.bfloat16)
    jp = dict(zip(keys, packed), b=b)
    tp = {k: _om(v) for k, v in zip(keys, packed)}
    tp["b"] = _t(b)
    x = _act(rng, rows + (K,), jnp.bfloat16)
    ref = np.asarray(jnn.linear(jp, x).astype(jnp.float32))
    out = nn.linear(tp, _t(x))
    assert out.dtype == torch.bfloat16 and out.shape == rows + (N,)
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=2.0 ** -8, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_linear_int4_returns_x_type_with_the_values_of_the_cast(dtype):
    """B8 now rounds to x's type itself: nn.linear's result is bit for bit
    the f32 product cast to x's type plus the bias, as it was."""
    rng = np.random.default_rng(12)
    wq, slo, shi = (_om(a) for a in _packed(rng, 1024, 512))
    b = torch.from_numpy(_vec(rng, 512, 0.1)).to(dtype)
    x = torch.from_numpy(rng.standard_normal((2, 1, 1024)).astype(np.float32)).to(dtype)
    out = nn.linear({"w_q4": wq, "w_scale4_lo": slo, "w_scale4_hi": shi, "b": b}, x)
    before = M.matmul_int4(x.reshape(2, 1024), wq, slo, shi).to(dtype).reshape(2, 1, 512) + b
    assert out.dtype == dtype and torch.equal(out, before)


def test_linear_sends_only_decode_sized_inputs_to_b8(monkeypatch):
    rng = np.random.default_rng(9)
    wq, slo, shi = _packed(rng, 1024, 512)
    p = {"w_q4": _om(wq), "w_scale4_lo": _om(slo), "w_scale4_hi": _om(shi)}
    seen = []
    real = nn.matmul_int4
    monkeypatch.setattr(nn, "matmul_int4", lambda *a: seen.append(a[0].shape[0]) or real(*a))
    for rows in (1, 8, 9, 40):
        nn.linear(p, torch.ones(rows, 1024, dtype=torch.bfloat16))
    assert seen == [1, 8]


# ---------------------------------------------------------------------------
# B9 and B10
# ---------------------------------------------------------------------------

def _b8(v):
    return jnp.broadcast_to(jnp.asarray(v)[None], (8, v.shape[0]))


def _vec(rng, n, scale=0.01, offset=0.0):
    return (offset + scale * rng.standard_normal(n)).astype(np.float32)


# B9 sums exact f32 products in another order than the Pallas kernel (f32
# rounding on outputs of order 1). B10 also rounds LN2 and the hidden units
# to bf16: where the two orders put a value on either side of a rounding
# boundary, that unit moves the outputs by up to ulp(h) * 7 * s2 ~ 1e-4.
@pytest.mark.parametrize("B,dtype", [(1, jnp.bfloat16), (2, jnp.bfloat16), (2, jnp.float32)])
def test_ln_qkv_int4_plain_matches_pallas(B, dtype):
    rng = np.random.default_rng(10 + B)
    D = 512
    x = _act(rng, (B, D), dtype)
    g, be, bias = _vec(rng, D, 0.1, 1.0), _vec(rng, D, 0.1), _vec(rng, 3 * D)
    wp, slo, shi = _packed(rng, D, 3 * D)
    ref = np.asarray(JF.ln_qkv_int4(x, _b8(g), _b8(be), wp, slo, shi, _b8(bias), eps=EPS,
                                    interpret=True))
    out = K.ln_qkv_int4(_t(x), _t(g), _t(be), _tt(wp), _tt(slo), _tt(shi), _t(bias), EPS)
    assert out.dtype == torch.float32 and out.shape == (B, 3 * D)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)


# B9's kernel order (int4_block_sum onto the bias: eight warps' runs of
# 64-row chunks, each group's sums scaled where a run leaves the group)
# at the kernel's row tiles (1-8 rows one MMA tile, 9-16 two) and both x
# types; the columns a block owns (the tiling) change no sum. Against the
# plain version, which shares its LayerNorm: f32 summation order (1e-5 of
# outputs of order 1). Against the Pallas kernel: that, plus a norm value
# that the two packages' f32 LayerNorm sums put on either side of a bf16
# rounding boundary (one of 4096 in a run seen at 8 rows), which moves its
# row's outputs by ulp(y) * 7 * s, at most 2**-7 * max|y| * 7 * max(s).
@pytest.mark.parametrize("B", [1, 2, 8, 16])
@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
@pytest.mark.parametrize("D", [512, 1024])
def test_ln_qkv_int4_split_order_matches_pallas(B, dtype, D):
    rng = np.random.default_rng(100 + B + D)
    x = _act(rng, (B, D), dtype)
    g, be, bias = _vec(rng, D, 0.1, 1.0), _vec(rng, D, 0.1), _vec(rng, 3 * D)
    wp, slo, shi = _packed(rng, D, 3 * D)
    ref = np.asarray(JF.ln_qkv_int4(x, _b8(g), _b8(be), wp, slo, shi, _b8(bias), eps=EPS,
                                    interpret=True))
    args = (_t(x), _t(g), _t(be), _tt(wp), _tt(slo), _tt(shi), _t(bias), EPS)
    out = K.ln_qkv_int4_split_plain(*args)
    assert out.dtype == torch.float32 and out.shape == (B, 3 * D)
    np.testing.assert_allclose(out.numpy(), K.ln_qkv_int4_plain(*args).numpy(), rtol=0,
                               atol=1e-5)
    y_max = K._ln_bf16(*args[:3], EPS).abs().max().item()
    s_max = max(np.abs(np.asarray(slo)).max(), np.abs(np.asarray(shi)).max())
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-4 + 2.0 ** -7 * y_max * 7 * s_max)


@pytest.mark.parametrize("B", [1, 2, 8, 9, 16])
def test_ln_qkv_int4_tiling_fits_every_shape_the_kernel_takes(B):
    """Columns a block from QKV4_COLS dividing N, within shared memory, at D
    512-4096; the Turbo shape takes the first choice; a width whose norm
    rows alone overflow shared memory has no tiling."""
    for D in (512, 1024, 2048, 4096):
        N = 3 * D
        cols = K.ln_qkv_int4_tiling(B, D, N)
        assert cols in K.QKV4_COLS and N % cols == 0, D
        assert K.int4_smem(cols, 1, D // 2, B, ln=True) <= K.SMEM_LIMIT, D
    assert K.ln_qkv_int4_tiling(B, 1024, 3072) == K.QKV4_COLS[0]
    assert K.ln_qkv_int4_tiling(B, 1024, 3072 + 8) is None
    assert K.ln_qkv_int4_tiling(16, 8192, 3 * 8192) is None


def _b10_operands(rng, D, I):
    wo_p, so_lo, so_hi = _packed(rng, D, D)
    w1c, s1_lo, s1_hi = JQ.quantize_linear_weight_int4_colsplit(jnp.asarray(_w(rng, (D, I))))
    w2p, s2_lo, s2_hi = _packed(rng, I, D)
    vec = dict(bo=_vec(rng, D), g2=_vec(rng, D, 0.1, 1.0), be2=_vec(rng, D, 0.1),
               b1=_vec(rng, I), b2=_vec(rng, D))
    return (wo_p, so_lo, so_hi, w1c, s1_lo, s1_hi, w2p, s2_lo, s2_hi), vec


@pytest.mark.parametrize("B,dtype", [(1, jnp.bfloat16), (2, jnp.bfloat16), (2, jnp.float32)])
def test_attnout_ln_mlp_int4_plain_matches_pallas(B, dtype):
    """Two packings meet here (fc_in column split, Wo and W2 row split): a
    half taken the wrong way round gives plausible numbers, so the plain
    version is held against the Pallas kernel itself."""
    rng = np.random.default_rng(20 + B)
    D, I = 512, 2048
    (wo, so_lo, so_hi, w1c, s1_lo, s1_hi, w2p, s2_lo, s2_hi), v = _b10_operands(rng, D, I)
    a, xres = _act(rng, (B, D), dtype, 0.5), _act(rng, (B, D), dtype)
    ref = np.asarray(JF.attnout_ln_mlp_int4(
        a, xres, wo, so_lo, so_hi, _b8(v["bo"]), _b8(v["g2"]), _b8(v["be2"]), w1c, s1_lo,
        s1_hi, _b8(v["b1"]), w2p, s2_lo, s2_hi, _b8(v["b2"]), eps=EPS, interpret=True))
    out = K.attnout_ln_mlp_int4(
        _t(a), _t(xres), _tt(wo), _tt(so_lo), _tt(so_hi), _t(v["bo"]), _t(v["g2"]),
        _t(v["be2"]), _tt(w1c), _tt(s1_lo), _tt(s1_hi), _t(v["b1"]), _tt(w2p), _tt(s2_lo),
        _tt(s2_hi), _t(v["b2"]), EPS)
    assert out.dtype == torch.float32 and out.shape == (B, D)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-3)


_B10_PALLAS = {}


def _b10_case(B, D, dtype):
    """B10's torch operands (the port's layout) and the Pallas kernel's
    output at B rows of width D (I = 2048), computed once per case."""
    rng = np.random.default_rng(40 + B + D)
    (wo, so_lo, so_hi, w1c, s1_lo, s1_hi, w2p, s2_lo, s2_hi), v = _b10_operands(rng, D, 2048)
    a, xres = _act(rng, (B, D), dtype, 0.5), _act(rng, (B, D), dtype)
    key = (B, D, dtype)
    if key not in _B10_PALLAS:
        _B10_PALLAS[key] = np.asarray(JF.attnout_ln_mlp_int4(
            a, xres, wo, so_lo, so_hi, _b8(v["bo"]), _b8(v["g2"]), _b8(v["be2"]), w1c, s1_lo,
            s1_hi, _b8(v["b1"]), w2p, s2_lo, s2_hi, _b8(v["b2"]), eps=EPS, interpret=True))
    return (_t(a), _t(xres), _tt(wo), _tt(so_lo), _tt(so_hi), _t(v["bo"]), _t(v["g2"]),
            _t(v["be2"]), _tt(w1c), _tt(s1_lo), _tt(s1_hi), _t(v["b1"]), _tt(w2p),
            _tt(s2_lo), _tt(s2_hi), _t(v["b2"]), EPS), _B10_PALLAS[key]


# B10's kernel order (attnout_ln_mlp_int4_split_plain: int4_block_sum for
# each phase, fc_out's packed rows over 1, 2 or 4 blocks of a cluster: every
# split int4_mlp_tiling can pick; the columns a block owns change no sum) at
# the kernel's row tiles and both input types, against the Pallas kernel.
# With no bf16 rounding crossed the orders agree to ~1e-6 on outputs of
# order 1-5. But LN2's output and the hidden units are rounded to bf16, and
# a value of y that two orders of f32 sums put on either side of a rounding
# boundary moves every hidden unit of its row, and so its outputs: the
# plain version, in the Pallas order but with torch's LayerNorm sums, is
# 1.21e-3 off the Pallas kernel at 8 rows, D = 1024, and the kernel's order
# 1.23e-3 there and 4.3e-4 at 2 rows (f32 input), where the plain version
# crosses nothing. Tolerance 2e-3 (4e-4 of the outputs' magnitude); a
# half taken the wrong way round, or a scale on the wrong group, moves
# outputs by 1e-1 and more.
@pytest.mark.parametrize("down_splits", [1, 2, 4])
@pytest.mark.parametrize("B", [1, 2, 8, 16])
@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
@pytest.mark.parametrize("D", [512, 1024])
def test_attnout_ln_mlp_int4_split_order_matches_pallas(down_splits, B, dtype, D):
    args, ref = _b10_case(B, D, dtype)
    out = K.attnout_ln_mlp_int4_split_plain(*args, down_splits)
    assert out.dtype == torch.float32 and out.shape == (B, D)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=2e-3)


@pytest.mark.parametrize("B", [1, 2, 8, 9, 16])
def test_int4_mlp_tiling_fits_every_shape_the_kernel_takes(B):
    """B10's tiling within shared memory at D 512-2048 and I up to 8192:
    each phase's columns from its list dividing its width, fc_out's packed
    rows in whole 64-row chunks of each block; the Turbo shape takes the
    first choices (fc_in's from the short list at up to MLP4_FEW_ROWS
    rows) and fc_out split TC_MAX_SPLITS ways (blocks of 512 packed rows);
    none fits a width whose norm rows alone overflow shared memory."""
    for D, I in ((512, 2048), (1024, 4096), (2048, 4096), (2048, 8192)):
        attn, fc_in, down, splits, pdl = K.int4_mlp_tiling(B, D, I)
        K.int4_mlp_limits("B10", B, D, I, attn, fc_in, down, splits)
        assert pdl == K.MLP4_PDL and (I // 2) % (splits * K.TC_CHUNK) == 0
        if (D, I) == (1024, 4096):
            few = B <= K.MLP4_FEW_ROWS
            assert (attn, fc_in, down) == (
                K.MLP4_ATTN_COLS[0], (K.MLP4_FC_IN_COLS_FEW if few else K.MLP4_FC_IN_COLS)[0],
                K.MLP4_DOWN_COLS[0])
            assert splits == K.TC_MAX_SPLITS
    assert K.int4_mlp_tiling(B, 8192, 4096) is None
    with pytest.raises(ValueError):          # 3 fc_out blocks
        K.int4_mlp_limits("B10", B, 1024, 4096, 16, 32, 16, 3)
    with pytest.raises(ValueError):          # 24 packed columns an fc_in block
        K.int4_mlp_limits("B10", B, 1024, 4096, 16, 24, 16, 2)
    with pytest.raises(ValueError):          # fc_out blocks of 32 packed rows
        K.int4_mlp_limits("B10", B, 1024, 256, 16, 32, 16, 4)


def test_cpu_dispatch_is_the_plain_version_and_counts_nothing():
    rng = np.random.default_rng(30)
    wq, slo, shi = (_om(a) for a in _packed(rng, 1024, 512))
    x = torch.randn(2, 1024)
    before = dict(K.launches), dict(M.launches)
    assert torch.equal(M.matmul_int4(x, wq, slo, shi), M.matmul_int4_plain(x, wq, slo, shi))
    assert (dict(K.launches), dict(M.launches)) == before
    with pytest.raises(ValueError):
        M.matmul_int4(x.to("meta"), wq, slo, shi)


class _FakeLib:
    """Stands in for a kernel library: records each launch function called
    and returns the given CUDA error code."""

    def __init__(self, err=0):
        self.err, self.called = err, []

    def __getattr__(self, name):
        return lambda *args: self.called.append(name) or self.err


def spy_dispatch(monkeypatch, mod, lib_attr, call, name, launch):
    """Make every tensor count as a device tensor and the plain version of
    wrapper `name` (in module `mod`) fail: the wrapper must launch and
    count, or raise on a launch error, never compute."""
    monkeypatch.setattr(mod, "_check_device", lambda x: True)
    monkeypatch.setattr(mod, name + "_plain", lambda *a, **k: pytest.fail("plain version"))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    for err in (0, 700):
        lib = _FakeLib(err)
        monkeypatch.setattr(mod, lib_attr, lambda: lib)
        before = mod.launches[name]
        if err:
            with pytest.raises(RuntimeError, match="CUDA error 700"):
                call()
        else:
            call()
        assert lib.called == [launch]
        assert mod.launches[name] == before + (0 if err else 1)


def _c_signatures(name):
    """{function: [ctypes type of each parameter]} of the extern "C"
    functions of csrc/<name>.cu: pointers c_void_p, int c_int, float
    c_float."""
    import ctypes
    import re
    from pathlib import Path
    src = (Path(K.__file__).resolve().parent.parent / "csrc" / f"{name}.cu").read_text()
    body = src[src.index('extern "C"'):]
    kind = lambda p: (ctypes.c_void_p if "*" in p else ctypes.c_float
                      if p.split()[0] == "float" else ctypes.c_int)
    return {m.group(1): [kind(p) for p in m.group(2).split(",")] for m in re.finditer(
        r'^(?:extern "C" )?(?:int|size_t)\s+(\w+)\(([^)]*)\)', body, re.M)}


class _DeclaredLib:
    """Stands in for a loaded library while the wrappers declare its
    functions' argtypes."""

    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        return self.fns.setdefault(name, types.SimpleNamespace())


def test_ctypes_declarations_match_the_c_sources(monkeypatch):
    """Every function the wrappers declare exists in its CUDA source with
    the declared parameters, in number and kind: a mismatch would pass a
    wrong argument on the card, where nothing checks it."""
    from chatterbox_tpu_torch.kernels import build
    from chatterbox_tpu_torch.kernels import decode_attention as A
    from chatterbox_tpu_torch.kernels import hift_source as S
    libs = {}
    monkeypatch.setattr(build, "load", lambda name: libs.setdefault(name, _DeclaredLib()))
    for mod, attr in ((K, "_lib"), (K, "_int4_lib"), (A, "_lib"), (S, "_lib")):
        monkeypatch.setattr(mod, attr, None)
    K._kernels(), K.int4_kernels(), A._kernel(), S._kernel()
    assert set(libs) == set(build.sources())
    for name, lib in libs.items():
        sigs = _c_signatures(name)
        assert set(lib.fns) == set(sigs), name
        for fn, decl in lib.fns.items():
            assert decl.argtypes == sigs[fn], (name, fn)


def test_int4_wrappers_launch_or_raise_on_a_device_tensor(monkeypatch):
    rng = np.random.default_rng(31)
    D, I = 512, 2048
    wq, slo, shi = (_om(a) for a in _packed(rng, 1024, 512))
    spy_dispatch(monkeypatch, M, "int4_kernels",
                 lambda: M.matmul_int4(torch.randn(2, 1024), wq, slo, shi),
                 "matmul_int4", "matmul_int4_launch")
    g, be, bias = (_t(v) for v in (_vec(rng, D), _vec(rng, D), _vec(rng, 3 * D)))
    wp, qlo, qhi = (_tt(a) for a in _packed(rng, D, 3 * D))
    spy_dispatch(monkeypatch, K, "int4_kernels",
                 lambda: K.ln_qkv_int4(torch.randn(1, D), g, be, wp, qlo, qhi, bias, EPS),
                 "ln_qkv_int4", "ln_qkv_int4_launch")
    ws, v = _b10_operands(rng, D, I)
    ws = [_tt(a) for a in ws]
    v = {k: _t(a) for k, a in v.items()}
    spy_dispatch(monkeypatch, K, "int4_kernels",
                 lambda: K.attnout_ln_mlp_int4(
                     torch.randn(1, D), torch.randn(1, D), *ws[:3], v["bo"], v["g2"], v["be2"],
                     *ws[3:6], v["b1"], *ws[6:], v["b2"], EPS),
                 "attnout_ln_mlp_int4", "attnout_ln_mlp_int4_launch")


# ---------------------------------------------------------------------------
# modes, operands and the converter
# ---------------------------------------------------------------------------

def test_int4_fused_mode_refuses_llama_and_misfit_widths():
    _, tp = L.models("f32", None)
    with pytest.raises(ValueError, match="GPT-2"):
        Q.quantize_t3_backbone(tp, mode="int4_fused")
    lin = lambda i, o: {"w": torch.zeros(i, o), "b": torch.zeros(o)}
    layer = {"qkv": lin(768, 2304), "attn_out": lin(768, 768), "fc_in": lin(768, 3072),
             "fc_out": lin(3072, 768)}
    with pytest.raises(ValueError, match="widths"):
        Q.quantize_t3_backbone({"backbone": {"layers": [layer]}}, mode="int4_fused")
    with pytest.raises(ValueError, match="mode"):
        Q.quantize_t3_backbone(tp, mode="int3")


def test_port_int4_fused_operands_share_the_layer_weights():
    """The port's own quantization equals the JAX package's, and the fused
    operands are the storage the layer's leaves view."""
    qp, _ = T.models("f32", "int4_fused")
    _, tf = T.models("f32", None)
    out = Q.quantize_t3_backbone(tf, mode="int4_fused")
    lp, jlp = out["backbone"]["layers"][0], qp["backbone"]["layers"][0]
    fused = lp["fused"]
    assert set(fused) == {"g1", "b1", "g2", "b2"} | {
        k for _, keys in K.INT4_FUSED_LAYOUT.values() for k in keys}
    for name, (leaves, keys) in K.INT4_FUSED_LAYOUT.items():
        for leaf, key in zip(leaves, keys):
            assert fused[key].is_contiguous()
            assert lp[name][leaf].data_ptr() == fused[key].data_ptr()
            np.testing.assert_array_equal(lp[name][leaf].numpy(), np.asarray(jlp[name][leaf]))
    assert set(out["speech_head"]) == {"w_q", "w_scale", "b"}


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_t3_from_jax_carries_int4_trees(family):
    mod, mode = (T, "int4_fused") if family == "gpt2" else (L, "int4")
    qp, tp = mod.models("f32", mode)
    jlp, lp = qp["backbone"]["layers"][1], tp["backbone"]["layers"][1]
    name = "fc_out" if family == "gpt2" else "down"
    for leaf in ("w_q4", "w_scale4_lo", "w_scale4_hi"):
        assert lp[name][leaf].T.is_contiguous()
        np.testing.assert_array_equal(lp[name][leaf].numpy(), np.asarray(jlp[name][leaf]))
    if family == "gpt2":
        assert lp["fc_in"]["w_q4c"].data_ptr() == lp["fused"]["w1c_t"].data_ptr()
        np.testing.assert_array_equal(lp["fused"]["qkv_b"].numpy(),
                                      np.asarray(jlp["fused"]["qkv_b8"])[0])
    else:
        assert "fused" not in lp and set(tp["speech_head"]) == {"w_q", "w_scale"}


@pytest.mark.parametrize("family,mode", [("gpt2", "int8_fused"), ("llama", "int8_fused"),
                                         ("gpt2", "int4_fused")])
def test_t3_from_jax_stores_fused_operands_contiguous(family, mode):
    """The kernels' wrappers refuse strided operands on the card, so every
    fused operand carried across must be stored contiguous."""
    _, tp = (T if family == "gpt2" else L).models("f32", mode)
    for lp in tp["backbone"]["layers"]:
        for key, t in lp["fused"].items():
            assert t.is_contiguous(), key


def test_t3_from_jax_refuses_misshaped_int4_leaves():
    qp, _ = L.models("f32", "int4")
    tree = jax.tree.map(np.asarray, qp)
    tree["backbone"]["layers"][0]["q"]["w_q4"] = tree["backbone"]["layers"][0]["q"]["w_q4"][:-2]
    with pytest.raises(ValueError, match="shape"):
        t3_from_jax(tree, L.HP, device="cpu")
    tree = jax.tree.map(np.asarray, qp)
    lo = tree["backbone"]["layers"][0]["up"]["w_scale4_lo"]
    tree["backbone"]["layers"][0]["up"]["w_scale4_lo"] = np.concatenate([lo, lo])
    with pytest.raises(ValueError, match="scales"):
        t3_from_jax(tree, L.HP, device="cpu")
    qp, _ = T.models("f32", "int4_fused")
    tree = jax.tree.map(np.asarray, qp)
    wc = tree["backbone"]["layers"][0]["fc_in"]["w_q4c"]
    tree["backbone"]["layers"][0]["fc_in"]["w_q4c"] = wc.reshape(wc.shape[1], wc.shape[0])
    with pytest.raises(ValueError):
        t3_from_jax(tree, T.HP, device="cpu")
    tree = jax.tree.map(np.asarray, qp)
    tree["backbone"]["layers"][0]["fused"]["w2p"] = tree["backbone"]["layers"][0]["fused"]["w2p"] ^ 1
    with pytest.raises(ValueError, match="differs"):
        t3_from_jax(tree, T.HP, device="cpu")
    tree = jax.tree.map(np.asarray, qp)
    del tree["backbone"]["layers"][1]["fused"]["s1_hi"]
    with pytest.raises(KeyError):
        t3_from_jax(tree, T.HP, device="cpu")


# ---------------------------------------------------------------------------
# T3 in both int4 modes
# ---------------------------------------------------------------------------

# Relative to the largest logit, as the int8 T3 tests: the kernels round
# their norm outputs and hidden units to bf16 and the cache is bf16, so a
# summation-order difference can flip a rounding, compounding over the
# decode steps; bf16 params round every activation.
@pytest.mark.parametrize("dtype,atol", [("f32", 3e-3), ("bf16", 3e-2)])
def test_turbo_int4_fused_teacher_forced_logits_match(dtype, atol):
    qp, tp = T.models(dtype, "int4_fused")
    assert "qkv_wpt" in tp["backbone"]["layers"][0]["fused"]
    jcond, tcond = T._cond(np.random.default_rng(40))
    ref = T._jax_teacher_forced(qp, jcond)
    out = T._port_teacher_forced(tp, tcond)
    assert out.shape == ref.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=atol * max(np.abs(ref).max(), 1.0))


@pytest.mark.parametrize("dtype,atol", [("f32", 3e-3), ("bf16", 3e-2)])
def test_cfg_int4_teacher_forced_logits_match(dtype, atol):
    """Unfused int4 layers: prefill through the dense path, each batch-2
    decode step's seven linears through B8."""
    qp, tp = L.models(dtype, "int4")
    jcond, tcond = L._cond(np.random.default_rng(41))
    ref = L._jax_cfg_teacher_forced(qp, jcond)
    out = L._port_cfg_teacher_forced(tp, tcond)
    assert out.shape == ref.shape and np.isfinite(out).all()
    assert np.abs(out[:, 0] - out[:, 1]).max() > 1e-3
    np.testing.assert_allclose(out, ref, rtol=0, atol=atol * max(np.abs(ref).max(), 1.0))


def test_int4_greedy_tokens_equal():
    qp, tp = T.models("f32", "int4_fused")
    jcond, tcond = T._cond(np.random.default_rng(42))
    sp = dict(temperature=0.8, top_p=0.95, repetition_penalty=1.2)
    jres = T._jax_gen(qp, jcond, JS.SamplerParams.make(**sp), jax.random.key(3), 1, 8)
    res = t3_generate(tp, T.HP, tcond, torch.from_numpy(T.TEXT), S.SamplerParams(**sp),
                      max_new_tokens=8, top_k=1)
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jres.tokens))
    qp, tp = L.models("f32", "int4")
    jcond, tcond = L._cond(np.random.default_rng(43))
    jres = jax_generate(qp, L.JHP, jcond, *L._jax_text(), JS.SamplerParams.make(**L.GREEDY),
                        jax.random.key(4), max_new_tokens=8, cfg_mode=True)
    res = t3_generate(tp, L.HP, tcond, torch.from_numpy(L.TEXT), S.SamplerParams(**L.GREEDY),
                      max_new_tokens=8, cfg_mode=True)
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jres.tokens))
    assert len(set(res.tokens.tolist())) > 1


def test_int4_decode_layers_reach_their_kernels(monkeypatch):
    """A Turbo int4_fused decode step runs B9 and B10 once per layer; a CFG
    int4 step runs B8 for each of a layer's seven linears, at 2 rows."""
    calls = []
    for mod, name in ((K, "ln_qkv_int4"), (K, "attnout_ln_mlp_int4"), (nn, "matmul_int4")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _f=real: calls.append(
            (_n, a[0].shape[0])) or _f(*a))
    _, tp = T.models("f32", "int4_fused")
    res = t3_generate(tp, T.HP, T._cond(np.random.default_rng(44))[1],
                      torch.from_numpy(T.TEXT), S.SamplerParams(0.8, 0.95, 1.2),
                      max_new_tokens=4, top_k=1, ignore_eos=True)
    n = T.HP.backbone.num_layers * res.n_forward
    assert res.n_forward == 3
    assert sorted(calls) == sorted([("ln_qkv_int4", 1)] * n + [("attnout_ln_mlp_int4", 1)] * n)
    calls.clear()
    _, tp = L.models("f32", "int4")
    res = t3_generate(tp, L.HP, L._cond(np.random.default_rng(45))[1],
                      torch.from_numpy(L.TEXT), S.SamplerParams(**L.GREEDY),
                      max_new_tokens=4, cfg_mode=True, ignore_eos=True)
    assert calls == [("matmul_int4", 2)] * (7 * L.HP.backbone.num_layers * res.n_forward)


# ---------------------------------------------------------------------------
# the Turbo pipeline on an int4_fused T3
# ---------------------------------------------------------------------------

def test_turbo_int4_fused_generate_matches_jax_pipeline():
    """As test_torch_pipeline's int8 test: greedy decode on ordinary speech
    tokens, the JAX pipeline's vocoder noise handed to the port, buckets
    exact. float32 end to end on the CPU; the int4 kernels round at the
    same points in both. Unlike int8 weights, the int4 dense prefill and B8
    sum their f32 products in another order than XLA and the Pallas kernel
    (1e-6), which can flip a bf16 rounding of the KV cache; on the random
    T3 the top two logits of a step may lie closer than that, so a seeded
    spread on the speech head keeps greedy decoding off such ties."""
    from tests import test_torch_pipeline as PL
    from tests.test_torch_s3gen import jax_vocode_noise
    jtts, tts = PL._pipelines(mode="int4_fused", head_spread=1.0)
    assert "qkv_wpt" in tts.t3_params["backbone"]["layers"][0]["fused"]
    kw = dict(top_k=1, max_new_tokens=PL.N_NEW)
    ref = jtts.generate("hello world, this is a test", **kw)
    key, _ = jax.random.split(jax.random.key(7))
    _, k_voc = jax.random.split(key)
    noise = jax_vocode_noise(k_voc, 2 * (PL.P + PL.N_NEW + 3), 2 * (PL.N_NEW + 3))
    tts.s3gen.draw_noise = lambda n_mel, n_gen_mel, generator: noise
    out = tts.generate("hello world, this is a test", **kw)
    assert tts.last_decode.n_forward == PL.N_NEW - 1
    assert out.shape == ref.shape == (1, (PL.N_NEW + 3) * 2 * 480)
    assert np.isfinite(out).all() and np.abs(out).max() > 1e-3
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["GPT2_medium", "GPT2_small", "GPT2_fused_test",
                                  "Llama_520M", "Llama_fused_test"])
def test_fused_gpt2_supported_agrees_with_jax(name):
    from chatterbox_tpu.models.t3.config import BACKBONES as JB
    from chatterbox_tpu_torch.models.t3.config import BACKBONES
    assert K.fused_gpt2_supported(BACKBONES[name]) == JF.fused_gpt2_supported(JB[name])
