"""The port's fused int8 GPT-2 decode-layer kernels (chatterbox_tpu_torch/
kernels/fused_layer.py) held against the JAX package's Pallas kernels
(chatterbox_tpu/ops/fused_layer.py) run in interpret mode on the CPU.

On a CPU tensor each wrapper runs its plain PyTorch version, so this pins
the arithmetic the CUDA kernels implement (chip_smoke.py holds the CUDA
kernels against the same plain versions on the card)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from chatterbox_tpu.ops.fused_layer import attnout_ln_mlp_int8 as jax_b2  # noqa: E402
from chatterbox_tpu.ops.fused_layer import ln_qkv_int8 as jax_b1  # noqa: E402
from chatterbox_tpu.utils.quantize import quantize_linear_weight  # noqa: E402
from chatterbox_tpu_torch.kernels import fused_layer as K  # noqa: E402

EPS = 1e-5


def _quant(rng, k, n):
    """A random (k, n) weight quantized by the JAX package: int8 (k, n) and
    its (n,) scale, as numpy."""
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.02
    w_q, s = quantize_linear_weight(jnp.asarray(w))
    return np.asarray(w_q), np.asarray(s)


def _vec(rng, n, scale=0.01, offset=0.0):
    return (offset + scale * rng.standard_normal(n)).astype(np.float32)


def _b8(v):
    return jnp.broadcast_to(jnp.asarray(v)[None], (8, v.shape[0]))


def _act(rng, B, D, dtype, scale=1.0):
    x = (rng.standard_normal((B, D)) * scale).astype(np.float32)
    return jnp.asarray(x).astype(dtype)


def _t(a):
    """JAX array -> torch tensor of the same values and type."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


# max |port - pallas| <= ATOL + RTOL * |pallas|. The two sum the same exact
# f32 products (bf16 activations times int8 weights) in another order, so B1
# agrees to f32 rounding. B2 rounds its LN2 output and its hidden activations
# to bf16 before the next product: when the two summation orders put a value
# on different sides of a bf16 rounding boundary, that one hidden unit moves
# every output by up to ulp(h) * 127 * s2 ~ 2e-4. The Pallas interpret run
# lands ~3 % of its hidden units on the other side (2.5e-4 the most seen).
RTOL, ATOL_B1, ATOL_B2 = 1e-5, 2e-5, 1e-3


@pytest.mark.parametrize("D,B,dtype", [(512, 2, jnp.bfloat16),
                                       (512, 1, jnp.float32),
                                       (1024, 1, jnp.bfloat16)]
                         # the batched engine's rows (the CUDA kernel's
                         # one and two 8-row tiles)
                         + [(512, B, dtype) for B in (3, 8, 16)
                            for dtype in (jnp.bfloat16, jnp.float32)])
def test_ln_qkv_int8_matches_pallas(D, B, dtype):
    rng = np.random.default_rng(D + B)
    N = 3 * D
    x = _act(rng, B, D, dtype)
    g, be = _vec(rng, D, 0.1, 1.0), _vec(rng, D, 0.1)
    w_q, s = _quant(rng, D, N)
    bias = _vec(rng, N)
    ref = jax_b1(x, _b8(g), _b8(be), jnp.asarray(w_q), _b8(s), _b8(bias),
                 eps=EPS, interpret=True)
    out = K.ln_qkv_int8(_t(x), _t(g), _t(be), torch.from_numpy(w_q.T.copy()),
                        _t(s), _t(bias), EPS)
    assert out.dtype == torch.float32 and out.shape == (B, N)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL_B1)


@pytest.mark.parametrize("D,I,B,dtype", [(512, 2048, 2, jnp.bfloat16),
                                         (512, 2048, 1, jnp.float32),
                                         (1024, 4096, 1, jnp.bfloat16)])
def test_attnout_ln_mlp_int8_matches_pallas(D, I, B, dtype):
    """The kernel-level oracle for B2: the JAX package itself checks it only
    through greedy generate."""
    rng = np.random.default_rng(D + I + B)
    a = _act(rng, B, D, dtype, 0.5)
    xres = _act(rng, B, D, dtype)
    wo, so = _quant(rng, D, D)
    w1, s1 = _quant(rng, D, I)
    w2, s2 = _quant(rng, I, D)
    bo, b1, b2 = _vec(rng, D), _vec(rng, I), _vec(rng, D)
    g2, be2 = _vec(rng, D, 0.1, 1.0), _vec(rng, D, 0.1)
    ref = jax_b2(a, xres, jnp.asarray(wo), _b8(so), _b8(bo), _b8(g2), _b8(be2),
                 jnp.asarray(w1), _b8(s1), _b8(b1), jnp.asarray(w2), _b8(s2),
                 _b8(b2), eps=EPS, interpret=True)
    tt = lambda w: torch.from_numpy(w.T.copy())
    out = K.attnout_ln_mlp_int8(_t(a), _t(xres), tt(wo), _t(so), _t(bo),
                                _t(g2), _t(be2), tt(w1), _t(s1), _t(b1),
                                tt(w2), _t(s2), _t(b2), EPS)
    assert out.dtype == torch.float32 and out.shape == (B, D)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL_B2)


def _b2_case(D, I, B, dtype, seed):
    """B2's operands (JAX arrays and numpy) and the Pallas kernel's output."""
    rng = np.random.default_rng(seed)
    a = _act(rng, B, D, dtype, 0.5)
    xres = _act(rng, B, D, dtype)
    (wo, so), (w1, s1), (w2, s2) = (_quant(rng, k, n) for k, n in ((D, D), (D, I), (I, D)))
    bo, b1, b2 = _vec(rng, D), _vec(rng, I), _vec(rng, D)
    g2, be2 = _vec(rng, D, 0.1, 1.0), _vec(rng, D, 0.1)
    ref = jax_b2(a, xres, jnp.asarray(wo), _b8(so), _b8(bo), _b8(g2), _b8(be2),
                 jnp.asarray(w1), _b8(s1), _b8(b1), jnp.asarray(w2), _b8(s2),
                 _b8(b2), eps=EPS, interpret=True)
    tt = lambda w: torch.from_numpy(w.T.copy())
    ops = (_t(a), _t(xres), tt(wo), _t(so), _t(bo), _t(g2), _t(be2), tt(w1), _t(s1),
           _t(b1), tt(w2), _t(s2), _t(b2))
    return ops, np.asarray(ref)


# The CUDA kernel's order of sums (attnout_ln_mlp_int8_split_plain): attn-out
# split over 1, 2 or 4 blocks of eight warps, fc_in and each 1024-wide tile
# of fc_out over eight warps, the tiles added onto r + b2 in order; at 1-16
# rows (one and two MMA row tiles) and both input types, against the Pallas
# kernel at B2's tolerance above (the bf16 roundings of y and h are where
# the orders part).
_B2_REFS = {}


@pytest.mark.parametrize("B", [1, 2, 8, 16])
@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
@pytest.mark.parametrize("attn_splits", [1, 2, 4])
def test_attnout_ln_mlp_split_order_matches_pallas(B, dtype, attn_splits):
    key = (B, dtype)
    if key not in _B2_REFS:
        _B2_REFS[key] = _b2_case(512, 2048, B, dtype, seed=70 + B)
    ops, ref = _B2_REFS[key]
    out = K.attnout_ln_mlp_int8_split_plain(*ops, EPS, 1024, attn_splits)
    assert out.dtype == torch.float32 and out.shape == (B, 512)
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL_B2)


@pytest.mark.parametrize("attn_splits", [1, 4])
def test_attnout_ln_mlp_split_order_matches_pallas_at_turbo_width(attn_splits):
    ops, ref = _b2_case(1024, 4096, 2, jnp.bfloat16, seed=80 + attn_splits)
    out = K.attnout_ln_mlp_int8_split_plain(*ops, EPS, 1024, attn_splits)
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL_B2)


@pytest.mark.parametrize("B", [1, 2, 8, 16])
def test_gelu_tiling_fits_every_shape_the_kernel_takes(B):
    """B2's tiling (tw given) and B11's (tw None) within shared memory at D
    512-2048 and I up to 8192, each down block taking whole hidden tiles,
    the norm block's units from GELU_UNITS dividing I; the Turbo shape
    takes attn-out unsplit, the first choice of units and down split
    TC_MAX_SPLITS ways (the sweep's choice)."""
    for D, I, tw in ((512, 2048, 1024), (1024, 4096, 1024), (2048, 4096, 1024),
                     (2048, 8192, 1024), (1024, 4096, None), (2048, 8192, None)):
        attn, units, down, pdl = K.gelu_tiling(B, D, I, tw)
        tiles = down if tw is None else I // tw
        K.tc_phases_limits("B2", B, D, I, tiles, attn, units, down)
        assert units in K.GELU_UNITS and I % units == 0 and pdl == K.TC_PDL
        assert tiles % down == 0 and (D // attn) % K.TC_CHUNK == 0
        if (D, I) == (1024, 4096):
            assert (attn, units, down) == (1, K.GELU_UNITS[0], K.TC_MAX_SPLITS)
    with pytest.raises(ValueError):          # 3 down blocks over 4 tiles
        K.tc_phases_limits("B2", B, 1024, 4096, 4, 1, 32, 3)
    with pytest.raises(ValueError):          # hidden tiles of 32 units, not whole 64-wide steps
        K.tc_phases_limits("B2", B, 1024, 4096, 128, 1, 32, 4)


def test_b2_wrapper_launches_or_raises_on_a_device_tensor(monkeypatch):
    from tests.test_torch_int4 import spy_dispatch
    ops, _ = _b2_case(512, 2048, 2, jnp.float32, seed=90)
    spy_dispatch(monkeypatch, K, "_kernels", lambda: K.attnout_ln_mlp_int8(*ops, EPS),
                 "attnout_ln_mlp_int8", "attnout_ln_mlp_int8_launch")


def test_cpu_dispatch_is_the_plain_version_and_counts_nothing():
    rng = np.random.default_rng(0)
    D = 512
    x = torch.from_numpy(rng.standard_normal((1, D)).astype(np.float32))
    g, b = torch.ones(D), torch.zeros(D)
    w_t = torch.from_numpy(rng.integers(-127, 128, (3 * D, D)).astype(np.int8))
    s, bias = torch.full((3 * D,), 1e-3), torch.zeros(3 * D)
    before = dict(K.launches)
    out = K.ln_qkv_int8(x, g, b, w_t, s, bias, EPS)
    assert torch.equal(out, K.ln_qkv_int8_plain(x, g, b, w_t, s, bias, EPS))
    assert K.launches == before
    with pytest.raises(ValueError):
        K.ln_qkv_int8(x.to("meta"), g, b, w_t, s, bias, EPS)


def test_prepared_operands_share_the_layer_weights():
    from chatterbox_tpu_torch.utils.quantize import quantize_tree
    rng = np.random.default_rng(1)
    D, I = 512, 2048
    lin = lambda i, o: {"w": torch.from_numpy(
        rng.standard_normal((i, o)).astype(np.float32) * 0.02),
        "b": torch.zeros(o)}
    ln = {"g": torch.ones(D), "b": torch.zeros(D)}
    lp = quantize_tree({"ln1": ln, "qkv": lin(D, 3 * D), "attn_out": lin(D, D),
                        "ln2": ln, "fc_in": lin(D, I), "fc_out": lin(I, D)})
    w_q = lp["fc_in"]["w_q"].clone()
    fused = K.prepare_fused_gpt2_layer_int8(lp)
    assert set(fused) == set(K.FUSED_KEYS)
    assert fused["w1_t"].is_contiguous() and fused["w1_t"].shape == (I, D)
    assert torch.equal(lp["fc_in"]["w_q"], w_q)
    assert lp["fc_in"]["w_q"].data_ptr() == fused["w1_t"].data_ptr()
