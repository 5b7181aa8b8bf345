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
