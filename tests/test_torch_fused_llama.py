"""The port's fused int8 llama decode-layer kernels (chatterbox_tpu_torch/
kernels/fused_layer.py: rms_qkv_int8, attnout_rms_glu_int8) held against the
JAX package's Pallas kernels (chatterbox_tpu/ops/fused_layer.py) run in
interpret mode on the CPU, and the port's fused CFG decode against its own
unfused one.

On a CPU tensor each wrapper runs its plain PyTorch version, so this pins
the arithmetic the CUDA kernels implement (chip_smoke.py holds the CUDA
kernels against the same plain versions on the card)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from chatterbox_tpu.ops.fused_layer import attnout_rms_glu_int8 as jax_b6  # noqa: E402
from chatterbox_tpu.ops.fused_layer import fused_llama_supported as jax_supported  # noqa: E402
from chatterbox_tpu.ops.fused_layer import rms_qkv_int8 as jax_b5  # noqa: E402
from chatterbox_tpu.utils.quantize import quantize_linear_weight  # noqa: E402
from chatterbox_tpu_torch.kernels import fused_layer as K  # noqa: E402
from chatterbox_tpu_torch.models.t3 import model as t3m  # noqa: E402
from chatterbox_tpu_torch.models.t3.config import BACKBONES, T3Config  # noqa: E402
from chatterbox_tpu_torch.ops.sampling import SamplerParams  # noqa: E402
from chatterbox_tpu_torch.sampling.decode import t3_generate  # noqa: E402
from chatterbox_tpu_torch.utils.quantize import (best_serving_mode,  # noqa: E402
                                                 quantize_t3_backbone, quantize_tree)

EPS = 1e-5


def _quant(rng, k, n):
    """A random (k, n) weight quantized by the JAX package: int8 (k, n) and
    its (n,) scale, as numpy."""
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.02
    w_q, s = quantize_linear_weight(jnp.asarray(w))
    return np.asarray(w_q), np.asarray(s)


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


def _tt(w):
    """(K, N) numpy int8 -> the port's out-major (N, K) tensor."""
    return torch.from_numpy(w.T.copy())


# max |port - pallas| <= ATOL + RTOL * |pallas|. Both sum the same exact f32
# products (bf16 activations times int8 weights) in another order, so B5
# agrees to f32 rounding. B6 rounds its RMSNorm output and its hidden units
# to bf16 before the next product: where the two summation orders put a
# value on different sides of a bf16 rounding boundary, that one hidden unit
# moves every output by up to ulp(h) * 127 * sd (~2e-4 at these scales).
RTOL, ATOL_B5, ATOL_B6 = 1e-5, 2e-5, 1e-3


@pytest.mark.parametrize("D,B,dtype", [(512, 1, jnp.bfloat16),
                                       (512, 2, jnp.float32),
                                       (1024, 2, jnp.bfloat16)]
                         # the batched engine's rows (the CUDA kernel's
                         # one and two 8-row tiles)
                         + [(512, B, dtype) for B in (3, 8, 16)
                            for dtype in (jnp.bfloat16, jnp.float32)])
def test_rms_qkv_int8_matches_pallas(D, B, dtype):
    rng = np.random.default_rng(D + B)
    N = 3 * D
    x = _act(rng, B, D, dtype)
    g = (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    w_q, s = _quant(rng, D, N)
    ref = jax_b5(x, _b8(g), jnp.asarray(w_q), _b8(s), eps=EPS, interpret=True)
    out = K.rms_qkv_int8(_t(x), _t(g), _tt(w_q), _t(s), EPS)
    assert out.dtype == torch.float32 and out.shape == (B, N)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL_B5)


@pytest.mark.parametrize("D,I,B,dtype,tw", [(512, 1024, 1, jnp.bfloat16, 1024),
                                            (512, 1024, 2, jnp.bfloat16, 512),
                                            (512, 1024, 2, jnp.float32, 1024),
                                            (1024, 4096, 2, jnp.bfloat16, 1024)])
def test_attnout_rms_glu_int8_matches_pallas(D, I, B, dtype, tw):
    rng = np.random.default_rng(D + I + B + tw)
    a = _act(rng, B, D, dtype, 0.5)
    xres = _act(rng, B, D, dtype)
    wo, so = _quant(rng, D, D)
    wg, sg = _quant(rng, D, I)
    wu, su = _quant(rng, D, I)
    wd, sd = _quant(rng, I, D)
    g2 = (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    ref = jax_b6(a, xres, jnp.asarray(wo), _b8(so), _b8(g2), jnp.asarray(wg), _b8(sg),
                 jnp.asarray(wu), _b8(su), jnp.asarray(wd), _b8(sd), eps=EPS, tw=tw,
                 interpret=True)
    out = K.attnout_rms_glu_int8(_t(a), _t(xres), _tt(wo), _t(so), _t(g2), _tt(wg),
                                 _t(sg), _tt(wu), _t(su), _tt(wd), _t(sd), EPS, tw)
    assert out.dtype == torch.float32 and out.shape == (B, D)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL_B6)


# The CUDA kernel's order of sums: attn-out's contraction split over 1, 2 or
# 4 blocks and eight warps each, the gate / up / down sums over eight warps,
# down's tw tiles added in order; against the Pallas kernel at B6's
# tolerance above (the bf16 roundings of y and h are where orders part).
@pytest.mark.parametrize("D,I,B,tw", [(512, 1024, 2, 512), (1024, 4096, 2, 1024),
                                      (512, 2048, 16, 1024)])
@pytest.mark.parametrize("attn_splits", [1, 2, 4])
def test_attnout_rms_glu_split_order_matches_pallas(D, I, B, tw, attn_splits):
    rng = np.random.default_rng(D + I + B + attn_splits)
    a = _act(rng, B, D, jnp.bfloat16, 0.5)
    xres = _act(rng, B, D, jnp.bfloat16)
    (wo, so), (wg, sg), (wu, su), (wd, sd) = (_quant(rng, k, n) for k, n in
                                              ((D, D), (D, I), (D, I), (I, D)))
    g2 = (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    ref = jax_b6(a, xres, jnp.asarray(wo), _b8(so), _b8(g2), jnp.asarray(wg), _b8(sg),
                 jnp.asarray(wu), _b8(su), jnp.asarray(wd), _b8(sd), eps=EPS, tw=tw,
                 interpret=True)
    out = K.attnout_rms_glu_int8_split_plain(
        _t(a), _t(xres), _tt(wo), _t(so), _t(g2), _tt(wg), _t(sg), _tt(wu), _t(su),
        _tt(wd), _t(sd), EPS, tw, attn_splits)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL_B6)


@pytest.mark.parametrize("B", [1, 2, 8, 16])
def test_glu_tiling_fits_every_shape_the_kernel_takes(B):
    """A tiling within shared memory at D 512-2048, I up to 8192 and both
    tiles, each block of a split slab taking whole hidden tiles; at the
    520M shape attn-out unsplit and down split TC_MAX_SPLITS ways."""
    for D, I, tw in ((512, 1024, 512), (1024, 4096, 1024), (1024, 4096, 512),
                     (2048, 4096, 1024), (2048, 8192, 512)):
        attn, units, down, _ = K.glu_tiling(B, D, I, tw)
        assert max(K.tc_smem(B, K.TC_COLS, attn, D, attn),
                   K.tc_smem(B, 2 * units, 1, D, 1),
                   K.tc_smem(B, K.TC_COLS, down, I, I // tw)) <= K.SMEM_LIMIT
        assert (I // tw) % down == 0 and (D // attn) % K.TC_CHUNK == 0
        if (D, I) == (1024, 4096):
            assert (attn, units, down) == (1, K.GLU_UNITS, K.TC_MAX_SPLITS)


def test_b6_wrapper_launches_or_raises_on_a_device_tensor(monkeypatch):
    from tests.test_torch_int4 import spy_dispatch
    rng = np.random.default_rng(3)
    D, I = 512, 1024
    ws = [_quant(rng, k, n) for k, n in ((D, D), (D, I), (D, I), (I, D))]
    (wo, so), (wg, sg), (wu, su), (wd, sd) = ((_tt(w), _t(s)) for w, s in ws)
    g2 = torch.ones(D)
    a = torch.randn(2, D)
    spy_dispatch(monkeypatch, K, "_kernels",
                 lambda: K.attnout_rms_glu_int8(a, a, wo, so, g2, wg, sg, wu, su, wd, sd,
                                                EPS, 512),
                 "attnout_rms_glu_int8", "attnout_rms_glu_int8_launch")


def test_cpu_dispatch_is_the_plain_version_and_counts_nothing():
    rng = np.random.default_rng(0)
    D = 512
    x = torch.from_numpy(rng.standard_normal((2, D)).astype(np.float32))
    g = torch.ones(D)
    w_t = torch.from_numpy(rng.integers(-127, 128, (3 * D, D)).astype(np.int8))
    s = torch.full((3 * D,), 1e-3)
    before = dict(K.launches)
    out = K.rms_qkv_int8(x, g, w_t, s, EPS)
    assert torch.equal(out, K.rms_qkv_int8_plain(x, g, w_t, s, EPS))
    assert K.launches == before
    with pytest.raises(ValueError):
        K.rms_qkv_int8(x.to("meta"), g, w_t, s, EPS)


def test_serving_mode_and_support_match_the_jax_package():
    for name, cfg in BACKBONES.items():
        assert K.fused_llama_supported(cfg) == jax_supported(cfg), name
    assert best_serving_mode(BACKBONES["Llama_520M"]) == "int8_fused"
    assert best_serving_mode(BACKBONES["Llama_fused_test"]) == "int8_fused"
    assert best_serving_mode(BACKBONES["Llama_tiny_test"]) == "int8"
    assert K.llama_mlp_tile(BACKBONES["Llama_520M"]) == 1024


def test_prepared_operands_share_the_layer_weights():
    rng = np.random.default_rng(1)
    D, I = 512, 1024
    lin = lambda i, o: {"w": torch.from_numpy(
        rng.standard_normal((i, o)).astype(np.float32) * 0.02)}
    lp = quantize_tree({"input_ln": {"g": torch.ones(D)}, "q": lin(D, D),
                        "k": lin(D, D), "v": lin(D, D), "o": lin(D, D),
                        "post_ln": {"g": torch.ones(D)}, "gate": lin(D, I),
                        "up": lin(D, I), "down": lin(I, D)})
    before = {n: lp[n]["w_q"].clone() for n in ("q", "k", "v", "o", "gate", "up", "down")}
    fused = K.prepare_fused_llama_layer_int8(lp)
    assert set(fused) == set(K.LLAMA_FUSED_KEYS)
    assert fused["qkv_wt"].is_contiguous() and fused["qkv_wt"].shape == (3 * D, D)
    for n, w in before.items():
        assert torch.equal(lp[n]["w_q"], w), n
    assert lp["k"]["w_q"].data_ptr() == fused["qkv_wt"][D:].data_ptr()
    assert lp["gate"]["w_q"].data_ptr() == fused["wg_t"].data_ptr()


def test_fused_cfg_decode_matches_unfused_greedy():
    """The port's decode step through the two fused kernels (plain versions
    here) against its unfused llama layer: the same greedy CFG tokens."""
    hp = T3Config(text_tokens_dict_size=64, backbone_name="Llama_fused_test",
                  speech_tokens_dict_size=6564, speech_cond_prompt_len=8,
                  use_perceiver_resampler=False, emotion_adv=True,
                  max_text_tokens=64, max_speech_tokens=128)
    qp = quantize_t3_backbone(t3m.t3_init(hp, seed=0, device="cpu"), mode="int8_fused")
    up = dict(qp)
    up["backbone"] = dict(qp["backbone"])
    up["backbone"]["layers"] = [{k: v for k, v in lp.items() if k != "fused"}
                                for lp in qp["backbone"]["layers"]]
    g = torch.Generator().manual_seed(2)
    cond = t3m.T3CondTensors(torch.randn((1, 256), generator=g),
                             torch.randint(0, 6561, (1, 8), generator=g),
                             torch.full((1, 1, 1), 0.5))
    text = torch.randint(0, 64, (1, 8), generator=g)
    # min_p = 1 keeps only the most likely token: greedy whatever the draws
    sp = SamplerParams(temperature=1.0, top_p=1.0, repetition_penalty=2.0,
                       min_p=1.0, cfg_weight=0.5)
    kw = dict(max_new_tokens=6, cfg_mode=True, ignore_eos=True)
    r_f = t3_generate(qp, hp, cond, text, sp, generator=torch.Generator().manual_seed(7), **kw)
    r_u = t3_generate(up, hp, cond, text, sp, generator=torch.Generator().manual_seed(8), **kw)
    assert r_f.n_forward == 5
    assert torch.equal(r_f.tokens, r_u.tokens)
    assert len(set(r_f.tokens.tolist())) > 1
