"""B11 `fused_mlp_int8` of the port (kernels/fused_mlp.py) held against the
JAX package's Pallas kernel (chatterbox_tpu/ops/pallas_mlp.py) in interpret
mode, on the CPU, where the port's wrapper takes its plain version; and the
wrapper's dispatch on a device tensor."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from chatterbox_tpu.ops.pallas_mlp import fused_mlp_int8 as jax_fused_mlp  # noqa: E402
from chatterbox_tpu.utils.quantize import quantize_linear_weight as jquant  # noqa: E402

from chatterbox_tpu_torch.kernels import fused_mlp as FM  # noqa: E402
from chatterbox_tpu_torch.utils.quantize import quantize_linear_weight  # noqa: E402
from tests.test_torch_int4 import spy_dispatch  # noqa: E402


def _operands(rng, B, D, I, dtype):
    """JAX operands as the Pallas kernel takes them: x (B, D), LayerNorm
    (D,), int8 W1 (D, I) and W2 (I, D) with per-column scales, biases."""
    f = lambda *s, scale=1.0, offset=0.0: jnp.asarray(
        (offset + scale * rng.standard_normal(s)).astype(np.float32))
    w1q, s1 = jquant(f(D, I, scale=0.03))
    w2q, s2 = jquant(f(I, D, scale=0.03))
    return (f(B, D).astype(dtype), f(D, scale=0.1, offset=1.0), f(D, scale=0.1),
            w1q, s1, f(I, scale=0.01), w2q, s2, f(D, scale=0.01))


def _port(ops):
    """The same operands as torch tensors, the int8 weights stored out-major
    (their .T contiguous) as an int8_fused layer holds them."""
    out = []
    for a in ops:
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            out.append(torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16))
        elif a.dtype == np.int8:
            out.append(torch.from_numpy(np.ascontiguousarray(a.T)).T)
        else:
            out.append(torch.from_numpy(np.array(a)))
    return out


# The plain version rounds LN(x) and the hidden units to bf16 where the
# Pallas kernel does and sums exact products in another order: f32 outputs
# agree to f32 rounding, unless a hidden unit lands on the other side of a
# bf16 rounding boundary (1e-4 of outputs of order 1). bf16 outputs are
# cast from f32 sums that differ so: one bf16 ulp (2**-8 of the magnitude).
@pytest.mark.parametrize("B,dtype", [(1, jnp.float32), (2, jnp.float32),
                                     (1, jnp.bfloat16), (16, jnp.bfloat16)])
def test_fused_mlp_plain_matches_pallas(B, dtype):
    rng = np.random.default_rng(50 + B)
    D, I = 512, 2048
    ops = _operands(rng, B, D, I, dtype)
    ref = np.asarray(jax_fused_mlp(*ops, interpret=True).astype(jnp.float32))
    out = FM.fused_mlp_int8(*_port(ops))
    assert out.dtype == (torch.float32 if dtype == jnp.float32 else torch.bfloat16)
    assert out.shape == (B, D)
    tol = 1e-4 if dtype == jnp.float32 else 2.0 ** -8 * np.abs(ref).max()
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=tol)


# The CUDA kernel's order of sums (fused_mlp_int8_split_plain: each hidden
# unit over eight warps, fc_out's contraction over 1, 2 or 4 blocks of
# eight warps, scaled once) at 1-16 rows (one and two MMA row tiles) and
# both types, against the Pallas kernel at the tolerances above.
_REFS = {}


@pytest.mark.parametrize("B", [1, 2, 8, 16])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("down_splits", [1, 2, 4])
def test_fused_mlp_split_order_matches_pallas(B, dtype, down_splits):
    key = (B, dtype)
    if key not in _REFS:
        ops = _operands(np.random.default_rng(70 + B), B, 512, 2048, dtype)
        _REFS[key] = (_port(ops),
                      np.asarray(jax_fused_mlp(*ops, interpret=True).astype(jnp.float32)))
    t, ref = _REFS[key]
    out = FM.fused_mlp_int8_split_plain(*t, down_splits)
    assert out.dtype == t[0].dtype and out.shape == (B, 512)
    tol = 1e-4 if dtype == jnp.float32 else 2.0 ** -8 * np.abs(ref).max()
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=tol)


def test_fused_mlp_on_port_quantized_weights_matches_pallas():
    """The port's own int8 quantization of the weights feeds both."""
    rng = np.random.default_rng(60)
    D, I = 512, 2048
    w1 = (rng.standard_normal((D, I)) * 0.03).astype(np.float32)
    w2 = (rng.standard_normal((I, D)) * 0.03).astype(np.float32)
    ops = list(_operands(rng, 2, D, I, jnp.float32))
    t = _port(ops)
    (t[3], t[4]), (t[6], t[7]) = (quantize_linear_weight(torch.from_numpy(w))
                                  for w in (w1, w2))
    ops[3], ops[4] = jquant(jnp.asarray(w1))
    ops[6], ops[7] = jquant(jnp.asarray(w2))
    ref = np.asarray(jax_fused_mlp(*ops, interpret=True))
    np.testing.assert_allclose(FM.fused_mlp_int8(*t).numpy(), ref, rtol=0, atol=1e-4)


def test_fused_mlp_cpu_takes_the_plain_version_and_counts_nothing():
    t = _port(_operands(np.random.default_rng(61), 2, 512, 2048, jnp.float32))
    before = dict(FM.launches)
    assert torch.equal(FM.fused_mlp_int8(*t), FM.fused_mlp_int8_plain(*t))
    assert FM.launches == before
    with pytest.raises(ValueError):
        FM.fused_mlp_int8(t[0].to("meta"), *t[1:])


def test_fused_mlp_launches_or_raises_on_a_device_tensor(monkeypatch):
    t = _port(_operands(np.random.default_rng(62), 1, 512, 2048, jnp.float32))
    spy_dispatch(monkeypatch, FM, "_kernels", lambda: FM.fused_mlp_int8(*t),
                 "fused_mlp_int8", "fused_mlp_int8_launch")
