"""The port's CUDA kernels held against their plain PyTorch versions on the
card, and the wrappers' refusals. Needs an NVIDIA GPU and nvcc, not JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a CUDA device every test skips."""
import pytest
import torch

from chatterbox_tpu_torch.kernels import fused_layer as K

pytestmark = pytest.mark.cuda
EPS = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU build)")
    return torch.device("cuda")


def _b1_operands(dev, B, D, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    N = 3 * D
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    return (r(B, D).to(dtype), 1 + 0.1 * r(D), 0.1 * r(D),
            torch.randint(-127, 128, (N, D), generator=g, device=dev, dtype=torch.int8),
            torch.rand(N, generator=g, device=dev) * 1e-3, 0.01 * r(N))


def _b2_operands(dev, B, D, I, dtype, seed=1):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    i8 = lambda *s: torch.randint(-127, 128, s, generator=g, device=dev, dtype=torch.int8)
    u = lambda n: torch.rand(n, generator=g, device=dev) * 1e-3
    return ((0.5 * r(B, D)).to(dtype), r(B, D).to(dtype), i8(D, D), u(D), 0.01 * r(D),
            1 + 0.1 * r(D), 0.1 * r(D), i8(I, D), u(I), 0.01 * r(I), i8(D, I), u(D),
            0.01 * r(D))


# Tolerances (absolute, outputs of order 1-10): B1 sums exact f32 products
# in another order; B2 also rounds LN2 and the hidden units to bf16, where a
# value on the other side of a rounding boundary moves outputs by ~1e-4.
@pytest.mark.parametrize("B,D,dtype", [(1, 1024, torch.bfloat16), (2, 1024, torch.bfloat16),
                                       (1, 512, torch.float32)])
def test_ln_qkv_kernel_matches_plain(dev, B, D, dtype):
    ops = _b1_operands(dev, B, D, dtype)
    out = K.ln_qkv_int8(*ops, EPS)
    ref = K.ln_qkv_int8_plain(*ops, EPS)
    torch.cuda.synchronize()
    assert out.shape == (B, 3 * D) and torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 1e-3


@pytest.mark.parametrize("B,D,I,dtype", [(1, 1024, 4096, torch.bfloat16),
                                         (2, 1024, 4096, torch.bfloat16),
                                         (1, 512, 2048, torch.float32)])
def test_attnout_ln_mlp_kernel_matches_plain(dev, B, D, I, dtype):
    ops = _b2_operands(dev, B, D, I, dtype)
    out = K.attnout_ln_mlp_int8(*ops, EPS)
    ref = K.attnout_ln_mlp_int8_plain(*ops, EPS)
    torch.cuda.synchronize()
    assert out.shape == (B, D) and torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 1e-2


def _b5_operands(dev, B, D, N, dtype, seed=2):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    return (r(B, D).to(dtype), 1 + 0.1 * r(D),
            torch.randint(-127, 128, (N, D), generator=g, device=dev, dtype=torch.int8),
            torch.rand(N, generator=g, device=dev) * 1e-3)


def _b6_operands(dev, B, D, I, dtype, seed=3):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    i8 = lambda *s: torch.randint(-127, 128, s, generator=g, device=dev, dtype=torch.int8)
    u = lambda n: torch.rand(n, generator=g, device=dev) * 1e-3
    return ((0.5 * r(B, D)).to(dtype), r(B, D).to(dtype), i8(D, D), u(D), 1 + 0.1 * r(D),
            i8(I, D), u(I), i8(I, D), u(I), i8(D, I), u(D))


# B5 sums exact f32 products in another order (outputs of order 1-10); B6
# also rounds the RMSNorm output and the hidden units to bf16, where a value
# on the other side of a rounding boundary moves outputs by ~1e-4. The
# 520M shapes: D=1024, N=3072, I=4096, batch 2 (CFG) or 1 (cfg_weight 0).
@pytest.mark.parametrize("B,D,N,dtype", [(2, 1024, 3072, torch.bfloat16),
                                         (1, 1024, 3072, torch.bfloat16),
                                         (2, 512, 1536, torch.float32)])
def test_rms_qkv_kernel_matches_plain(dev, B, D, N, dtype):
    ops = _b5_operands(dev, B, D, N, dtype)
    out = K.rms_qkv_int8(*ops, EPS)
    ref = K.rms_qkv_int8_plain(*ops, EPS)
    torch.cuda.synchronize()
    assert out.shape == (B, N) and torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 1e-3


@pytest.mark.parametrize("B,D,I,dtype,tw", [(2, 1024, 4096, torch.bfloat16, 1024),
                                            (1, 1024, 4096, torch.bfloat16, 1024),
                                            (2, 512, 1024, torch.float32, 512)])
def test_attnout_rms_glu_kernel_matches_plain(dev, B, D, I, dtype, tw):
    ops = _b6_operands(dev, B, D, I, dtype)
    out = K.attnout_rms_glu_int8(*ops, EPS, tw)
    ref = K.attnout_rms_glu_int8_plain(*ops, EPS, tw)
    torch.cuda.synchronize()
    assert out.shape == (B, D) and torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 1e-2


def test_launch_counts_follow_kernel_calls(dev):
    before = dict(K.launches)
    K.ln_qkv_int8(*_b1_operands(dev, 1, 512, torch.bfloat16), EPS)
    K.attnout_ln_mlp_int8(*_b2_operands(dev, 1, 512, 2048, torch.bfloat16), EPS)
    K.attnout_ln_mlp_int8(*_b2_operands(dev, 1, 512, 2048, torch.bfloat16), EPS)
    assert K.launches["ln_qkv_int8"] == before["ln_qkv_int8"] + 1
    assert K.launches["attnout_ln_mlp_int8"] == before["attnout_ln_mlp_int8"] + 2
    K.rms_qkv_int8(*_b5_operands(dev, 2, 512, 1536, torch.bfloat16), EPS)
    K.attnout_rms_glu_int8(*_b6_operands(dev, 2, 512, 1024, torch.bfloat16), EPS, 512)
    assert K.launches["rms_qkv_int8"] == before["rms_qkv_int8"] + 1
    assert K.launches["attnout_rms_glu_int8"] == before["attnout_rms_glu_int8"] + 1


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x, g, b, w, s, bias = _b1_operands(dev, 1, 1024, torch.bfloat16)
    with pytest.raises(ValueError):          # batch above the kernel's 2 rows
        K.ln_qkv_int8(x.expand(3, -1).contiguous(), g, b, w, s, bias, EPS)
    with pytest.raises(ValueError):          # non-contiguous weight
        K.ln_qkv_int8(x, g, b, w.T.contiguous().T, s, bias, EPS)
    with pytest.raises(TypeError):           # float weight instead of int8
        K.ln_qkv_int8(x, g, b, w.float(), s, bias, EPS)
    with pytest.raises(ValueError):          # operand left on the CPU
        K.ln_qkv_int8(x, g.cpu(), b, w, s, bias, EPS)
    with pytest.raises(ValueError):          # contraction not a multiple of 512
        K.ln_qkv_int8(x[:, :768].contiguous(), g[:768], b[:768],
                      w[:, :768].contiguous(), s, bias, EPS)
    ops = list(_b2_operands(dev, 1, 1024, 4096, torch.bfloat16))
    ops[1] = ops[1].float()                  # residual in another type than a
    with pytest.raises(TypeError):
        K.attnout_ln_mlp_int8(*ops, EPS)
    ops = _b6_operands(dev, 2, 1024, 4096, torch.bfloat16)
    with pytest.raises(ValueError):          # hidden tile not dividing I
        K.attnout_rms_glu_int8(*ops, EPS, 1536)
