"""The port's CUDA kernels held against their plain PyTorch versions on the
card, and the wrappers' refusals. Needs an NVIDIA GPU and nvcc, not JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a CUDA device every test skips."""
import numpy as np
import pytest
import torch

from chatterbox_tpu_torch.kernels import build
from chatterbox_tpu_torch.kernels import decode_attention as A
from chatterbox_tpu_torch.kernels import fused_layer as K
from chatterbox_tpu_torch.kernels import hift_source as KS
from chatterbox_tpu_torch.models.s3gen import hift as H
from chatterbox_tpu_torch.nn import core as nn

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
    with pytest.raises(ValueError):          # batch above the kernels' 16 rows
        K.ln_qkv_int8(x.expand(17, -1).contiguous(), g, b, w, s, bias, EPS)
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


# The batched engine's rows: 4 and 8 (Turbo requests, or CFG pairs), 16
# (eight CFG requests); a row count between instances (5, 13) runs the next
# instance up with its last rows skipped. Tolerances as above.
@pytest.mark.parametrize("B", [4, 5, 8, 13, 16])
def test_fused_kernels_at_batched_rows_match_plain(dev, B):
    ops = _b1_operands(dev, B, 1024, torch.bfloat16)
    assert (K.ln_qkv_int8(*ops, EPS) - K.ln_qkv_int8_plain(*ops, EPS)).abs().max() <= 1e-3
    ops = _b2_operands(dev, B, 1024, 4096, torch.bfloat16)
    err = (K.attnout_ln_mlp_int8(*ops, EPS) - K.attnout_ln_mlp_int8_plain(*ops, EPS))
    assert err.abs().max() <= 1e-2
    ops = _b5_operands(dev, B, 1024, 3072, torch.bfloat16)
    assert (K.rms_qkv_int8(*ops, EPS) - K.rms_qkv_int8_plain(*ops, EPS)).abs().max() <= 1e-3
    ops = _b6_operands(dev, B, 1024, 4096, torch.bfloat16)
    err = K.attnout_rms_glu_int8(*ops, EPS, 1024) - K.attnout_rms_glu_int8_plain(*ops, EPS, 1024)
    assert err.abs().max() <= 1e-2
    torch.cuda.synchronize()


# The tensor-core B1 / B5 at every row count they take: 1-8 rows run one
# 8-row MMA tile, 9-16 two. The tensor cores add the exact bf16 x int8
# products in another order, in f32 (outputs of order 1-10). The f32 norm
# sums run in another order too, so a norm value may land on the other side
# of a bf16 rounding boundary: that moves its row's outputs by up to
# ulp(y) * 127 * s, 9.9e-4 for |y| < 2 and s < 1e-3.
TOL_QKV = 1e-3
QKV_SHAPES = [(D, dtype) for D in (512, 1024, 2048) for dtype in (torch.bfloat16, torch.float32)]


@pytest.mark.parametrize("B", range(1, 17))
def test_ln_qkv_kernel_at_every_row_count(dev, B):
    for D, dtype in QKV_SHAPES:
        ops = _b1_operands(dev, B, D, dtype, seed=B)
        out = K.ln_qkv_int8(*ops, EPS)
        ref = K.ln_qkv_int8_plain(*ops, EPS)
        torch.cuda.synchronize()
        assert out.shape == (B, 3 * D) and torch.isfinite(out).all(), (D, dtype)
        assert (out - ref).abs().max().item() <= TOL_QKV, (D, dtype)


@pytest.mark.parametrize("B", range(1, 17))
def test_rms_qkv_kernel_at_every_row_count(dev, B):
    for (D, dtype), N in ((shape, N) for shape in QKV_SHAPES for N in (1536, 3072)):
        ops = _b5_operands(dev, B, D, N, dtype, seed=B)
        out = K.rms_qkv_int8(*ops, EPS)
        ref = K.rms_qkv_int8_plain(*ops, EPS)
        torch.cuda.synchronize()
        assert out.shape == (B, N) and torch.isfinite(out).all(), (D, N, dtype)
        assert (out - ref).abs().max().item() <= TOL_QKV, (D, N, dtype)


@pytest.mark.parametrize("B", [1, 2, 8, 9, 16])
def test_qkv_kernels_on_a_case_checked_by_hand(dev, B):
    """Row r of x is (r + 1) * (+1, -1, +1, ...): with unit gain and zero
    bias both norms give y = (+1, -1, ...) exactly in bf16 (eps moves the
    f32 value by 5e-6, far inside half a bf16 ulp of 1). Column n of W is
    c_n * (+1, -1, ...) with c_n = n % 255 - 127, so y . w_n = D c_n, and
    with s = 1 / D every output is c_n exactly (integers below 2^24 add
    exactly in f32, in any order)."""
    D, N = 1024, 3072
    sign = 1.0 - 2.0 * (torch.arange(D, device=dev) % 2)
    x = (torch.arange(1, B + 1, device=dev, dtype=torch.float32)[:, None] * sign).bfloat16()
    c = (torch.arange(N, device=dev) % 255 - 127).float()
    w_t = (c[:, None] * sign).to(torch.int8)
    g, b = torch.ones(D, device=dev), torch.zeros(D, device=dev)
    s, bias = torch.full((N,), 1.0 / D, device=dev), torch.zeros(N, device=dev)
    want = c.expand(B, N)
    assert torch.equal(K.ln_qkv_int8(x, g, b, w_t, s, bias, EPS), want)
    assert torch.equal(K.rms_qkv_int8(x, g, w_t, s, EPS), want)
    # a bias adds after the scale
    assert torch.equal(K.ln_qkv_int8(x, g, b, w_t, s, bias + 0.5, EPS), want + 0.5)


def test_qkv_wrappers_refuse_what_the_new_kernel_does_not_take(dev):
    x, g, b, w, s, bias = _b1_operands(dev, 2, 1024, torch.bfloat16)
    n = 3072 - 16                            # not a multiple of a block's 32 columns
    with pytest.raises(ValueError):
        K.ln_qkv_int8(x, g, b, w[:n].contiguous(), s[:n].contiguous(),
                      bias[:n].contiguous(), EPS)
    with pytest.raises(ValueError):
        K.rms_qkv_int8(x, g, w[:n].contiguous(), s[:n].contiguous(), EPS)
    # D = 4096: a block's weight slab, norm rows and g (and b) exceed 227 KB
    # at 16 rows in both forms and at 8 rows in the LayerNorm form
    x, g, b, w, s, bias = _b1_operands(dev, 16, 4096, torch.bfloat16)
    for B in (16, 8):
        assert K.norm_qkv_smem(B, 4096, False) > K.SMEM_LIMIT
        with pytest.raises(ValueError):
            K.ln_qkv_int8(x[:B].contiguous(), g, b, w, s, bias, EPS)
    assert K.norm_qkv_smem(16, 4096, True) > K.SMEM_LIMIT
    with pytest.raises(ValueError):
        K.rms_qkv_int8(x, g, w, s, EPS)
    # the RMSNorm form needs no b and fits at 8 rows
    assert K.norm_qkv_smem(8, 4096, True) <= K.SMEM_LIMIT
    x8 = x[:8].contiguous()
    out = K.rms_qkv_int8(x8, g, w, s, EPS)
    assert (out - K.rms_qkv_int8_plain(x8, g, w, s, EPS)).abs().max().item() <= TOL_QKV


def _attn_operands(dev, B, H, T, D, qdtype, seed=4):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    i8 = lambda *s: torch.randint(-127, 128, s, generator=g, device=dev, dtype=torch.int8)
    scale = lambda: (torch.rand((B, H, T), generator=g, device=dev) * 0.02).bfloat16()
    return (r(B, H, 1, D).to(qdtype), r(B, H, T, D).bfloat16(), r(B, H, T, D).bfloat16(),
            i8(B, H, T, D), scale(), i8(B, H, T, D), scale())


def _attn_close(out, ref):
    """bf16 outputs: one bf16 ulp of their magnitude (the two sum in
    another order, then round); f32 outputs: 1e-5 of it."""
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert torch.isfinite(out).all()
    tol = (2.0 ** -7 if out.dtype == torch.bfloat16 else 1e-5) * ref.float().abs().max()
    assert (out.float() - ref.float()).abs().max() <= tol


# The paths' shapes: Turbo B=1, T=768; 520M CFG B=2, T=512; the batched
# engine B=8 with distinct left pads, one past a whole tile; head widths
# 32 and 128; f32 queries.
@pytest.mark.parametrize("B,H,T,D,cur,lo,qdtype", [
    (1, 16, 768, 64, [530], None, torch.bfloat16),
    (2, 16, 512, 64, [300, 300], None, torch.bfloat16),
    (8, 16, 512, 64, [400] * 8, [0, 3, 17, 40, 100, 257, 260, 399], torch.bfloat16),
    (2, 4, 256, 32, [10, 255], [4, 0], torch.bfloat16),
    (1, 4, 512, 128, [300], [200], torch.float32),
])
def test_streamed_attention_kernels_match_plain(dev, B, H, T, D, cur, lo, qdtype):
    q, k, v, k_q, k_s, v_q, v_s = _attn_operands(dev, B, H, T, D, qdtype)
    cur = torch.tensor(cur, device=dev, dtype=torch.int32)
    lo = None if lo is None else torch.tensor(lo, device=dev, dtype=torch.int32)
    before = dict(A.launches)
    _attn_close(A.decode_attention_streamed(q, k, v, cur, lo),
                A.decode_attention_streamed_plain(q, k, v, cur, lo))
    _attn_close(A.decode_attention_streamed_int8(q, k_q, k_s, v_q, v_s, cur, lo),
                A.decode_attention_streamed_int8_plain(q, k_q, k_s, v_q, v_s, cur, lo))
    torch.cuda.synchronize()
    assert A.launches["decode_attention_streamed"] == before["decode_attention_streamed"] + 1
    assert (A.launches["decode_attention_streamed_int8"]
            == before["decode_attention_streamed_int8"] + 1)


@pytest.mark.parametrize("B,T,cur", [(1, 657, [600]), (2, 100, [5, 99]), (1, 512, [511])])
def test_whole_slice_attention_kernel_matches_plain(dev, B, T, cur):
    q, k, v, *_ = _attn_operands(dev, B, 16, T, 64, torch.bfloat16)
    cur = torch.tensor(cur, device=dev, dtype=torch.int32)
    _attn_close(A.decode_attention(q, k, v, cur), A.decode_attention_plain(q, k, v, cur))
    torch.cuda.synchronize()


def test_attention_wrappers_refuse_what_the_kernel_does_not_take(dev):
    q, k, v, k_q, k_s, v_q, v_s = _attn_operands(dev, 1, 4, 512, 64, torch.bfloat16)
    cur = torch.tensor([100], device=dev)
    with pytest.raises(ValueError):          # cache length not a multiple of 256
        A.decode_attention_streamed(q, k[:, :, :300].contiguous(),
                                    v[:, :, :300].contiguous(), cur)
    with pytest.raises(TypeError):           # f32 cache instead of bf16
        A.decode_attention_streamed(q, k.float(), v.float(), cur)
    with pytest.raises(ValueError):          # head width the template lacks
        A.decode_attention(q[..., :16].contiguous(), k[..., :16].contiguous(),
                           v[..., :16].contiguous(), cur)
    with pytest.raises(ValueError):          # scales left on the CPU
        A.decode_attention_streamed_int8(q, k_q, k_s.cpu(), v_q, v_s, cur)


# B3 / B7's split kernel at given split counts and merges: windows of one
# key, fewer keys than S, S whole chunks (ending on a chunk boundary) and up
# to the end of the cache; lo at 0, mid-chunk and one past a tile
SPLIT_LOS = (0, 37, 257)


def _split_window(kind, S, lo, T):
    return {"one": 1, "fewer": max(S - 1, 1), "boundary": 24 * S, "whole": T - lo}[kind]


@pytest.mark.parametrize("qdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("lo", SPLIT_LOS)
@pytest.mark.parametrize("window", ["one", "fewer", "boundary", "whole"])
@pytest.mark.parametrize("S", [1, 3, 8, 16])
def test_split_kernel_matches_plain(dev, S, window, lo, qdtype):
    T = 768
    q, k, v, *_ = _attn_operands(dev, 2, 4, T, 64, qdtype, seed=S + lo)
    cur = torch.tensor([lo + _split_window(window, S, lo, T) - 1, T + 5], device=dev,
                       dtype=torch.int32)
    los = torch.tensor([lo, lo], device=dev, dtype=torch.int32)
    out = A.decode_attention_streamed_split(q, k, v, cur, los, S)
    _attn_close(out, A.decode_attention_streamed_plain(q, k, v, cur, los))
    torch.cuda.synchronize()


# the wrappers (split_count's S, the kept merge) at head widths 32-128, caches
# up to 2048 keys and 1-16 rows
@pytest.mark.parametrize("B,H,T,D,cur,lo,qdtype", [
    (1, 16, 768, 64, [530], None, torch.bfloat16),
    (1, 16, 1536, 64, [1400], None, torch.bfloat16),
    (1, 16, 2048, 128, [2047], [300], torch.float32),
    (2, 16, 512, 64, [190, 190], None, torch.bfloat16),
    (2, 8, 2048, 32, [5, 2000], [0, 1999], torch.bfloat16),
    (8, 16, 768, 64, [540] * 8, [0, 3, 9, 17, 40, 100, 257, 300], torch.bfloat16),
    (16, 16, 1024, 128, [900 - 50 * i for i in range(16)], [7 * i for i in range(16)],
     torch.bfloat16),
    (16, 4, 256, 32, list(range(0, 256, 16)), None, torch.float32),
])
def test_b3_kernel_matches_plain_across_shapes(dev, B, H, T, D, cur, lo, qdtype):
    q, k, v, *_ = _attn_operands(dev, B, H, T, D, qdtype)
    cur = torch.tensor(cur, device=dev, dtype=torch.int32)
    lo = None if lo is None else torch.tensor(lo, device=dev, dtype=torch.int32)
    before = A.launches["decode_attention_streamed"]
    _attn_close(A.decode_attention_streamed(q, k, v, cur, lo),
                A.decode_attention_streamed_plain(q, k, v, cur, lo))
    torch.cuda.synchronize()
    assert A.launches["decode_attention_streamed"] == before + 1


@pytest.mark.parametrize("B,H,T,D,cur", [
    (1, 16, 657, 64, [530]), (2, 16, 1000, 128, [999, 3]), (8, 16, 657, 32, [600] * 8),
    (16, 16, 2000, 64, [100 * i + 50 for i in range(16)]), (1, 4, 33, 64, [40]),
])
def test_b7_kernel_matches_plain_across_shapes(dev, B, H, T, D, cur):
    q, k, v, *_ = _attn_operands(dev, B, H, T, D, torch.bfloat16)
    cur = torch.tensor(cur, device=dev, dtype=torch.int32)
    before = A.launches["decode_attention"]
    _attn_close(A.decode_attention(q, k, v, cur), A.decode_attention_plain(q, k, v, cur))
    torch.cuda.synchronize()
    assert A.launches["decode_attention"] == before + 1


@pytest.mark.parametrize("S", [None, 1, 16])
def test_split_kernel_replays_in_a_cuda_graph_with_new_windows(dev, S):
    """One B3 launch (split_count's S, or a given one) captured in a CUDA
    graph; cur_len and lo changed on the device between replays, each replay
    compared with the plain version at the new values."""
    q, k, v, *_ = _attn_operands(dev, 2, 16, 768, 64, torch.bfloat16)
    cur = torch.tensor([530, 700], device=dev, dtype=torch.int32)
    lo = torch.tensor([0, 257], device=dev, dtype=torch.int32)
    S = S or A.split_count(2, 16, 768)
    call = lambda: A.decode_attention_streamed_split(q, k, v, cur, lo, S)  # noqa: E731
    call()                                       # warm-up: build and first launch
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for c, l in (([530, 700], [0, 257]), ([3, 767], [3, 40]), ([100, 1000], [99, 0]),
                 ([400, 20], [37, 21])):
        cur.copy_(torch.tensor(c, dtype=torch.int32))
        lo.copy_(torch.tensor(l, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        _attn_close(out, A.decode_attention_streamed_plain(q, k, v, cur, lo))


def test_split_wrappers_refuse_what_the_kernel_does_not_take(dev):
    q, k, v, *_ = _attn_operands(dev, 1, 4, 512, 64, torch.bfloat16)
    cur = torch.tensor([100], device=dev)
    base = torch.empty(k.numel() + 4, dtype=torch.bfloat16, device=dev)
    k_off = base[4:].view(k.shape)               # contiguous, 8 bytes off alignment
    k_off.copy_(k)
    with pytest.raises(ValueError, match="aligned"):
        A.decode_attention_streamed(q, k_off, v, cur)
    with pytest.raises(ValueError, match="aligned"):
        A.decode_attention(q, k_off, v, cur)
    for S in (0, A.MAX_SPLITS + 1):              # more blocks than a cluster holds
        with pytest.raises(ValueError, match="splits"):
            A.decode_attention_streamed_split(q, k, v, cur, None, S)
    with pytest.raises(ValueError, match="CUDA"):
        A.decode_attention_streamed_split(q.cpu(), k.cpu(), v.cpu(), cur.cpu(), None, 8)


def test_a_build_failure_raises_rather_than_falling_back(dev, tmp_path, monkeypatch):
    (tmp_path / "decode_attention.cu").write_text("this is not CUDA C++\n")
    monkeypatch.setattr(build, "SRC_DIR", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(A, "_lib", None)
    q, k, v, *_ = _attn_operands(dev, 1, 4, 256, 64, torch.bfloat16)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        A.decode_attention_streamed(q, k, v, torch.tensor([10], device=dev))


# ---------------------------------------------------------------------------
# int4 weights (B8, B9, B10) and the fused int8 MLP (B11)
# ---------------------------------------------------------------------------

def _packed(g, dev, N, K2):
    """Random packed int4 bytes stored out-major (N, K2) and per-group
    scales (N, K2 / 256) for each half."""
    G = K2 // 256
    w = torch.randint(-128, 128, (N, K2), generator=g, device=dev, dtype=torch.int8)
    s = lambda: torch.rand((N, G), generator=g, device=dev) * 1e-2
    return w, s(), s()


def _b8_operands(dev, B, K, N, dtype, seed=5):
    g = torch.Generator(device=dev).manual_seed(seed)
    wt, slo, shi = _packed(g, dev, N, K // 2)
    x = torch.randn((B, K), generator=g, device=dev).to(dtype)
    return x, wt.T, slo.T, shi.T              # the JAX layout, stored out-major


def _b9_operands(dev, B, D, dtype, seed=6):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    return (r(B, D).to(dtype), 1 + 0.1 * r(D), 0.1 * r(D), *_packed(g, dev, 3 * D, D // 2),
            0.01 * r(3 * D))


def _b10_operands(dev, B, D, I, dtype, seed=7):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    return ((0.5 * r(B, D)).to(dtype), r(B, D).to(dtype), *_packed(g, dev, D, D // 2),
            0.01 * r(D), 1 + 0.1 * r(D), 0.1 * r(D), *_packed(g, dev, I // 2, D),
            0.01 * r(I), *_packed(g, dev, D, I // 2), 0.01 * r(D))


def _b11_operands(dev, B, D, I, dtype, seed=8):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    i8 = lambda *s: torch.randint(-127, 128, s, generator=g, device=dev, dtype=torch.int8)
    u = lambda n: torch.rand(n, generator=g, device=dev) * 1e-3
    return ((0.5 * r(B, D)).to(dtype), 1 + 0.1 * r(D), 0.1 * r(D), i8(I, D).T, u(I),
            0.01 * r(I), i8(D, I).T, u(D), 0.01 * r(D))


# B8 / B9 sum exact f32 products in another order (outputs of order 1-10);
# B10 also rounds LN2 and the hidden units to bf16 (~1e-4 where a value
# crosses a rounding boundary). The shapes: every linear of the 520M layer
# (q/k/v/o 1024x1024, gate/up 1024x4096, down 4096x1024) at its decode rows.
@pytest.mark.parametrize("B,K,N,dtype", [(1, 1024, 1024, torch.bfloat16),
                                         (2, 1024, 4096, torch.bfloat16),
                                         (2, 4096, 1024, torch.bfloat16),
                                         (8, 4096, 1024, torch.bfloat16),
                                         (3, 512, 512, torch.float32)])
def test_matmul_int4_kernel_matches_plain(dev, B, K, N, dtype):
    from chatterbox_tpu_torch.kernels import int4_matmul as M
    ops = _b8_operands(dev, B, K, N, dtype)
    before = M.launches["matmul_int4"]
    out = M.matmul_int4(*ops)
    ref = M.matmul_int4_plain(*ops)
    torch.cuda.synchronize()
    assert M.launches["matmul_int4"] == before + 1
    assert out.shape == (B, N) and torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 1e-3


@pytest.mark.parametrize("B,D,I,dtype", [(1, 1024, 4096, torch.bfloat16),
                                         (2, 1024, 4096, torch.bfloat16),
                                         (5, 1024, 4096, torch.bfloat16),
                                         (16, 1024, 4096, torch.bfloat16),
                                         (2, 512, 2048, torch.float32)])
def test_int4_fused_kernels_match_plain(dev, B, D, I, dtype):
    before = dict(K.launches)
    ops = _b9_operands(dev, B, D, dtype)
    out, ref = K.ln_qkv_int4(*ops, EPS), K.ln_qkv_int4_plain(*ops, EPS)
    assert out.shape == (B, 3 * D) and (out - ref).abs().max().item() <= 1e-3
    ops = _b10_operands(dev, B, D, I, dtype)
    out, ref = K.attnout_ln_mlp_int4(*ops, EPS), K.attnout_ln_mlp_int4_plain(*ops, EPS)
    torch.cuda.synchronize()
    assert out.shape == (B, D) and torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 1e-2
    assert K.launches["ln_qkv_int4"] == before["ln_qkv_int4"] + 1
    assert K.launches["attnout_ln_mlp_int4"] == before["attnout_ln_mlp_int4"] + 1


# f32 outputs as B2's; bf16 outputs (x's type) within one bf16 ulp of their
# magnitude, where the f32 sums of the two orders round apart.
@pytest.mark.parametrize("B,dtype", [(1, torch.float32), (2, torch.float32),
                                     (8, torch.bfloat16), (16, torch.bfloat16)])
def test_fused_mlp_kernel_matches_plain(dev, B, dtype):
    from chatterbox_tpu_torch.kernels import fused_mlp as FM
    ops = _b11_operands(dev, B, 1024, 4096, dtype)
    before = FM.launches["fused_mlp_int8"]
    out, ref = FM.fused_mlp_int8(*ops), FM.fused_mlp_int8_plain(*ops)
    torch.cuda.synchronize()
    assert FM.launches["fused_mlp_int8"] == before + 1
    assert out.shape == (B, 1024) and out.dtype == dtype and torch.isfinite(out).all()
    tol = 1e-2 if dtype == torch.float32 else 2.0 ** -8 * ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= tol


def test_int4_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from chatterbox_tpu_torch.kernels import int4_matmul as M
    x, w, slo, shi = _b8_operands(dev, 2, 1024, 1024, torch.bfloat16)
    with pytest.raises(ValueError):          # more rows than B8 takes
        M.matmul_int4(x[:1].expand(9, -1).contiguous(), w, slo, shi)
    with pytest.raises(ValueError):          # weight stored in-major
        M.matmul_int4(x, w.contiguous(), slo, shi)
    x, w, slo, shi = _b8_operands(dev, 1, 768, 512, torch.bfloat16)
    with pytest.raises(ValueError):          # packed half of 384 rows
        M.matmul_int4(x, w, slo, shi)
    ops = list(_b9_operands(dev, 1, 1024, torch.bfloat16))
    ops[4] = ops[4].cpu()                    # scales left on the CPU
    with pytest.raises(ValueError):
        K.ln_qkv_int4(*ops, EPS)
    ops = list(_b10_operands(dev, 17, 512, 2048, torch.float32))
    with pytest.raises(ValueError):          # batch above 16 rows
        K.attnout_ln_mlp_int4(*ops, EPS)


# ---------------------------------------------------------------------------
# B8 and B6 on the tensor cores
# ---------------------------------------------------------------------------

LINEARS_520M = [(1024, 1024), (1024, 4096), (4096, 1024)]    # q/k/v/o, gate/up, down


def _close_b8(out, ref):
    """f32 outputs as B8's test above; bf16 outputs within one bf16 ulp of
    their magnitude (the f32 sums of the two orders may round apart)."""
    tol = 1e-3 if out.dtype == torch.float32 else 2.0 ** -8 * ref.float().abs().max().item()
    return (out.float() - ref.float()).abs().max().item() <= tol


# Every 520M linear at 1-8 rows, bf16 and f32 x, f32 and bf16 results.
@pytest.mark.parametrize("K,N", LINEARS_520M)
@pytest.mark.parametrize("B", [1, 2, 3, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_matmul_int4_tc_kernel_matches_plain(dev, K, N, B, dtype, out_dtype):
    from chatterbox_tpu_torch.kernels import int4_matmul as M
    ops = _b8_operands(dev, B, K, N, dtype, seed=K + N + B)
    out = M.matmul_int4(*ops, out_dtype)
    ref = M.matmul_int4_plain(*ops, out_dtype)
    torch.cuda.synchronize()
    assert out.shape == (B, N) and out.dtype == out_dtype and torch.isfinite(out).all()
    assert _close_b8(out, ref)


# Each tiling the kernel takes, at the 520M shapes and 2 and 8 rows.
@pytest.mark.parametrize("K,N", LINEARS_520M)
@pytest.mark.parametrize("cols,splits", [(16, 1), (16, 2), (16, 4), (32, 1), (32, 2), (32, 4)])
def test_matmul_int4_every_tiling_matches_plain(dev, K, N, cols, splits):
    from chatterbox_tpu_torch.kernels import int4_matmul as M
    for B in (2, 8):
        ops = _b8_operands(dev, B, K, N, torch.bfloat16, seed=cols + splits)
        out = M.matmul_int4_tiled(*ops, torch.float32, cols, splits)
        assert _close_b8(out, M.matmul_int4_plain(*ops))
    torch.cuda.synchronize()


def _b6_phases(ops, tw, tiling):
    """B6's three launches at `tiling` with r and h kept: (r, h, out)."""
    a = ops[0]
    B, D = a.shape
    I = ops[5].shape[0]
    r = torch.empty((B, D), device=a.device)
    h = torch.empty((B, I), dtype=torch.bfloat16, device=a.device)
    out = torch.empty((B, D), device=a.device)
    err = K._kernels().attnout_rms_glu_int8_launch(
        *(t.data_ptr() for t in ops[:2]), int(a.dtype == torch.bfloat16),
        *(t.data_ptr() for t in ops[2:]), r.data_ptr(), h.data_ptr(), out.data_ptr(),
        B, D, I, tw, EPS, *(int(t) for t in tiling), torch.cuda.current_stream().cuda_stream)
    assert err == 0
    return r, h, out


def _check_b6_phases(ops, tw, tiling):
    """Each phase against its plain step on the kernel's own input to it:
    r to f32 summation order; h (bf16) within one bf16 ulp of its magnitude
    (2**-7 of it, a value just under a power of two) where its f32 sums of
    the two orders round apart, plus 1e-4 of the largest |h| for the units
    near zero, and for at most 5 % of the units (the norm's f32 sum in
    another order moves many bf16 values of y and so of h by less than an
    ulp, 1.3 % of the units of h rounded apart in a run seen); out given r
    and h to f32
    summation order. The end-to-end error is not bounded here: one unit of h
    rounded apart moves every output of its row by up to ulp(h) * 127 * sd,
    and a few in a row (6-15 of 32768-65536 in the runs seen) reach 2e-2 at
    D = 2048, the first design's as much as this one's."""
    a, xres, wo, so, g2, wg, sg, wu, su, wd, sd = ops
    r, h, out = _b6_phases(ops, tw, tiling)
    torch.cuda.synchronize()
    r_ref = xres.float() + (a.to(torch.bfloat16).float() @ wo.float().T) * so
    assert (r - r_ref).abs().max().item() <= 1e-4
    y = K._rms_bf16(r, g2, EPS)
    ug, uu = (y @ wg.float().T) * sg, (y @ wu.float().T) * su
    h_ref = (ug * torch.sigmoid(ug) * uu).to(torch.bfloat16).float()
    dh = (h.float() - h_ref).abs()
    assert (dh <= 2.0 ** -7 * h_ref.abs() + 1e-4 * h_ref.abs().max()).all()
    assert (dh > 0).sum().item() <= h.numel() // 20
    o_ref = r.clone()
    for j in range(0, h.shape[1], tw):
        o_ref = o_ref + (h.float()[:, j:j + tw] @ wd[:, j:j + tw].float().T) * sd
    assert torch.isfinite(out).all() and (out - o_ref).abs().max().item() <= 1e-4


# B6 at 1-16 rows, D 512-2048, both hidden tiles, bf16 and f32 input, phase
# by phase (the end-to-end test at the 520M shapes is above).
@pytest.mark.parametrize("D,I", [(512, 2048), (1024, 4096), (2048, 4096)])
@pytest.mark.parametrize("B", [1, 2, 8, 16])
@pytest.mark.parametrize("tw", [512, 1024])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attnout_rms_glu_tc_phases_match_plain(dev, D, I, B, tw, dtype):
    ops = _b6_operands(dev, B, D, I, dtype, seed=D + B + tw)
    _check_b6_phases(ops, tw, K.glu_tiling(B, D, I, tw))
    before = K.launches["attnout_rms_glu_int8"]
    out = K.attnout_rms_glu_int8(*ops, EPS, tw)
    assert out.shape == (B, D) and K.launches["attnout_rms_glu_int8"] == before + 1


# Each tiling at the 520M shape, 2 and 16 rows, with and without
# programmatic dependent launch.
@pytest.mark.parametrize("attn,down", [(1, 1), (2, 2), (4, 4), (1, 4), (4, 1)])
@pytest.mark.parametrize("units", [16, 32])
@pytest.mark.parametrize("pdl", [False, True])
def test_attnout_rms_glu_every_tiling_matches_plain(dev, attn, down, units, pdl):
    for B in (2, 16):
        ops = _b6_operands(dev, B, 1024, 4096, torch.bfloat16, seed=attn + down + units)
        _check_b6_phases(ops, 1024, (attn, units, down, pdl))
        out = K.attnout_rms_glu_int8_tiled(*ops, EPS, 1024, attn, units, down, pdl)
        assert torch.equal(out, _b6_phases(ops, 1024, (attn, units, down, pdl))[2])


def test_b8_and_b6_replay_in_a_cuda_graph_with_new_inputs(dev):
    """Both kernels captured in one CUDA graph (B6 with its dependent
    launches) and replayed after new inputs are copied in."""
    from chatterbox_tpu_torch.kernels import int4_matmul as M
    b8 = list(_b8_operands(dev, 2, 4096, 1024, torch.bfloat16))
    b6 = list(_b6_operands(dev, 2, 1024, 4096, torch.bfloat16))
    M.matmul_int4(*b8, torch.bfloat16)
    K.attnout_rms_glu_int8(*b6, EPS, 1024)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out8 = M.matmul_int4(*b8, torch.bfloat16)
        out6 = K.attnout_rms_glu_int8(*b6, EPS, 1024)
    for seed in (11, 12):
        g = torch.Generator(device=dev).manual_seed(seed)
        b8[0].copy_(torch.randn(b8[0].shape, generator=g, device=dev))
        b6[0].copy_(torch.randn(b6[0].shape, generator=g, device=dev))
        b6[1].copy_(torch.randn(b6[1].shape, generator=g, device=dev))
        graph.replay()
        torch.cuda.synchronize()
        assert _close_b8(out8, M.matmul_int4_plain(*b8, torch.bfloat16))
        assert (out6 - K.attnout_rms_glu_int8_plain(*b6, EPS, 1024)).abs().max() <= 1e-2


def test_b8_and_b6_refuse_what_the_kernels_do_not_take(dev):
    from chatterbox_tpu_torch.kernels import int4_matmul as M
    x, w, slo, shi = _b8_operands(dev, 2, 1024, 1024, torch.bfloat16)
    with pytest.raises(ValueError):          # x not 16-byte aligned
        M.matmul_int4(torch.empty(2 * 1024 + 1, dtype=x.dtype, device=dev)[1:].view(2, 1024),
                      w, slo, shi)
    with pytest.raises(TypeError):           # a result type other than f32 / bf16
        M.matmul_int4(x, w, slo, shi, torch.float16)
    for cols, splits in ((8, 1), (16, 3), (16, 8)):  # tilings the kernel has no instance of
        with pytest.raises(ValueError):
            M.matmul_int4_tiled(x, w, slo, shi, torch.float32, cols, splits)
    ops = _b6_operands(dev, 2, 1024, 4096, torch.bfloat16)
    with pytest.raises(ValueError):          # down split 4 ways over 2 hidden tiles of 2048
        K.attnout_rms_glu_int8_tiled(*ops, EPS, 2048, 1, 32, 4, False)
    with pytest.raises(ValueError):          # 24 hidden units a block
        K.attnout_rms_glu_int8_tiled(*ops, EPS, 1024, 1, 24, 1, False)
    ops = list(_b6_operands(dev, 17, 1024, 4096, torch.bfloat16))
    with pytest.raises(ValueError):          # 17 rows
        K.attnout_rms_glu_int8(*ops, EPS, 1024)
    ops = list(_b6_operands(dev, 2, 1024, 4096, torch.bfloat16))
    ops[0] = torch.empty(2 * 1024 + 8, dtype=torch.bfloat16, device=dev)[4:-4].view(2, 1024)
    with pytest.raises(ValueError):          # a not 16-byte aligned
        K.attnout_rms_glu_int8(*ops, EPS, 1024)


# ---------------------------------------------------------------------------
# B9, B2 and B11 on the tensor cores
# ---------------------------------------------------------------------------

# B9 at every row count it takes (one 8-row MMA tile for 1-8 rows, two for
# 9-16), D 512-2048, both x types, at the tiling the wrapper picks: sums of
# exact f32 products in another order, and the norm's f32 sums in another
# order too, where a norm value may round to the other bf16 neighbour and
# move its row's outputs by up to ulp(y) * 7 * s (outputs of order 1-10).
@pytest.mark.parametrize("B", range(1, 17))
def test_ln_qkv_int4_tc_kernel_at_every_row_count(dev, B):
    for D in (512, 1024, 2048):
        for dtype in (torch.bfloat16, torch.float32):
            ops = _b9_operands(dev, B, D, dtype, seed=B + D)
            out = K.ln_qkv_int4(*ops, EPS)
            ref = K.ln_qkv_int4_plain(*ops, EPS)
            torch.cuda.synchronize()
            assert out.shape == (B, 3 * D) and torch.isfinite(out).all(), (D, dtype)
            assert (out - ref).abs().max().item() <= 1e-3, (D, dtype)


# Each tiling B9 has, at the Turbo width, 1, 8, 9 and 16 rows.
@pytest.mark.parametrize("cols", K.QKV4_COLS)
@pytest.mark.parametrize("B", [1, 8, 9, 16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ln_qkv_int4_every_tiling_matches_plain(dev, cols, B, dtype):
    ops = _b9_operands(dev, B, 1024, dtype, seed=cols + B)
    out = K.ln_qkv_int4_tiled(*ops, EPS, cols)
    torch.cuda.synchronize()
    assert (out - K.ln_qkv_int4_plain(*ops, EPS)).abs().max().item() <= 1e-3


def test_ln_qkv_int4_on_a_case_checked_by_hand(dev):
    """Row r of x is (r + 1) * (+1, -1, ...): unit gain and zero bias give
    y = (+1, -1, ...) exactly. Packed byte (n, k) holds c_n * sign(k) in
    both nibbles with c_n = n % 15 - 7, so each half of column n sums to
    (D / 2) c_n, and with every group scale 1 / D and bias 0.25 each output
    is 0.25 + c_n exactly (small integers and halves add exactly in f32)."""
    D, N = 1024, 3072
    K2 = D // 2
    sign = 1.0 - 2.0 * (torch.arange(D, device=dev) % 2)
    g, b = torch.ones(D, device=dev), torch.zeros(D, device=dev)
    c = torch.arange(N, device=dev) % 15 - 7
    nib = (c[:, None] * sign[None, :K2]).to(torch.int32)      # the same sign in both halves
    wp = ((nib & 15) | ((nib & 15) << 4)).to(torch.uint8).view(torch.int8)
    s = torch.full((N, K2 // 256), 1.0 / D, device=dev)
    bias = torch.full((N,), 0.25, device=dev)
    for B in (1, 2, 8, 9, 16):
        x = (torch.arange(1, B + 1, device=dev, dtype=torch.float32)[:, None] * sign).bfloat16()
        for cols in K.QKV4_COLS:
            out = K.ln_qkv_int4_tiled(x, g, b, wp, s, s, bias, EPS, cols)
            assert torch.equal(out, (0.25 + c.float()).expand(B, N)), (B, cols)


def _b2_phases(ops, tw, tiling):
    """B2's three launches at `tiling` with r and h kept: (r, h, out)."""
    a = ops[0]
    B, D = a.shape
    I = ops[7].shape[0]
    r = torch.empty((B, D), device=a.device)
    h = torch.empty((B, I), dtype=torch.bfloat16, device=a.device)
    out = torch.empty((B, D), device=a.device)
    err = K._kernels().attnout_ln_mlp_int8_launch(
        *(t.data_ptr() for t in ops[:2]), int(a.dtype == torch.bfloat16),
        *(t.data_ptr() for t in ops[2:]), r.data_ptr(), h.data_ptr(), out.data_ptr(),
        B, D, I, tw, EPS, *(int(t) for t in tiling), torch.cuda.current_stream().cuda_stream)
    assert err == 0
    return r, h, out


def _gelu_h(y, w1, s1, b1):
    return K._gelu_new_f32((y @ w1.float().T) * s1 + b1).to(torch.bfloat16).float()


def _h_close(h, h_ref):
    """h (bf16) within one bf16 ulp of its magnitude (2**-7 of it) where its
    f32 sums of the two orders round apart, plus 1e-4 of the largest |h|
    for the units near zero, and for at most 5 % of the units (the norm's
    f32 sums in another order move bf16 values of y, and so of h, by less
    than an ulp), as B6's check."""
    dh = (h.float() - h_ref).abs()
    return bool((dh <= 2.0 ** -7 * h_ref.abs() + 1e-4 * h_ref.abs().max()).all()
                and (dh > 0).sum().item() <= h.numel() // 20)


def _check_b2_phases(ops, tw, tiling):
    """Each phase against its plain step on the kernel's own input to it, as
    _check_b6_phases: r to f32 summation order (1e-4), h by _h_close, out
    given r and h to f32 summation order (1e-4), W2's tiles in order."""
    a, xres, wo, so, bo, g2, be2, w1, s1, b1, w2, s2, b2 = ops
    r, h, out = _b2_phases(ops, tw, tiling)
    torch.cuda.synchronize()
    r_ref = xres.float() + (a.to(torch.bfloat16).float() @ wo.float().T) * so + bo
    assert (r - r_ref).abs().max().item() <= 1e-4
    assert _h_close(h, _gelu_h(K._ln_bf16(r, g2, be2, EPS), w1, s1, b1))
    o_ref = r + b2
    for j in range(0, h.shape[1], tw):
        o_ref = o_ref + (h.float()[:, j:j + tw] @ w2[:, j:j + tw].float().T) * s2
    assert torch.isfinite(out).all() and (out - o_ref).abs().max().item() <= 1e-4
    return out


# B2 at 1-16 rows, D 512-2048, bf16 and f32 input, phase by phase, at the
# tiling the wrapper picks (the end-to-end tests at the Turbo shape are above).
@pytest.mark.parametrize("D,I", [(512, 2048), (1024, 4096), (2048, 4096)])
@pytest.mark.parametrize("B", [1, 2, 8, 16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attnout_ln_mlp_tc_phases_match_plain(dev, D, I, B, dtype):
    ops = _b2_operands(dev, B, D, I, dtype, seed=D + B)
    tiling = K.gelu_tiling(B, D, I, 1024)
    out = _check_b2_phases(ops, 1024, tiling)
    before = K.launches["attnout_ln_mlp_int8"]
    assert torch.equal(K.attnout_ln_mlp_int8(*ops, EPS), out)
    assert K.launches["attnout_ln_mlp_int8"] == before + 1


# Each tiling at the Turbo shape, 2 and 16 rows, with and without
# programmatic dependent launch.
@pytest.mark.parametrize("attn,down", [(1, 1), (2, 2), (4, 4), (1, 4), (4, 1)])
@pytest.mark.parametrize("units", K.GELU_UNITS)
@pytest.mark.parametrize("pdl", [False, True])
def test_attnout_ln_mlp_every_tiling_matches_plain(dev, attn, down, units, pdl):
    for B in (2, 16):
        ops = _b2_operands(dev, B, 1024, 4096, torch.bfloat16, seed=attn + down + units)
        out = _check_b2_phases(ops, 1024, (attn, units, down, pdl))
        assert torch.equal(out, K.attnout_ln_mlp_int8_tiled(*ops, EPS, 1024, attn, units,
                                                            down, pdl))


def _b11_phases(ops, tiling):
    """B11's two launches at (gelu_units, down_splits, pdl) with h kept:
    (h, out)."""
    x = ops[0]
    B, D = x.shape
    I = ops[3].shape[1]
    h = torch.empty((B, I), dtype=torch.bfloat16, device=x.device)
    out = torch.empty_like(x)
    from chatterbox_tpu_torch.kernels import fused_mlp as FM  # noqa: F401 (the wrapper's library)
    err = K._kernels().fused_mlp_int8_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), *(t.data_ptr() for t in ops[1:]),
        h.data_ptr(), out.data_ptr(), B, D, I, *(int(t) for t in tiling),
        torch.cuda.current_stream().cuda_stream)
    assert err == 0
    return h, out


def _check_b11_phases(ops, tiling):
    """h by _h_close on the kernel's own LayerNorm input; out given h to f32
    summation order (1e-4), or, in bf16, within half a bf16 ulp of the f32
    value (2**-8 of it) plus 1e-4."""
    x, g, b, w1, s1, b1, w2, s2, b2 = ops
    h, out = _b11_phases(ops, tiling)
    torch.cuda.synchronize()
    assert _h_close(h, _gelu_h(K._ln_bf16(x, g, b, 1e-5), w1.T, s1, b1))
    o_ref = x.float() + ((h.float() @ w2.float()) * s2 + b2)
    tol = 1e-4 + (0 if x.dtype == torch.float32 else 2.0 ** -8 * o_ref.abs())
    assert out.dtype == x.dtype and torch.isfinite(out).all()
    assert ((out.float() - o_ref).abs() <= tol).all()
    return out


@pytest.mark.parametrize("D,I", [(512, 2048), (1024, 4096), (2048, 4096)])
@pytest.mark.parametrize("B", [1, 2, 8, 16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_mlp_tc_phases_match_plain(dev, D, I, B, dtype):
    from chatterbox_tpu_torch.kernels import fused_mlp as FM
    ops = _b11_operands(dev, B, D, I, dtype, seed=D + B)
    out = _check_b11_phases(ops, K.gelu_tiling(B, D, I, None)[1:])
    before = FM.launches["fused_mlp_int8"]
    assert torch.equal(FM.fused_mlp_int8(*ops), out)
    assert FM.launches["fused_mlp_int8"] == before + 1


@pytest.mark.parametrize("down", [1, 2, 4])
@pytest.mark.parametrize("units", K.GELU_UNITS)
@pytest.mark.parametrize("pdl", [False, True])
def test_fused_mlp_every_tiling_matches_plain(dev, down, units, pdl):
    from chatterbox_tpu_torch.kernels import fused_mlp as FM
    for B, dtype in ((2, torch.float32), (16, torch.bfloat16)):
        ops = _b11_operands(dev, B, 1024, 4096, dtype, seed=down + units)
        out = _check_b11_phases(ops, (units, down, pdl))
        assert torch.equal(out, FM.fused_mlp_int8_tiled(*ops, units, down, pdl))


def test_b9_b2_b11_replay_in_a_cuda_graph_with_new_inputs(dev):
    """The three kernels captured in one CUDA graph (B2 and B11 with their
    dependent launches) and replayed after new inputs are copied in."""
    from chatterbox_tpu_torch.kernels import fused_mlp as FM
    b9 = list(_b9_operands(dev, 1, 1024, torch.bfloat16))
    b2 = list(_b2_operands(dev, 8, 1024, 4096, torch.bfloat16))
    b11 = list(_b11_operands(dev, 2, 1024, 4096, torch.float32))
    K.ln_qkv_int4(*b9, EPS)
    K.attnout_ln_mlp_int8(*b2, EPS)
    FM.fused_mlp_int8(*b11)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out9 = K.ln_qkv_int4(*b9, EPS)
        out2 = K.attnout_ln_mlp_int8(*b2, EPS)
        out11 = FM.fused_mlp_int8(*b11)
    for seed in (21, 22):
        g = torch.Generator(device=dev).manual_seed(seed)
        for t in (b9[0], b2[0], b2[1], b11[0]):
            t.copy_(torch.randn(t.shape, generator=g, device=dev))
        graph.replay()
        torch.cuda.synchronize()
        assert (out9 - K.ln_qkv_int4_plain(*b9, EPS)).abs().max() <= 1e-3
        assert (out2 - K.attnout_ln_mlp_int8_plain(*b2, EPS)).abs().max() <= 1e-2
        assert (out11 - FM.fused_mlp_int8_plain(*b11)).abs().max() <= 1e-2


def test_b9_b2_b11_refuse_what_the_kernels_do_not_take(dev):
    from chatterbox_tpu_torch.kernels import fused_mlp as FM
    ops = _b9_operands(dev, 2, 1024, torch.bfloat16)
    for cols in (8, 48, 128):                # tilings the kernel has no instance of
        with pytest.raises(ValueError):
            K.ln_qkv_int4_tiled(*ops, EPS, cols)
    x, g, b, wp, slo, shi, bias = _b9_operands(dev, 2, 1024, torch.bfloat16)
    n = 3072 - 16                            # not a multiple of 32 or 64 columns
    with pytest.raises(ValueError):
        K.ln_qkv_int4_tiled(x, g, b, wp[:n].contiguous(), slo[:n].contiguous(),
                            shi[:n].contiguous(), bias[:n].contiguous(), EPS, 32)
    # D = 8192 at 16 rows: the norm rows alone take 256 KB
    assert K.ln_qkv_int4_tiling(16, 8192, 3072) is None
    ops = list(_b9_operands(dev, 17, 1024, torch.float32))
    with pytest.raises(ValueError):          # 17 rows
        K.ln_qkv_int4(*ops, EPS)
    ops = _b2_operands(dev, 2, 1024, 4096, torch.bfloat16)
    with pytest.raises(ValueError):          # down split 4 ways over 2 hidden tiles of 2048
        K.attnout_ln_mlp_int8_tiled(*ops, EPS, 2048, 1, 32, 4, False)
    with pytest.raises(ValueError):          # 24 hidden units a block
        K.attnout_ln_mlp_int8_tiled(*ops, EPS, 1024, 1, 24, 1, False)
    with pytest.raises(ValueError):          # hidden tile not dividing I
        K.attnout_ln_mlp_int8(*ops, EPS, 1536)
    ops = _b11_operands(dev, 2, 1024, 4096, torch.bfloat16)
    with pytest.raises(ValueError):          # 3 down blocks
        FM.fused_mlp_int8_tiled(*ops, 32, 3, True)
    with pytest.raises(ValueError):          # 24 hidden units a block
        FM.fused_mlp_int8_tiled(*ops, 24, 1, True)
    ops = list(_b11_operands(dev, 2, 1024, 4096, torch.bfloat16))
    ops[0] = torch.empty(2 * 1024 + 8, dtype=torch.bfloat16, device=dev)[4:-4].view(2, 1024)
    with pytest.raises(ValueError):          # x not 16-byte aligned
        FM.fused_mlp_int8(*ops)


# ---------------------------------------------------------------------------
# B4 on the split kernel (the int8 cache)
# ---------------------------------------------------------------------------

def _int8_close(out, q, k_q, k_s, v_q, v_s, cur, lo, S):
    """B4 against its plain version (the Pallas order) and its split-plain
    version (the kernel's chunks and merge) at S splits: _attn_close's
    tolerance against each."""
    _attn_close(out, A.decode_attention_streamed_int8_plain(q, k_q, k_s, v_q, v_s, cur, lo))
    _attn_close(out, A.split_window_plain(q, k_q, v_q, cur, lo, S, k_s, v_s))


# The shapes of chip_smoke.py's phase 3 (Turbo's single stream at three
# positions, the 520M pair, the batched rows with their left pads, and the
# batched decode's own windows) at every split count the sweep times and 3.
B4_SHAPES = [(1, 768, [530], None), (1, 768, [200], None), (1, 768, [700], None),
             (2, 512, [190, 190], None),
             (8, 768, [540] * 8, [0, 3, 9, 17, 40, 100, 257, 300]),
             (8, 768, [430] * 8, [0, 3, 5, 8, 10, 13, 15, 18])]


@pytest.mark.parametrize("qdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,T,cur,lo", B4_SHAPES)
@pytest.mark.parametrize("S", [1, 2, 3, 4, 8, 16])
def test_int8_split_kernel_matches_plain_at_the_paths_shapes(dev, S, B, T, cur, lo, qdtype):
    q, _, _, k_q, k_s, v_q, v_s = _attn_operands(dev, B, 16, T, 64, qdtype, seed=S + B)
    cur = torch.tensor(cur, device=dev, dtype=torch.int32)
    lo = None if lo is None else torch.tensor(lo, device=dev, dtype=torch.int32)
    before = A.launches["decode_attention_streamed_int8"]
    out = A.decode_attention_streamed_int8_split(q, k_q, k_s, v_q, v_s, cur, lo, S)
    torch.cuda.synchronize()
    assert A.launches["decode_attention_streamed_int8"] == before + 1
    _int8_close(out, q, k_q, k_s, v_q, v_s, cur, lo, S)


# Windows of one key, fewer keys than S, S whole chunks and up to the end of
# the cache, from lower bounds on, and off, multiples of 8 keys.
@pytest.mark.parametrize("qdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("lo", SPLIT_LOS)
@pytest.mark.parametrize("window", ["one", "fewer", "boundary", "whole"])
@pytest.mark.parametrize("S", [1, 3, 8, 16])
def test_int8_split_kernel_matches_plain(dev, S, window, lo, qdtype):
    T = 768
    q, _, _, k_q, k_s, v_q, v_s = _attn_operands(dev, 2, 4, T, 64, qdtype, seed=S + lo)
    cur = torch.tensor([lo + _split_window(window, S, lo, T) - 1, T + 5], device=dev,
                       dtype=torch.int32)
    los = torch.tensor([lo, lo], device=dev, dtype=torch.int32)
    out = A.decode_attention_streamed_int8_split(q, k_q, k_s, v_q, v_s, cur, los, S)
    torch.cuda.synchronize()
    _int8_close(out, q, k_q, k_s, v_q, v_s, cur, los, S)


# The wrapper (split_count_int8's S) at head widths 32-128, caches up to 2048
# keys and 1-16 rows, and an empty window (lo past cur), which gives 0.
@pytest.mark.parametrize("B,H,T,D,cur,lo,qdtype", [
    (1, 16, 1536, 64, [1400], None, torch.bfloat16),
    (1, 16, 2048, 128, [2047], [301], torch.float32),
    (2, 8, 2048, 32, [5, 2000], [0, 1999], torch.bfloat16),
    (16, 16, 1024, 128, [900 - 50 * i for i in range(16)], [7 * i for i in range(16)],
     torch.bfloat16),
    (16, 4, 256, 32, list(range(0, 256, 16)), None, torch.float32),
    (2, 16, 512, 64, [40, 300], [41, 13], torch.bfloat16),
])
def test_b4_kernel_matches_plain_across_shapes(dev, B, H, T, D, cur, lo, qdtype):
    q, _, _, k_q, k_s, v_q, v_s = _attn_operands(dev, B, H, T, D, qdtype)
    cur = torch.tensor(cur, device=dev, dtype=torch.int32)
    lo = None if lo is None else torch.tensor(lo, device=dev, dtype=torch.int32)
    out = A.decode_attention_streamed_int8(q, k_q, k_s, v_q, v_s, cur, lo)
    torch.cuda.synchronize()
    _int8_close(out, q, k_q, k_s, v_q, v_s, cur, lo, A.split_count_int8(B, H, T))
    if lo is not None and int(lo[0]) > int(cur[0]):
        assert not out[0].float().abs().max()


@pytest.mark.parametrize("S", [None, 1, 16])
def test_int8_split_kernel_replays_in_a_cuda_graph_with_new_windows(dev, S):
    """One B4 launch captured in a CUDA graph; cur_len and lo changed on the
    device between replays (lower bounds on and off multiples of 8), each
    replay compared with the plain versions at the new values."""
    q, _, _, k_q, k_s, v_q, v_s = _attn_operands(dev, 2, 16, 768, 64, torch.bfloat16)
    cur = torch.tensor([530, 700], device=dev, dtype=torch.int32)
    lo = torch.tensor([0, 257], device=dev, dtype=torch.int32)
    S = S or A.split_count_int8(2, 16, 768)
    call = lambda: A.decode_attention_streamed_int8_split(  # noqa: E731
        q, k_q, k_s, v_q, v_s, cur, lo, S)
    call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for c, l in (([530, 700], [0, 257]), ([3, 767], [3, 40]), ([100, 1000], [99, 0]),
                 ([400, 20], [37, 21])):
        cur.copy_(torch.tensor(c, dtype=torch.int32))
        lo.copy_(torch.tensor(l, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        _int8_close(out, q, k_q, k_s, v_q, v_s, cur, lo, S)


def test_int8_split_wrappers_refuse_what_the_kernel_does_not_take(dev):
    q, _, _, k_q, k_s, v_q, v_s = _attn_operands(dev, 1, 4, 512, 64, torch.bfloat16)
    cur = torch.tensor([100], device=dev)
    base = torch.empty(k_s.numel() + 1, dtype=torch.bfloat16, device=dev)
    ks_off = base[1:].view(k_s.shape)            # contiguous, 2 bytes off alignment
    ks_off.copy_(k_s)
    with pytest.raises(ValueError, match="aligned"):
        A.decode_attention_streamed_int8(q, k_q, ks_off, v_q, v_s, cur)
    wide = torch.empty((1, 4, 1024), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="contiguous"):      # every other key's scale
        A.decode_attention_streamed_int8(q, k_q, wide[..., ::2], v_q, v_s, cur)
    with pytest.raises(TypeError):               # f32 scales
        A.decode_attention_streamed_int8(q, k_q, k_s.float(), v_q, v_s, cur)
    with pytest.raises(ValueError):              # head width the template lacks
        A.decode_attention_streamed_int8(q[..., :16].contiguous(), k_q[..., :16].contiguous(),
                                         k_s, v_q[..., :16].contiguous(), v_s, cur)
    with pytest.raises(ValueError):              # cache length not a multiple of 256
        A.decode_attention_streamed_int8(q, k_q[:, :, :300].contiguous(),
                                         k_s[:, :, :300].contiguous(),
                                         v_q[:, :, :300].contiguous(),
                                         v_s[:, :, :300].contiguous(), cur)
    for S in (0, A.MAX_SPLITS + 1):
        with pytest.raises(ValueError, match="splits"):
            A.decode_attention_streamed_int8_split(q, k_q, k_s, v_q, v_s, cur, None, S)
    with pytest.raises(ValueError, match="CUDA"):
        A.decode_attention_streamed_int8_split(q.cpu(), k_q.cpu(), k_s.cpu(), v_q.cpu(),
                                               v_s.cpu(), cur.cpu(), None, 8)


# ---------------------------------------------------------------------------
# B10 on the tensor cores
# ---------------------------------------------------------------------------

def _deq_rows(w, s_lo, s_hi):
    """Out-major row-split packed w (N, K2) and its group scales (N, K2 /
    256) -> the f32 weight (N, 2 K2) they stand for."""
    lo, hi = K.unpack_int4(w)
    return torch.cat([lo * s_lo.repeat_interleave(256, 1), hi * s_hi.repeat_interleave(256, 1)],
                     dim=1)


def _deq_cols(w, s_lo, s_hi):
    """Out-major column-split packed w (IH, D) and its group scales (IH, D /
    256) -> the f32 weight (2 IH, D): units c, then c + IH."""
    lo, hi = K.unpack_int4(w)
    return torch.cat([lo * s_lo.repeat_interleave(256, 1), hi * s_hi.repeat_interleave(256, 1)],
                     dim=0)


def _b10_phases(ops, tiling):
    """B10's three launches at (attn_cols, fc_in_cols, down_cols,
    down_splits, pdl) with r and h kept: (r, h, out)."""
    a = ops[0]
    B, D = a.shape
    I = 2 * ops[8].shape[0]
    r = torch.empty((B, D), device=a.device)
    h = torch.empty((B, I), dtype=torch.bfloat16, device=a.device)
    out = torch.empty((B, D), device=a.device)
    err = K.int4_kernels().attnout_ln_mlp_int4_launch(
        *(t.data_ptr() for t in ops[:2]), int(a.dtype == torch.bfloat16),
        *(t.data_ptr() for t in ops[2:]), r.data_ptr(), h.data_ptr(), out.data_ptr(),
        B, D, I, EPS, *(int(t) for t in tiling), torch.cuda.current_stream().cuda_stream)
    assert err == 0
    return r, h, out


def _check_b10_phases(ops, tiling):
    """Each phase against its plain step on the kernel's own input to it, as
    _check_b2_phases: r to f32 summation order (1e-4), h by _h_close (the
    bf16 units of LN2's output and of h that another order of f32 sums
    rounds apart), out given r and h to f32 summation order (1e-4)."""
    a, xres, wo, so_lo, so_hi, bo, g2, be2, w1c, s1_lo, s1_hi, b1, w2, s2_lo, s2_hi, b2 = ops
    r, h, out = _b10_phases(ops, tiling)
    torch.cuda.synchronize()
    r_ref = xres.float() + a.to(torch.bfloat16).float() @ _deq_rows(wo, so_lo, so_hi).T + bo
    assert (r - r_ref).abs().max().item() <= 1e-4
    y = K._ln_bf16(r, g2, be2, EPS)
    h_ref = K._gelu_new_f32(b1 + y @ _deq_cols(w1c, s1_lo, s1_hi).T).to(torch.bfloat16).float()
    assert _h_close(h, h_ref)
    o_ref = (r + b2) + h.float() @ _deq_rows(w2, s2_lo, s2_hi).T
    assert torch.isfinite(out).all() and (out - o_ref).abs().max().item() <= 1e-4
    return out


# B10 at 1-16 rows, D 512-2048, bf16 and f32 input, phase by phase, at the
# tiling the wrapper picks (the end-to-end tests at the Turbo shape are above).
@pytest.mark.parametrize("D,I", [(512, 2048), (1024, 4096), (2048, 4096)])
@pytest.mark.parametrize("B", [1, 2, 8, 16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attnout_ln_mlp_int4_tc_phases_match_plain(dev, D, I, B, dtype):
    ops = _b10_operands(dev, B, D, I, dtype, seed=D + B)
    out = _check_b10_phases(ops, K.int4_mlp_tiling(B, D, I))
    before = K.launches["attnout_ln_mlp_int4"]
    assert torch.equal(K.attnout_ln_mlp_int4(*ops, EPS), out)
    assert K.launches["attnout_ln_mlp_int4"] == before + 1


# Each tiling at the Turbo shape, 2 and 16 rows, with and without
# programmatic dependent launch (attn-out at the columns of fc_out).
@pytest.mark.parametrize("down_cols,down_splits", [(16, 1), (16, 2), (16, 4), (32, 1),
                                                   (32, 2), (32, 4)])
@pytest.mark.parametrize("fc_in_cols", K.MLP4_FC_IN_COLS)
@pytest.mark.parametrize("pdl", [False, True])
def test_attnout_ln_mlp_int4_every_tiling_matches_plain(dev, down_cols, down_splits,
                                                        fc_in_cols, pdl):
    tiling = (down_cols, fc_in_cols, down_cols, down_splits, pdl)
    for B in (2, 16):
        ops = _b10_operands(dev, B, 1024, 4096, torch.bfloat16, seed=down_splits + fc_in_cols)
        out = _check_b10_phases(ops, tiling)
        assert torch.equal(out, K.attnout_ln_mlp_int4_tiled(*ops, EPS, *tiling))


def test_b4_and_b10_replay_in_a_cuda_graph_with_new_inputs(dev):
    """B10 (with its dependent launches) and B4 captured in one CUDA graph
    and replayed after new inputs, cur_len and lo are copied in."""
    b10 = list(_b10_operands(dev, 8, 1024, 4096, torch.bfloat16))
    q, _, _, k_q, k_s, v_q, v_s = _attn_operands(dev, 8, 16, 768, 64, torch.bfloat16)
    cur = torch.full((8,), 540, device=dev, dtype=torch.int32)
    lo = torch.tensor([0, 3, 9, 17, 40, 100, 257, 300], device=dev, dtype=torch.int32)
    K.attnout_ln_mlp_int4(*b10, EPS)
    A.decode_attention_streamed_int8(q, k_q, k_s, v_q, v_s, cur, lo)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out10 = K.attnout_ln_mlp_int4(*b10, EPS)
        out4 = A.decode_attention_streamed_int8(q, k_q, k_s, v_q, v_s, cur, lo)
    for seed in (31, 32):
        g = torch.Generator(device=dev).manual_seed(seed)
        for t in (b10[0], b10[1], q):
            t.copy_(torch.randn(t.shape, generator=g, device=dev))
        cur.add_(seed - 30)
        lo.add_(1)
        graph.replay()
        torch.cuda.synchronize()
        assert (out10 - K.attnout_ln_mlp_int4_plain(*b10, EPS)).abs().max() <= 1e-2
        _attn_close(out4, A.decode_attention_streamed_int8_plain(q, k_q, k_s, v_q, v_s, cur,
                                                                 lo))


def test_b10_refuses_what_the_kernel_does_not_take(dev):
    ops = list(_b10_operands(dev, 17, 1024, 4096, torch.bfloat16))
    with pytest.raises(ValueError):          # 17 rows
        K.attnout_ln_mlp_int4(*ops, EPS)
    ops = _b10_operands(dev, 2, 1024, 4096, torch.bfloat16)
    for tiling in ((24, 32, 16, 2, True), (16, 48, 16, 2, True), (16, 32, 16, 3, True),
                   (16, 32, 64, 2, True)):   # tilings the kernel has no instance of
        with pytest.raises(ValueError):
            K.attnout_ln_mlp_int4_tiled(*ops, EPS, *tiling)
    ops = list(_b10_operands(dev, 2, 1024, 4096, torch.bfloat16))
    ops[8] = ops[8].T.contiguous().T         # fc_in stored in-major
    with pytest.raises(ValueError):
        K.attnout_ln_mlp_int4(*ops, EPS)
    ops = list(_b10_operands(dev, 2, 1024, 4096, torch.bfloat16))
    ops[0] = torch.empty(2 * 1024 + 8, dtype=torch.bfloat16, device=dev)[4:-4].view(2, 1024)
    with pytest.raises(ValueError):          # a not 16-byte aligned
        K.attnout_ln_mlp_int4(*ops, EPS)
    ops = list(_b10_operands(dev, 2, 768, 3072, torch.bfloat16))
    with pytest.raises(ValueError):          # width 768: a packed half of 384 rows
        K.attnout_ln_mlp_int4(*ops, EPS)


# ---------------------------------------------------------------------------
# HiFT's harmonic source (csrc/hift_source.cu)
# ---------------------------------------------------------------------------
def _source_operands(dev, B, T, seed):
    """f0 voiced 60-460 Hz with a tenth of the frames low (0-10 Hz), the
    source linear, the noise and a carry, on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s, **k: torch.rand(s, generator=g, device=dev, **k)
    f0 = torch.where(r(B, T) < 0.1, 10 * r(B, T), 60 + 400 * r(B, T))
    params = {"m_source_linear": {"w": torch.randn((9, 1), generator=g, device=dev),
                                  "b": torch.randn((1,), generator=g, device=dev)}}
    return params, f0, H.SourceNoise.draw(B, T, g, dev), r(B, 9, dtype=torch.float64)


def test_the_plain_f0_steps_are_products_with_the_reciprocal(dev):
    """The kernel computes f0 * h / 24000 as the card's torch does: the f32
    product, then the product with fl32(1 / 24000) (not the quotient)."""
    f0 = 60 + 400 * torch.rand((4, 5000), device=dev)
    h = torch.arange(1, 10, dtype=torch.float32, device=dev)
    inv = torch.tensor(float(np.float32(1) / np.float32(24000)), device=dev)
    assert torch.equal(H._harmonic_steps(f0), (f0[..., None] * h) * inv)


# The kernel sums the phase as hift_source_framewise_plain does, bit for bit,
# and computes the sines and the noise as the plain code; it merges the nine
# harmonics by an fma chain where the plain code calls cuBLAS, so the sums
# differ in their last bits (about 1e-7). Against the plain cumsum the phase
# also differs by the cumsum's own rounding (at most 2^-24 cycles).
@pytest.mark.parametrize("with_carry", [False, True])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("T", [1, 3, 257, 2000])
def test_hift_source_kernel_matches_plain(dev, T, B, with_carry):
    params, f0, noise, carry = _source_operands(dev, B, T, seed=10 * T + B)
    carry = carry if with_carry else None
    before = KS.launches["hift_source"]
    out = H.hift_source(params, f0, noise, carry)
    assert KS.launches["hift_source"] == before + 1
    framewise = H.hift_source_framewise_plain(params, f0, noise, carry)
    plain = H._source_from_phase(params, f0, H.harmonic_phase(f0, carry), noise)
    torch.cuda.synchronize()
    assert out.shape == (B, T * H.TOTAL_UPSAMPLE, 1) and out.dtype == torch.float32
    assert (out - framewise).abs().max().item() <= 1e-6
    assert (out - plain).abs().max().item() <= 1e-6


def test_hift_source_kernel_takes_a_noise_view(dev):
    params, f0, noise, carry = _source_operands(dev, 2, 40, seed=3)
    wide = torch.randn((2, 40 * H.TOTAL_UPSAMPLE, 18), device=dev)
    view = H.SourceNoise(noise.phase[:1].expand(2, 1, 9), wide[:, :, ::2])   # strides 0, 2
    assert not view.noise_u.is_contiguous()
    out = H.hift_source(params, f0, view, carry)
    ref = H.hift_source_framewise_plain(params, f0,
                                        H.SourceNoise(view.phase, view.noise_u.contiguous()),
                                        carry)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 1e-6


def test_hift_inference_counts_one_source_launch_a_call(dev):
    params = H.hift_init(nn.Init(0, dev), base_channels=32)
    mel = torch.randn((1, 12, 80), device=dev)
    before = KS.launches["hift_source"]
    for seed in range(3):
        H.hift_inference(params, mel, generator=torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    assert KS.launches["hift_source"] == before + 3


def test_hift_source_refuses_what_the_kernel_does_not_take(dev):
    params, f0, noise, carry = _source_operands(dev, 2, 5, seed=4)
    before = KS.launches["hift_source"]
    with pytest.raises(ValueError, match="no path"):        # a bf16 f0 on the card
        H.hift_source(params, f0.bfloat16(), noise)
    with pytest.raises(TypeError):                          # float64 noise
        H.hift_source(params, f0, H.SourceNoise(noise.phase, noise.noise_u.double()))
    with pytest.raises(ValueError):                         # noise one sample short
        H.hift_source(params, f0, H.SourceNoise(noise.phase, noise.noise_u[:, 1:]))
    with pytest.raises(ValueError):                         # phases left on the CPU
        H.hift_source(params, f0, H.SourceNoise(noise.phase.cpu(), noise.noise_u))
    with pytest.raises(ValueError):                         # one carry for two rows
        H.hift_source(params, f0, noise, carry[:1])
    bf16 = {"m_source_linear": {k: v.bfloat16() for k, v in params["m_source_linear"].items()}}
    with pytest.raises(TypeError):                          # a bf16 source linear
        H.hift_source(bf16, f0, noise)
    assert KS.launches["hift_source"] == before


def test_hift_source_cold_build_time(dev, tmp_path, monkeypatch):
    """nvcc of csrc/hift_source.cu alone, from nothing (printed; the first
    conversion of a checkout pays it in its set-up)."""
    import time
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    t0 = time.perf_counter()
    build._finish("hift_source", *build._start("hift_source"))
    seconds = time.perf_counter() - t0
    print(f"cold nvcc of hift_source.cu: {seconds:.2f} s")
    assert (tmp_path / "_build" / "libhift_source.so").exists() and seconds < 60
