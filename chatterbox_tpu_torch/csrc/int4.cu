// Kernels with int4 weights, for Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels:
//   B8  matmul_int4          (chatterbox_tpu/ops/int4_matmul.py, _int4_matvec_kernel):
//         out = sum over groups g of (bf16(x_lo) @ lo_g) * s_lo[g]
//                                  + (bf16(x_hi) @ hi_g) * s_hi[g]        (B <= 8 rows)
//   B9  ln_qkv_int4          (chatterbox_tpu/ops/fused_layer.py, _ln_qkv_kernel):
//         out = bias + the same product over y = bf16(LN1(x))
//   B10 attnout_ln_mlp_int4  (chatterbox_tpu/ops/fused_layer.py, _attnout_ln_mlp_kernel):
//         r   = xres + (bf16(a) @ Wo) + bo;   y2 = bf16(LN2(r))
//         u   = b1 + y2 @ W1;   h = bf16(gelu_new(u))
//         out = r + b2 + h @ W2
//       (B9 and B10 take 1-16 rows, as B1 and B2 do.)
// Packings (utils/quantize.py), one byte per two int4 values in [-7, 7]:
//   row split (B8 weights, Wqkv, Wo, W2): byte[r, n] holds W[r, n] in the
//     low nibble and W[r + K/2, n] in the high one; a scale per 256 rows of
//     each half and output column (s_lo, s_hi);
//   column split (W1): byte[r, c] holds W[r, c] low and W[r, c + N/2] high;
//     a scale per 256 rows and packed column for each half.
// Scales multiply each group's f32 sum of exact products.
//
// What bounds them: at 1-16 rows each packed byte is read once and feeds 4
// operations per row, so the weight bytes over the memory rate bound them.
// GPT-2-medium (D=1024, I=4096): B9 reads 1.57 MB of weights and 0.05 MB
// of scales (0.49 us at the H100 SXM's 3.35 TB/s), B10 4.72 + 0.14 MB
// (1.46 us); a Llama-520M layer's seven B8 calls 8.39 + 0.26 MB (2.58 us).
// Half of what the int8 kernels B1, B2, B5 and B6 read for the same layer.
//
// Design (B1 / B2's, simple and right first; no TMA / wgmma / split-K):
//   * Packed weights and scales are stored OUT-MAJOR: (N, K/2) bytes and
//     (N, G) scales for the row split, (N/2, K) and (N/2, G) for the column
//     split. One warp owns one output column (B10's phase 2: one packed
//     column, i.e. hidden units c and c + I/2) and streams its bytes with
//     16-byte loads, 512 bytes a warp per iteration.
//   * 16 packed bytes are 16 rows of one 256-row group, so a lane scales
//     its partial sums per load; the high nibble comes from the signed byte
//     by an arithmetic shift, the low one as ((b & 15) ^ 8) - 8.
//   * B8 stages x as bf16 in shared memory (8 rows of K = 4096: 64 KB); B9
//     and B10's phase 2 recompute the LayerNorm rows in every block, as B1
//     does; B10 is three launches on one stream, as B2 is: attn-out +
//     residual, LN2 + fc_in + gelu, fc_out + residual, with r (f32) and h
//     (bf16) in global scratch.

#include "common.cuh"

namespace {

constexpr int GROUP = 256;                 // rows per scale group

// The 16 packed bytes at w as their 16 low and 16 high nibble values.
__device__ __forceinline__ void unpack16(const int8_t* __restrict__ w, float lo[16],
                                         float hi[16]) {
  const int4 pk = __ldg(reinterpret_cast<const int4*>(w));
  const int8_t* b = reinterpret_cast<const int8_t*>(&pk);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int v = b[j];                    // sign-extended
    lo[j] = (float)(((v & 15) ^ 8) - 8);
    hi[j] = (float)(v >> 4);               // arithmetic shift of the signed byte
  }
}

// Row split, one out-major packed column wp (K2 bytes, scales s_lo / s_hi
// of K2 / GROUP each): acc[r] = sum over groups of (x_lo @ lo_g) * s_lo[g]
// + (x_hi @ hi_g) * s_hi[g], where row r of xs holds x_lo at xs + r * ldx
// and x_hi K2 further. Summed over the warp; K2 % GROUP == 0.
template <int NB, typename XT>
__device__ __forceinline__ void warp_dot_i4(const int8_t* __restrict__ wp,
                                            const float* __restrict__ s_lo,
                                            const float* __restrict__ s_hi, const XT* xs,
                                            int K2, int ldx, int B, float acc[NB]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < NB; ++r) acc[r] = 0.f;
#pragma unroll 2
  for (int k0 = lane * 16; k0 < K2; k0 += K_STEP) {
    float lo[16], hi[16];
    unpack16(wp + k0, lo, hi);
    const float sl = __ldg(s_lo + k0 / GROUP), sh = __ldg(s_hi + k0 / GROUP);
#pragma unroll
    for (int r = 0; r < NB; ++r)
      if (r < B) {
        const XT* xr = xs + (size_t)r * ldx + k0;
        acc[r] += dot16(xr, lo) * sl + dot16(xr + K2, hi) * sh;
      }
  }
#pragma unroll
  for (int r = 0; r < NB; ++r) acc[r] = warp_sum(acc[r]);
}

// Column split, one out-major packed column wc (K bytes, scales of
// K / GROUP): a[r] = sum over groups of (x @ lo_g) * s_lo[g] and b[r] the
// same over the high nibbles, x = row r of xs (f32, stride ldx).
template <int NB>
__device__ __forceinline__ void warp_dot_i4c(const int8_t* __restrict__ wc,
                                             const float* __restrict__ s_lo,
                                             const float* __restrict__ s_hi, const float* xs,
                                             int K, int ldx, int B, float a[NB], float b[NB]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < NB; ++r) a[r] = b[r] = 0.f;
#pragma unroll 2
  for (int k0 = lane * 16; k0 < K; k0 += K_STEP) {
    float lo[16], hi[16];
    unpack16(wc + k0, lo, hi);
    const float sl = __ldg(s_lo + k0 / GROUP), sh = __ldg(s_hi + k0 / GROUP);
#pragma unroll
    for (int r = 0; r < NB; ++r)
      if (r < B) {
        const float* xr = xs + (size_t)r * ldx + k0;
        a[r] += dot16(xr, lo) * sl;
        b[r] += dot16(xr, hi) * sh;
      }
  }
#pragma unroll
  for (int r = 0; r < NB; ++r) {
    a[r] = warp_sum(a[r]);
    b[r] = warp_sum(b[r]);
  }
}

// B8: x (B, 2 * K2) -> out (B, N) f32; grid = ceil(N / WARPS).
template <typename T, int NB>
__global__ void __launch_bounds__(THREADS)
matmul_int4_kernel(const T* __restrict__ x, const int8_t* __restrict__ wp_t,
                   const float* __restrict__ slo_t, const float* __restrict__ shi_t,
                   float* __restrict__ out, int B, int K2, int N) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem4);
  const int K = 2 * K2;
  for (int i = threadIdx.x; i < B * K; i += blockDim.x) xs[i] = __float2bfloat16(to_f32(x[i]));
  __syncthreads();
  const int n = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (n >= N) return;
  const int G = K2 / GROUP;
  float acc[NB];
  warp_dot_i4<NB>(wp_t + (size_t)n * K2, slo_t + (size_t)n * G, shi_t + (size_t)n * G, xs, K2,
                  K, B, acc);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int r = 0; r < NB; ++r)
      if (r < B) out[(size_t)r * N + n] = acc[r];
  }
}

// B9: out = bias + (bf16(LN(x)) @ W); grid = ceil(N / WARPS).
template <typename T, int NB>
__global__ void __launch_bounds__(THREADS)
ln_qkv_int4_kernel(const T* __restrict__ x, const float* __restrict__ g,
                   const float* __restrict__ b, const int8_t* __restrict__ wp_t,
                   const float* __restrict__ slo_t, const float* __restrict__ shi_t,
                   const float* __restrict__ bias, float* __restrict__ out, int B, int D, int N,
                   float eps) {
  extern __shared__ float4 smem4[];
  float* ys = reinterpret_cast<float*>(smem4);
  float* red = ys + (size_t)B * D;
  norm_bf16<T, false>(x, g, b, B, D, eps, ys, red);
  const int n = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (n >= N) return;
  const int K2 = D / 2, G = K2 / GROUP;
  float acc[NB];
  warp_dot_i4<NB>(wp_t + (size_t)n * K2, slo_t + (size_t)n * G, shi_t + (size_t)n * G, ys, K2,
                  D, B, acc);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int r = 0; r < NB; ++r)
      if (r < B) out[(size_t)r * N + n] = bias[n] + acc[r];
  }
}

// B10 phase 1: r = xres + (bf16(a) @ Wo) + bo; grid = ceil(D / WARPS).
template <typename T, int NB>
__global__ void __launch_bounds__(THREADS)
attn_out_int4_kernel(const T* __restrict__ a, const T* __restrict__ xres,
                     const int8_t* __restrict__ wo_t, const float* __restrict__ slo_t,
                     const float* __restrict__ shi_t, const float* __restrict__ bo,
                     float* __restrict__ r_out, int B, int D) {
  extern __shared__ float4 smem4[];
  float* as = reinterpret_cast<float*>(smem4);
  for (int i = threadIdx.x; i < B * D; i += blockDim.x) as[i] = round_bf16(to_f32(a[i]));
  __syncthreads();
  const int n = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (n >= D) return;
  const int K2 = D / 2, G = K2 / GROUP;
  float acc[NB];
  warp_dot_i4<NB>(wo_t + (size_t)n * K2, slo_t + (size_t)n * G, shi_t + (size_t)n * G, as, K2,
                  D, B, acc);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int r = 0; r < NB; ++r)
      if (r < B) r_out[(size_t)r * D + n] = to_f32(xres[(size_t)r * D + n]) + acc[r] + bo[n];
  }
}

// B10 phase 2: y2 = bf16(LN2(r)); packed column c gives hidden units c
// (low nibbles) and c + I/2 (high): h = bf16(gelu_new(b1 + y2 @ W1));
// grid = ceil((I / 2) / WARPS).
template <int NB>
__global__ void __launch_bounds__(THREADS)
ln_fc_in_int4_kernel(const float* __restrict__ r, const float* __restrict__ g2,
                     const float* __restrict__ be2, const int8_t* __restrict__ w1c_t,
                     const float* __restrict__ slo_t, const float* __restrict__ shi_t,
                     const float* __restrict__ b1, __nv_bfloat16* __restrict__ h, int B, int D,
                     int I, float eps) {
  extern __shared__ float4 smem4[];
  float* ys = reinterpret_cast<float*>(smem4);
  float* red = ys + (size_t)B * D;
  norm_bf16<float, false>(r, g2, be2, B, D, eps, ys, red);
  const int IH = I / 2;
  const int c = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (c >= IH) return;
  const int G = D / GROUP;
  float ua[NB], ub[NB];
  warp_dot_i4c<NB>(w1c_t + (size_t)c * D, slo_t + (size_t)c * G, shi_t + (size_t)c * G, ys, D,
                   D, B, ua, ub);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int rr = 0; rr < NB; ++rr)
      if (rr < B) {
        h[(size_t)rr * I + c] = __float2bfloat16(gelu_new(b1[c] + ua[rr]));
        h[(size_t)rr * I + IH + c] = __float2bfloat16(gelu_new(b1[IH + c] + ub[rr]));
      }
  }
}

// B10 phase 3: out = (r + b2) + h @ W2 (row split: the low nibble of
// packed row k pairs with hidden unit k, the high with k + I/2);
// grid = ceil(D / WARPS).
template <int NB>
__global__ void __launch_bounds__(THREADS)
down_int4_kernel(const __nv_bfloat16* __restrict__ h, const float* __restrict__ r,
                 const int8_t* __restrict__ w2_t, const float* __restrict__ slo_t,
                 const float* __restrict__ shi_t, const float* __restrict__ b2,
                 float* __restrict__ out, int B, int D, int I) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem4);
  {  // B * I bf16 is a multiple of 8 (I % 512 == 0): copy 16 bytes a thread
    const uint4* src = reinterpret_cast<const uint4*>(h);
    uint4* dst = reinterpret_cast<uint4*>(hs);
    for (int i = threadIdx.x; i < B * I / 8; i += blockDim.x) dst[i] = src[i];
  }
  __syncthreads();
  const int n = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (n >= D) return;
  const int IH = I / 2, G = IH / GROUP;
  float acc[NB];
  warp_dot_i4<NB>(w2_t + (size_t)n * IH, slo_t + (size_t)n * G, shi_t + (size_t)n * G, hs, IH,
                  I, B, acc);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int rr = 0; rr < NB; ++rr)
      if (rr < B) out[(size_t)rr * D + n] = r[(size_t)rr * D + n] + b2[n] + acc[rr];
  }
}

}  // namespace

// The wrappers (kernels/int4_matmul.py, kernels/fused_layer.py) check
// shapes, types, out-major contiguity, 16-byte alignment, the row counts
// (B8: 1-8; B9, B10: 1-16), that every packed half is a whole number of
// 256-row groups, and that each launch's shared memory fits the 227 KB a
// block may opt in to. h_buf is (B, I) bf16 scratch, r_buf (B, D) f32. Each
// function returns the first CUDA error of its launches (0 on success).
extern "C" {

int matmul_int4_launch(const void* x, int x_bf16, const int8_t* wp_t, const float* slo_t,
                       const float* shi_t, float* out, int B, int K2, int N, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)B * 2 * K2 * sizeof(__nv_bfloat16);
  cudaError_t err = cudaSuccess;
  if (x_bf16)
    DISPATCH_ROWS(B, err = launch<matmul_int4_kernel<__nv_bfloat16, NB>>(
                         blocks_for(N), smem, st, (const __nv_bfloat16*)x, wp_t, slo_t, shi_t,
                         out, B, K2, N));
  else
    DISPATCH_ROWS(B, err = launch<matmul_int4_kernel<float, NB>>(
                         blocks_for(N), smem, st, (const float*)x, wp_t, slo_t, shi_t, out, B,
                         K2, N));
  return (int)err;
}

int ln_qkv_int4_launch(const void* x, int x_bf16, const float* g, const float* b,
                       const int8_t* wp_t, const float* slo_t, const float* shi_t,
                       const float* bias, float* out, int B, int D, int N, float eps,
                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = ((size_t)B * D + WARPS) * sizeof(float);
  cudaError_t err = cudaSuccess;
  if (x_bf16)
    DISPATCH_ROWS(B, err = launch<ln_qkv_int4_kernel<__nv_bfloat16, NB>>(
                         blocks_for(N), smem, st, (const __nv_bfloat16*)x, g, b, wp_t, slo_t,
                         shi_t, bias, out, B, D, N, eps));
  else
    DISPATCH_ROWS(B, err = launch<ln_qkv_int4_kernel<float, NB>>(
                         blocks_for(N), smem, st, (const float*)x, g, b, wp_t, slo_t, shi_t,
                         bias, out, B, D, N, eps));
  return (int)err;
}

int attnout_ln_mlp_int4_launch(const void* a, const void* xres, int in_bf16,
                               const int8_t* wo_t, const float* so_lo, const float* so_hi,
                               const float* bo, const float* g2, const float* be2,
                               const int8_t* w1c_t, const float* s1_lo, const float* s1_hi,
                               const float* b1, const int8_t* w2_t, const float* s2_lo,
                               const float* s2_hi, const float* b2, float* r_buf,
                               __nv_bfloat16* h_buf, float* out, int B, int D, int I, float eps,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem_a = (size_t)B * D * sizeof(float);
  cudaError_t err = cudaSuccess;
  if (in_bf16)
    DISPATCH_ROWS(B, err = launch<attn_out_int4_kernel<__nv_bfloat16, NB>>(
                         blocks_for(D), smem_a, st, (const __nv_bfloat16*)a,
                         (const __nv_bfloat16*)xres, wo_t, so_lo, so_hi, bo, r_buf, B, D));
  else
    DISPATCH_ROWS(B, err = launch<attn_out_int4_kernel<float, NB>>(
                         blocks_for(D), smem_a, st, (const float*)a, (const float*)xres, wo_t,
                         so_lo, so_hi, bo, r_buf, B, D));
  if (err != cudaSuccess) return (int)err;
  const size_t smem_ln = ((size_t)B * D + WARPS) * sizeof(float);
  DISPATCH_ROWS(B, err = launch<ln_fc_in_int4_kernel<NB>>(
                       blocks_for(I / 2), smem_ln, st, (const float*)r_buf, g2, be2, w1c_t,
                       s1_lo, s1_hi, b1, h_buf, B, D, I, eps));
  if (err != cudaSuccess) return (int)err;
  const size_t smem_h = (size_t)B * I * sizeof(__nv_bfloat16);
  DISPATCH_ROWS(B, err = launch<down_int4_kernel<NB>>(
                       blocks_for(D), smem_h, st, (const __nv_bfloat16*)h_buf,
                       (const float*)r_buf, w2_t, s2_lo, s2_hi, b2, out, B, D, I));
  return (int)err;
}

}  // extern "C"
