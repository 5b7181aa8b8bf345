// Fused GPT-2 decode-layer kernels with int8 weights, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of chatterbox_tpu/ops/fused_layer.py:
//   B1  ln_qkv_int8          (_ln_qkv_kernel_i8):
//         out = (bf16(LN1(x)) @ Wqkv_int8) * s + bias
//   B2  attnout_ln_mlp_int8  (_attnout_ln_mlp_kernel_i8):
//         r   = x + (bf16(a) @ Wo_int8) * so + bo
//         out = r + b2 + (bf16(gelu_new((bf16(LN2(r)) @ W1_int8) * s1 + b1))
//                         @ W2_int8) * s2
// Each decode step of the Turbo T3 runs both once per layer (24 layers).
//
// What bounds them: at batch 1-2 they are matrix-vector products that read
// every weight byte once and do 2 operations per byte, so the int8 weight
// bytes over the memory rate bound them. At Turbo widths (D=1024, I=4096)
// B1 reads 3.15 MB and B2 9.44 MB; on an H100 SXM (3.35 TB/s) that is
// 0.94 us and 2.82 us.
//
// Design (simple and right first; no TMA / wgmma / split-K yet):
//   * Weights are stored OUT-MAJOR, (N, K) with K contiguous: the converter
//     transposes the JAX (K, N) layout once. One warp owns one output
//     column and streams its K int8 weights with 16-byte loads: a warp reads
//     512 contiguous bytes per iteration, and every warp of the grid is
//     resident at once, so all weight loads are in flight together.
//   * The TPU kernel computes LN once at grid step (0,0) and keeps it in
//     VMEM scratch, relying on the sequential grid. Blocks on Hopper run in
//     no order, so every block recomputes the LayerNorm of its 1-2 input
//     rows into shared memory (2x1024 floats, negligible next to the
//     weights it streams).
//   * B2's phases depend on each other across the whole width (attn-out and
//     LN2 before the MLP; the MLP's hidden units before fc_out), so it is
//     three launches on one stream: attn-out+residual, LN2+fc_in+gelu, and
//     fc_out+residual, with r and h in small global scratch buffers.
// Numerics mirror the Pallas kernels: LN in f32, the vector rounded to bf16
// before each product, int8 -> float exact, f32 accumulation, scale and bias
// applied after the full K sum. The Pallas B2 applies s2 to each 1024-wide
// tile's partial sum; here s2 multiplies the full sum once (equal up to f32
// rounding).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_B = 2;
constexpr int K_STEP = 32 * 16;  // bytes a warp reads per iteration

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the block; every thread gets the result. red: WARPS floats.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < WARPS ? red[lane] : 0.f;
  return warp_sum(t);
}

// ys[r, :] = bf16(LayerNorm(x[r, :]) * g + b) for the B rows, in shared
// memory: mean, then the mean of squared deviations (two passes, f32).
template <typename T>
__device__ void layer_norm_bf16(const T* __restrict__ x, const float* __restrict__ g,
                                const float* __restrict__ b, int B, int D, float eps,
                                float* ys, float* red) {
  for (int r = 0; r < B; ++r) {
    const T* xr = x + (size_t)r * D;
    float* yr = ys + (size_t)r * D;
    float s = 0.f;
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      const float v = to_f32(xr[i]);
      yr[i] = v;
      s += v;
    }
    const float mu = block_sum(s, red) / D;
    float q = 0.f;
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      const float d = yr[i] - mu;
      q += d * d;
    }
    const float var = block_sum(q, red) / D;
    const float rs = rsqrtf(var + eps);
    for (int i = threadIdx.x; i < D; i += blockDim.x)
      yr[i] = round_bf16((yr[i] - mu) * rs * g[i] + b[i]);
  }
  __syncthreads();
}

// acc[r] = sum_k xs[r*K + k] * w[k] for one out-major weight row, summed
// over the warp (every lane holds the totals). K % K_STEP == 0.
__device__ __forceinline__ void warp_dot_i8(const int8_t* __restrict__ w, const float* xs,
                                            int K, int B, float acc[MAX_B]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < MAX_B; ++r) acc[r] = 0.f;
#pragma unroll 4
  for (int k0 = lane * 16; k0 < K; k0 += K_STEP) {
    const int4 pk = __ldg(reinterpret_cast<const int4*>(w + k0));
    const int8_t* w8 = reinterpret_cast<const int8_t*>(&pk);
#pragma unroll
    for (int r = 0; r < MAX_B; ++r) {
      if (r < B) {
        const float4* x4 = reinterpret_cast<const float4*>(xs + (size_t)r * K + k0);
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 xv = x4[q];
          s += xv.x * (float)w8[4 * q] + xv.y * (float)w8[4 * q + 1]
             + xv.z * (float)w8[4 * q + 2] + xv.w * (float)w8[4 * q + 3];
        }
        acc[r] += s;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < MAX_B; ++r) acc[r] = warp_sum(acc[r]);
}

__device__ __forceinline__ float gelu_new(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2/pi)
  return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
}

// B1: grid = ceil(N / WARPS); block = WARPS warps, one output column each.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ln_qkv_kernel(const T* __restrict__ x, const float* __restrict__ g,
              const float* __restrict__ b, const int8_t* __restrict__ w_t,
              const float* __restrict__ s, const float* __restrict__ bias,
              float* __restrict__ out, int B, int D, int N, float eps) {
  extern __shared__ float4 smem4[];
  float* ys = reinterpret_cast<float*>(smem4);
  float* red = ys + (size_t)B * D;
  layer_norm_bf16(x, g, b, B, D, eps, ys, red);
  const int n = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (n >= N) return;
  float acc[MAX_B];
  warp_dot_i8(w_t + (size_t)n * D, ys, D, B, acc);
  if ((threadIdx.x & 31) == 0)
    for (int r = 0; r < B; ++r) out[(size_t)r * N + n] = acc[r] * s[n] + bias[n];
}

// B2 phase 1: r = xres + (bf16(a) @ Wo) * so + bo; grid = ceil(D / WARPS).
template <typename T>
__global__ void __launch_bounds__(THREADS)
attn_out_kernel(const T* __restrict__ a, const T* __restrict__ xres,
                const int8_t* __restrict__ wo_t, const float* __restrict__ so,
                const float* __restrict__ bo, float* __restrict__ r_out, int B, int D) {
  extern __shared__ float4 smem4[];
  float* as = reinterpret_cast<float*>(smem4);
  for (int i = threadIdx.x; i < B * D; i += blockDim.x) as[i] = round_bf16(to_f32(a[i]));
  __syncthreads();
  const int n = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (n >= D) return;
  float acc[MAX_B];
  warp_dot_i8(wo_t + (size_t)n * D, as, D, B, acc);
  if ((threadIdx.x & 31) == 0)
    for (int r = 0; r < B; ++r)
      r_out[(size_t)r * D + n] = to_f32(xres[(size_t)r * D + n]) + acc[r] * so[n] + bo[n];
}

// B2 phase 2: h = bf16(gelu_new((bf16(LN2(r)) @ W1) * s1 + b1));
// grid = ceil(I / WARPS), one hidden unit per warp.
__global__ void __launch_bounds__(THREADS)
ln_fc_in_kernel(const float* __restrict__ r, const float* __restrict__ g2,
                const float* __restrict__ be2, const int8_t* __restrict__ w1_t,
                const float* __restrict__ s1, const float* __restrict__ b1,
                float* __restrict__ h, int B, int D, int I, float eps) {
  extern __shared__ float4 smem4[];
  float* ys = reinterpret_cast<float*>(smem4);
  float* red = ys + (size_t)B * D;
  layer_norm_bf16(r, g2, be2, B, D, eps, ys, red);
  const int j = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (j >= I) return;
  float acc[MAX_B];
  warp_dot_i8(w1_t + (size_t)j * D, ys, D, B, acc);
  if ((threadIdx.x & 31) == 0)
    for (int rr = 0; rr < B; ++rr)
      h[(size_t)rr * I + j] = round_bf16(gelu_new(acc[rr] * s1[j] + b1[j]));
}

// B2 phase 3: out = (r + b2) + (h @ W2) * s2; grid = ceil(D / WARPS).
__global__ void __launch_bounds__(THREADS)
fc_out_kernel(const float* __restrict__ h, const float* __restrict__ r,
              const int8_t* __restrict__ w2_t, const float* __restrict__ s2,
              const float* __restrict__ b2, float* __restrict__ out, int B, int D, int I) {
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);
  for (int i = threadIdx.x; i < B * I; i += blockDim.x) hs[i] = h[i];
  __syncthreads();
  const int n = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (n >= D) return;
  float acc[MAX_B];
  warp_dot_i8(w2_t + (size_t)n * I, hs, I, B, acc);
  if ((threadIdx.x & 31) == 0)
    for (int rr = 0; rr < B; ++rr)
      out[(size_t)rr * D + n] = (r[(size_t)rr * D + n] + b2[n]) + acc[rr] * s2[n];
}

inline unsigned blocks_for(int n) { return (unsigned)((n + WARPS - 1) / WARPS); }

}  // namespace

// The wrapper (kernels/fused_layer.py) checks shapes, types, 16-byte
// alignment, B <= MAX_B, K % K_STEP == 0 and that each launch's shared
// memory fits the 48 KB a block may take without an opt-in. Each function
// returns cudaGetLastError() after its launches.
extern "C" {

int ln_qkv_int8_launch(const void* x, int x_bf16, const float* g, const float* b,
                       const int8_t* w_t, const float* s, const float* bias, float* out,
                       int B, int D, int N, float eps, void* stream) {
  const size_t smem = ((size_t)B * D + WARPS) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  if (x_bf16)
    ln_qkv_kernel<__nv_bfloat16><<<blocks_for(N), THREADS, smem, st>>>(
        (const __nv_bfloat16*)x, g, b, w_t, s, bias, out, B, D, N, eps);
  else
    ln_qkv_kernel<float><<<blocks_for(N), THREADS, smem, st>>>(
        (const float*)x, g, b, w_t, s, bias, out, B, D, N, eps);
  return (int)cudaGetLastError();
}

int attnout_ln_mlp_int8_launch(const void* a, const void* xres, int in_bf16,
                               const int8_t* wo_t, const float* so, const float* bo,
                               const float* g2, const float* be2,
                               const int8_t* w1_t, const float* s1, const float* b1,
                               const int8_t* w2_t, const float* s2, const float* b2,
                               float* r_buf, float* h_buf, float* out,
                               int B, int D, int I, float eps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem_a = (size_t)B * D * sizeof(float);
  if (in_bf16)
    attn_out_kernel<__nv_bfloat16><<<blocks_for(D), THREADS, smem_a, st>>>(
        (const __nv_bfloat16*)a, (const __nv_bfloat16*)xres, wo_t, so, bo, r_buf, B, D);
  else
    attn_out_kernel<float><<<blocks_for(D), THREADS, smem_a, st>>>(
        (const float*)a, (const float*)xres, wo_t, so, bo, r_buf, B, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem_ln = ((size_t)B * D + WARPS) * sizeof(float);
  ln_fc_in_kernel<<<blocks_for(I), THREADS, smem_ln, st>>>(r_buf, g2, be2, w1_t, s1, b1,
                                                           h_buf, B, D, I, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem_h = (size_t)B * I * sizeof(float);
  fc_out_kernel<<<blocks_for(D), THREADS, smem_h, st>>>(h_buf, r_buf, w2_t, s2, b2, out,
                                                        B, D, I);
  return (int)cudaGetLastError();
}

}  // extern "C"
