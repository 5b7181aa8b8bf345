// Fused decode-layer kernels with int8 weights, for Hopper (sm_90a).
//
// Replaces the four int8 Pallas TPU kernels of chatterbox_tpu/ops/fused_layer.py
// and the one of chatterbox_tpu/ops/pallas_mlp.py:
//   GPT-2 (Turbo T3, 24 layers):
//   B1  ln_qkv_int8          (_ln_qkv_kernel_i8):
//         out = (bf16(LN1(x)) @ Wqkv_int8) * s + bias
//   B2  attnout_ln_mlp_int8  (_attnout_ln_mlp_kernel_i8):
//         r   = x + (bf16(a) @ Wo_int8) * so + bo
//         out = r + b2 + (bf16(gelu_new((bf16(LN2(r)) @ W1_int8) * s1 + b1))
//                         @ W2_int8) * s2
//   llama (520M CFG T3, 30 layers, batch 2 = cond and uncond rows):
//   B5  rms_qkv_int8         (_rms_qkv_kernel_i8):
//         out = (bf16(RMSNorm(x) * g) @ [Wq|Wk|Wv]_int8) * s
//   B6  attnout_rms_glu_int8 (_attnout_rms_glu_kernel_i8):
//         r   = x + (bf16(a) @ Wo_int8) * so;   y = bf16(RMSNorm(r) * g2)
//         h   = bf16(silu((y @ Wg_int8) * sg) * ((y @ Wu_int8) * su))
//         out = r + sum over hidden tiles t of (h_t @ Wd_int8_t) * sd
//   B11 fused_mlp_int8       (pallas_mlp.py, _mlp_kernel; a library kernel
//       that nothing in the JAX package calls outside its own test):
//         out = x + (bf16(gelu_new((bf16(LN(x)) @ W1_int8) * s1 + b1)) @ W2_int8) * s2 + b2
//       in x's type: B2's second and third phases, with r = x.
// Each decode step runs one pair once per layer, over 1-16 rows (one
// request, a CFG pair, or the batched engine's rows). B11 takes 1-16 rows.
//
// What bounds them: at 1-16 rows they are matrix-vector products that read
// every weight byte once and do 2 operations per byte and row, so the int8
// weight bytes over the memory rate bound them. At D=1024, I=4096 B1 and B5
// read 3.15 MB (0.94 us at the H100 SXM's 3.35 TB/s), B2 9.44 MB (2.82 us)
// and B6 13.6 MB (4.07 us), B11 8.4 MB (2.5 us).
//
// Design (simple and right first; no TMA / wgmma / split-K yet):
//   * Weights are stored OUT-MAJOR, (N, K) with K contiguous: the converter
//     transposes the JAX (K, N) layout once. One warp owns one output
//     column and streams its K int8 weights with 16-byte loads: a warp reads
//     512 contiguous bytes per iteration, and every warp of the grid is
//     resident at once, so all weight loads are in flight together.
//   * Every kernel is a template on NB, the rows it unrolls (2, 4, 8, 16);
//     a call of B rows runs the smallest instance with NB >= B, and rows
//     past B are skipped inside the loop, so each weight byte is read once
//     per call whatever B is.
//   * The TPU kernels compute the norm once at grid step 0 and keep it in
//     VMEM scratch, relying on the sequential grid. Blocks on Hopper run in
//     no order, so every block recomputes the LayerNorm / RMSNorm of its
//     input rows into shared memory (up to 16 x 1024 floats, 64 KB, above
//     the 48 KB default: each kernel opts in to Hopper's 227 KB once). One
//     template serves both norms.
//   * Each second half (B2, B6) has two dependencies across the whole width
//     (attn-out and the norm before the MLP; all hidden units before the
//     down projection), so each is three launches on one stream: attn-out +
//     residual, norm + up-projection(s) + activation, down-projection +
//     residual, with r (f32) and h (bf16: its values are bf16-rounded, so
//     16 rows of 4096 fit shared memory) in small global scratch buffers.
// Numerics mirror the Pallas kernels: norms in f32, the vector rounded to
// bf16 before each product, int8 -> float exact, f32 accumulation, scale
// (and bias) applied after the K sum. B6 applies sd to each tw-wide hidden
// tile's partial sum and accumulates the tiles in order onto r, as the
// Pallas grid does; B2 runs its fc_out as one tile (s2 on the full sum,
// equal to the Pallas per-tile form up to f32 rounding).

#include "common.cuh"

namespace {

// acc[r] = sum_k xs[r*ldx + k] * w[k], k < K, r < B, for one out-major
// weight row, summed over the warp (every lane holds the totals). The row
// loop is unrolled to NB >= B so acc stays in registers; K % K_STEP == 0.
// The 2-row instance over f32 rows converts each weight where a row uses
// it (measured ~6 % faster at one row than converting the 16 weights
// first); with more rows each weight is converted once.
template <int NB, typename XT>
__device__ __forceinline__ void warp_dot_i8(const int8_t* __restrict__ w, const XT* xs,
                                            int K, int ldx, int B, float acc[NB]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < NB; ++r) acc[r] = 0.f;
#pragma unroll 4
  for (int k0 = lane * 16; k0 < K; k0 += K_STEP) {
    const int4 pk = __ldg(reinterpret_cast<const int4*>(w + k0));
    const int8_t* w8 = reinterpret_cast<const int8_t*>(&pk);
    if constexpr (NB <= 2 && sizeof(XT) == sizeof(float)) {
#pragma unroll
      for (int r = 0; r < NB; ++r) {
        if (r < B) {
          const float4* x4 = reinterpret_cast<const float4*>(xs + (size_t)r * ldx + k0);
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
    } else {
      float wf[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) wf[j] = (float)w8[j];
#pragma unroll
      for (int r = 0; r < NB; ++r)
        if (r < B) acc[r] += dot16(xs + (size_t)r * ldx + k0, wf);
    }
  }
#pragma unroll
  for (int r = 0; r < NB; ++r) acc[r] = warp_sum(acc[r]);
}

__device__ __forceinline__ float silu(float x) { return x * (1.0f / (1.0f + expf(-x))); }

// B1 / B5: out = (bf16(norm(x)) @ W) * s (+ bias for the LayerNorm form);
// grid = ceil(N / WARPS); block = WARPS warps, one output column each.
template <typename T, bool RMS, int NB>
__global__ void __launch_bounds__(THREADS)
norm_qkv_kernel(const T* __restrict__ x, const float* __restrict__ g,
                const float* __restrict__ b, const int8_t* __restrict__ w_t,
                const float* __restrict__ s, const float* __restrict__ bias,
                float* __restrict__ out, int B, int D, int N, float eps) {
  extern __shared__ float4 smem4[];
  float* ys = reinterpret_cast<float*>(smem4);
  float* red = ys + (size_t)B * D;
  norm_bf16<T, RMS>(x, g, b, B, D, eps, ys, red);
  const int n = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (n >= N) return;
  float acc[NB];
  warp_dot_i8<NB>(w_t + (size_t)n * D, ys, D, D, B, acc);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int r = 0; r < NB; ++r)
      if (r < B) {
        float o = acc[r] * s[n];
        if (!RMS) o += bias[n];
        out[(size_t)r * N + n] = o;
      }
  }
}

// B2 / B6 phase 1: r = xres + (bf16(a) @ Wo) * so (+ bo when given);
// grid = ceil(D / WARPS).
template <typename T, int NB>
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
  float acc[NB];
  warp_dot_i8<NB>(wo_t + (size_t)n * D, as, D, D, B, acc);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int r = 0; r < NB; ++r)
      if (r < B) {
        float v = to_f32(xres[(size_t)r * D + n]) + acc[r] * so[n];
        if (bo) v += bo[n];
        r_out[(size_t)r * D + n] = v;
      }
  }
}

// B2 / B11 phase 2: h = bf16(gelu_new((bf16(LN2(r)) @ W1) * s1 + b1));
// grid = ceil(I / WARPS), one hidden unit per warp.
template <typename T, int NB>
__global__ void __launch_bounds__(THREADS)
ln_fc_in_kernel(const T* __restrict__ r, const float* __restrict__ g2,
                const float* __restrict__ be2, const int8_t* __restrict__ w1_t,
                const float* __restrict__ s1, const float* __restrict__ b1,
                __nv_bfloat16* __restrict__ h, int B, int D, int I, float eps) {
  extern __shared__ float4 smem4[];
  float* ys = reinterpret_cast<float*>(smem4);
  float* red = ys + (size_t)B * D;
  norm_bf16<T, false>(r, g2, be2, B, D, eps, ys, red);
  const int j = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (j >= I) return;
  float acc[NB];
  warp_dot_i8<NB>(w1_t + (size_t)j * D, ys, D, D, B, acc);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int rr = 0; rr < NB; ++rr)
      if (rr < B) h[(size_t)rr * I + j] = __float2bfloat16(gelu_new(acc[rr] * s1[j] + b1[j]));
  }
}

// B6 phase 2: y = bf16(RMSNorm(r) * g2);
// h = bf16(silu((y @ Wg) * sg) * ((y @ Wu) * su)); grid = ceil(I / WARPS),
// one hidden unit (its gate and up rows) per warp.
template <int NB>
__global__ void __launch_bounds__(THREADS)
rms_glu_kernel(const float* __restrict__ r, const float* __restrict__ g2,
               const int8_t* __restrict__ wg_t, const float* __restrict__ sg,
               const int8_t* __restrict__ wu_t, const float* __restrict__ su,
               __nv_bfloat16* __restrict__ h, int B, int D, int I, float eps) {
  extern __shared__ float4 smem4[];
  float* ys = reinterpret_cast<float*>(smem4);
  float* red = ys + (size_t)B * D;
  norm_bf16<float, true>(r, g2, nullptr, B, D, eps, ys, red);
  const int j = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (j >= I) return;
  float ag[NB], au[NB];
  warp_dot_i8<NB>(wg_t + (size_t)j * D, ys, D, D, B, ag);
  warp_dot_i8<NB>(wu_t + (size_t)j * D, ys, D, D, B, au);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int rr = 0; rr < NB; ++rr)
      if (rr < B)
        h[(size_t)rr * I + j] = __float2bfloat16(silu(ag[rr] * sg[j]) * (au[rr] * su[j]));
  }
}

// B2 / B6 / B11 phase 3: out = (r + b2) + sum over tw-wide tiles t of
// (h_t @ W2_t) * s2, tiles added in order (b2 may be absent); r and out of
// type T (f32 for B2 / B6, x's type for B11); grid = ceil(D / WARPS).
template <typename T, int NB>
__global__ void __launch_bounds__(THREADS)
down_kernel(const __nv_bfloat16* __restrict__ h, const T* __restrict__ r,
            const int8_t* __restrict__ w2_t, const float* __restrict__ s2,
            const float* __restrict__ b2, T* __restrict__ out, int B, int D, int I,
            int tw) {
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
  float o[NB], acc[NB];
#pragma unroll
  for (int rr = 0; rr < NB; ++rr) {
    o[rr] = rr < B ? to_f32(r[(size_t)rr * D + n]) : 0.f;
    if (b2) o[rr] += b2[n];
  }
  for (int t0 = 0; t0 < I; t0 += tw) {
    warp_dot_i8<NB>(w2_t + (size_t)n * I + t0, hs + t0, tw, I, B, acc);
#pragma unroll
    for (int rr = 0; rr < NB; ++rr) o[rr] += acc[rr] * s2[n];
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int rr = 0; rr < NB; ++rr)
      if (rr < B) store(out + (size_t)rr * D + n, o[rr]);
  }
}

template <bool RMS>
cudaError_t launch_norm_qkv(const void* x, int x_bf16, const float* g, const float* b,
                            const int8_t* w_t, const float* s, const float* bias, float* out,
                            int B, int D, int N, float eps, cudaStream_t st) {
  const size_t smem = ((size_t)B * D + WARPS) * sizeof(float);
  cudaError_t err = cudaSuccess;
  if (x_bf16)
    DISPATCH_ROWS(B, err = launch<norm_qkv_kernel<__nv_bfloat16, RMS, NB>>(blocks_for(N), smem,
                                  st, (const __nv_bfloat16*)x, g, b, w_t, s, bias, out, B, D,
                                  N, eps));
  else
    DISPATCH_ROWS(B, err = launch<norm_qkv_kernel<float, RMS, NB>>(blocks_for(N), smem, st,
                                  (const float*)x, g, b, w_t, s, bias, out, B, D, N, eps));
  return err;
}

cudaError_t launch_attn_out(const void* a, const void* xres, int in_bf16,
                            const int8_t* wo_t, const float* so, const float* bo,
                            float* r_buf, int B, int D, cudaStream_t st) {
  const size_t smem = (size_t)B * D * sizeof(float);
  cudaError_t err = cudaSuccess;
  if (in_bf16)
    DISPATCH_ROWS(B, err = launch<attn_out_kernel<__nv_bfloat16, NB>>(blocks_for(D), smem, st,
                                  (const __nv_bfloat16*)a, (const __nv_bfloat16*)xres, wo_t,
                                  so, bo, r_buf, B, D));
  else
    DISPATCH_ROWS(B, err = launch<attn_out_kernel<float, NB>>(blocks_for(D), smem, st,
                                  (const float*)a, (const float*)xres, wo_t, so, bo, r_buf,
                                  B, D));
  return err;
}

template <typename T>
cudaError_t launch_down(const __nv_bfloat16* h_buf, const T* r_buf, const int8_t* w2_t,
                        const float* s2, const float* b2, T* out, int B, int D, int I,
                        int tw, cudaStream_t st) {
  const size_t smem = (size_t)B * I * sizeof(__nv_bfloat16);
  cudaError_t err = cudaSuccess;
  DISPATCH_ROWS(B, err = launch<down_kernel<T, NB>>(blocks_for(D), smem, st, h_buf, r_buf,
                                w2_t, s2, b2, out, B, D, I, tw));
  return err;
}

// B11: phase 2 then phase 3 of B2 on x itself; eps is the Pallas kernel's
// fixed 1e-5.
template <typename T>
cudaError_t launch_fused_mlp(const T* x, const float* g, const float* b, const int8_t* w1_t,
                             const float* s1, const float* b1, const int8_t* w2_t,
                             const float* s2, const float* b2, __nv_bfloat16* h_buf, T* out,
                             int B, int D, int I, cudaStream_t st) {
  const size_t smem_ln = ((size_t)B * D + WARPS) * sizeof(float);
  cudaError_t err = cudaSuccess;
  DISPATCH_ROWS(B, err = launch<ln_fc_in_kernel<T, NB>>(blocks_for(I), smem_ln, st, x, g, b,
                                w1_t, s1, b1, h_buf, B, D, I, 1e-5f));
  if (err != cudaSuccess) return err;
  return launch_down<T>(h_buf, x, w2_t, s2, b2, out, B, D, I, I, st);
}

}  // namespace

// The wrapper (kernels/fused_layer.py) checks shapes, types, 16-byte
// alignment, 1 <= B <= 16, K % K_STEP == 0, tw % K_STEP == 0 and
// I % tw == 0, and that each launch's shared memory fits the 227 KB a block
// may opt in to. h_buf is (B, I) bf16 scratch, r_buf (B, D) f32. B11's out
// has x's type. Each
// function returns the first CUDA error of its launches (0 on success).
extern "C" {

int ln_qkv_int8_launch(const void* x, int x_bf16, const float* g, const float* b,
                       const int8_t* w_t, const float* s, const float* bias, float* out,
                       int B, int D, int N, float eps, void* stream) {
  return (int)launch_norm_qkv<false>(x, x_bf16, g, b, w_t, s, bias, out, B, D, N, eps,
                                     (cudaStream_t)stream);
}

int rms_qkv_int8_launch(const void* x, int x_bf16, const float* g, const int8_t* w_t,
                        const float* s, float* out, int B, int D, int N, float eps,
                        void* stream) {
  return (int)launch_norm_qkv<true>(x, x_bf16, g, nullptr, w_t, s, nullptr, out, B, D, N,
                                    eps, (cudaStream_t)stream);
}

int attnout_ln_mlp_int8_launch(const void* a, const void* xres, int in_bf16,
                               const int8_t* wo_t, const float* so, const float* bo,
                               const float* g2, const float* be2,
                               const int8_t* w1_t, const float* s1, const float* b1,
                               const int8_t* w2_t, const float* s2, const float* b2,
                               float* r_buf, __nv_bfloat16* h_buf, float* out,
                               int B, int D, int I, float eps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = launch_attn_out(a, xres, in_bf16, wo_t, so, bo, r_buf, B, D, st);
  if (err != cudaSuccess) return (int)err;
  const size_t smem_ln = ((size_t)B * D + WARPS) * sizeof(float);
  DISPATCH_ROWS(B, err = launch<ln_fc_in_kernel<float, NB>>(blocks_for(I), smem_ln, st, r_buf,
                                g2, be2, w1_t, s1, b1, h_buf, B, D, I, eps));
  if (err != cudaSuccess) return (int)err;
  return (int)launch_down<float>(h_buf, r_buf, w2_t, s2, b2, out, B, D, I, I, st);
}

int attnout_rms_glu_int8_launch(const void* a, const void* xres, int in_bf16,
                                const int8_t* wo_t, const float* so, const float* g2,
                                const int8_t* wg_t, const float* sg,
                                const int8_t* wu_t, const float* su,
                                const int8_t* wd_t, const float* sd,
                                float* r_buf, __nv_bfloat16* h_buf, float* out,
                                int B, int D, int I, int tw, float eps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = launch_attn_out(a, xres, in_bf16, wo_t, so, nullptr, r_buf, B, D, st);
  if (err != cudaSuccess) return (int)err;
  const size_t smem_ln = ((size_t)B * D + WARPS) * sizeof(float);
  DISPATCH_ROWS(B, err = launch<rms_glu_kernel<NB>>(blocks_for(I), smem_ln, st, r_buf, g2,
                                wg_t, sg, wu_t, su, h_buf, B, D, I, eps));
  if (err != cudaSuccess) return (int)err;
  return (int)launch_down<float>(h_buf, r_buf, wd_t, sd, nullptr, out, B, D, I, tw, st);
}

int fused_mlp_int8_launch(const void* x, int x_bf16, const float* g, const float* b,
                          const int8_t* w1_t, const float* s1, const float* b1,
                          const int8_t* w2_t, const float* s2, const float* b2,
                          __nv_bfloat16* h_buf, void* out, int B, int D, int I, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (x_bf16)
    return (int)launch_fused_mlp<__nv_bfloat16>((const __nv_bfloat16*)x, g, b, w1_t, s1, b1,
                                                 w2_t, s2, b2, h_buf, (__nv_bfloat16*)out,
                                                 B, D, I, st);
  return (int)launch_fused_mlp<float>((const float*)x, g, b, w1_t, s1, b1, w2_t, s2, b2, h_buf,
                                      (float*)out, B, D, I, st);
}

}  // extern "C"
