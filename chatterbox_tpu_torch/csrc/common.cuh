// Helpers shared by the kernels (fused_layer.cu, int4.cu,
// decode_attention.cu): block shape, reductions, the norm prologue, 16-wide
// dot products over shared-memory rows, gelu_new, the launch with the 227 KB
// opt-in, and the bulk copy (cp.async.bulk) onto an mbarrier.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int K_STEP = 32 * 16;           // bytes a warp reads per iteration
constexpr int SMEM_MAX = 227 * 1024;      // dynamic shared memory a block may opt in to

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
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

// ys[r, :] = bf16(norm(x[r, :])) for the B rows, in shared memory, in f32:
//   LayerNorm (RMS = false): mean, then the mean of squared deviations;
//                            (x - mu) * rsqrt(var + eps) * g + b
//   RMSNorm   (RMS = true):  x * rsqrt(mean(x^2) + eps) * g   (b unused)
template <typename T, bool RMS>
__device__ void norm_bf16(const T* __restrict__ x, const float* __restrict__ g,
                          const float* __restrict__ b, int B, int D, float eps,
                          float* ys, float* red) {
  for (int r = 0; r < B; ++r) {
    const T* xr = x + (size_t)r * D;
    float* yr = ys + (size_t)r * D;
    float s = 0.f;
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      const float v = to_f32(xr[i]);
      yr[i] = v;
      s += RMS ? v * v : v;
    }
    if (RMS) {
      const float rs = rsqrtf(block_sum(s, red) / D + eps);
      for (int i = threadIdx.x; i < D; i += blockDim.x)
        yr[i] = round_bf16(yr[i] * rs * g[i]);
    } else {
      const float mu = block_sum(s, red) / D;
      float q = 0.f;
      for (int i = threadIdx.x; i < D; i += blockDim.x) {
        const float d = yr[i] - mu;
        q += d * d;
      }
      const float rs = rsqrtf(block_sum(q, red) / D + eps);
      for (int i = threadIdx.x; i < D; i += blockDim.x)
        yr[i] = round_bf16((yr[i] - mu) * rs * g[i] + b[i]);
    }
  }
  __syncthreads();
}

// sum_j x[j] * w[j] over 16 consecutive entries of one row of xs (f32 or
// bf16 in shared memory) and the 16 weights already converted to float.
__device__ __forceinline__ float dot16(const float* x, const float w[16]) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 xv = x4[q];
    s += xv.x * w[4 * q] + xv.y * w[4 * q + 1] + xv.z * w[4 * q + 2] + xv.w * w[4 * q + 3];
  }
  return s;
}

__device__ __forceinline__ float dot16(const __nv_bfloat16* x, const float w[16]) {
  const uint4* x4 = reinterpret_cast<const uint4*>(x);
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const uint4 u = x4[q];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      s += f.x * w[8 * q + 2 * j] + f.y * w[8 * q + 2 * j + 1];
    }
  }
  return s;
}

__device__ __forceinline__ float gelu_new(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2/pi)
  return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// after mbar_init, before any thread waits on or copies to the barriers
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, counted on bar (the caller first declares them with
// mbar_expect_tx)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

inline unsigned blocks_for(int n) { return (unsigned)((n + WARPS - 1) / WARPS); }

// Launch Kernel<<<grid, THREADS, smem, st>>>(args...), first letting it
// take up to SMEM_MAX of dynamic shared memory. The attribute belongs to the
// current device, so it is set once per kernel and device, on the kernel's
// first launch there (devices past MAX_DEVICES set it on every launch).
constexpr int MAX_DEVICES = 64;

template <auto Kernel, typename... Args>
cudaError_t launch(unsigned grid, size_t smem, cudaStream_t st, Args... args) {
  static bool opted_in[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES || !opted_in[dev]) {
    err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) opted_in[dev] = true;
  }
  Kernel<<<grid, THREADS, smem, st>>>(args...);
  return cudaGetLastError();
}

// The smallest row instance that holds B rows (the wrappers check B <= 16).
#define DISPATCH_ROWS(B, ...)                      \
  do {                                             \
    if ((B) <= 2) { constexpr int NB = 2; __VA_ARGS__; }       \
    else if ((B) <= 4) { constexpr int NB = 4; __VA_ARGS__; }  \
    else if ((B) <= 8) { constexpr int NB = 8; __VA_ARGS__; }  \
    else { constexpr int NB = 16; __VA_ARGS__; }               \
  } while (0)

}  // namespace
