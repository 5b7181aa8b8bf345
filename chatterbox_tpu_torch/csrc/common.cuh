// Helpers shared by the kernels (fused_layer.cu, int4.cu,
// decode_attention.cu): block shape, the warp reduction, the tensor-core
// kernels' norm prologue (norm_rows_bf16), gelu_new, the bulk copy
// (cp.async.bulk) onto an mbarrier, the cluster barrier and stores into a
// peer's shared memory, programmatic dependent launch, the bf16 tensor-core
// MMA and its operand conversions, rows staged as bf16, and the launches
// with the 227 KB opt-in (plain, or with a cluster and dependent launch).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int SMEM_MAX = 227 * 1024;      // dynamic shared memory a block may opt in to

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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

// The cluster barrier in two halves (all threads of every block take part).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// v into the shared memory of block `rank` of the cluster, at the offset
// of p in this block's own shared memory
__device__ __forceinline__ void st_cluster(float* p, uint32_t rank, float v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote), "f"(v) : "memory");
}

// Programmatic dependent launch: wait until the kernel before this one on
// the stream has finished and its writes are visible (a no-op when the
// launch did not ask for it), and let the next kernel begin launching.
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) @ b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four int8 in w -> bf16 pairs (bytes 0, 1) and (bytes 2, 3), the lower
// index in the lower half
__device__ __forceinline__ void i8x4_to_bf16x2(uint32_t w, uint32_t& p01, uint32_t& p23) {
  const auto byte = [w](int i) {
    return (float)(static_cast<int32_t>(w << (24 - 8 * i)) >> 24);
  };
  __nv_bfloat162 a = __floats2bfloat162_rn(byte(0), byte(1));
  __nv_bfloat162 b = __floats2bfloat162_rn(byte(2), byte(3));
  p01 = *reinterpret_cast<uint32_t*>(&a);
  p23 = *reinterpret_cast<uint32_t*>(&b);
}

// 8 consecutive entries (16-byte aligned) as float
__device__ __forceinline__ void to_f32x8(const uint4& u, float v[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const __nv_bfloat16* x, float v[8]) {
  to_f32x8(*reinterpret_cast<const uint4*>(x), v);
}

__device__ __forceinline__ void load8(const float* x, float v[8]) {
  const float4* p = reinterpret_cast<const float4*>(x);
  const float4 a = p[0], b = p[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// 8 entries (16 bytes) of x as bf16, 16-byte aligned: bf16 copied as it
// is, f32 rounded to nearest
__device__ __forceinline__ uint4 bf16x8(const __nv_bfloat16* x) {
  return __ldg(reinterpret_cast<const uint4*>(x));
}

__device__ __forceinline__ uint4 bf16x8(const float* x) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(x));
  const float4 b = __ldg(reinterpret_cast<const float4*>(x) + 1);
  __nv_bfloat162 p[4] = {__floats2bfloat162_rn(a.x, a.y), __floats2bfloat162_rn(a.z, a.w),
                         __floats2bfloat162_rn(b.x, b.y), __floats2bfloat162_rn(b.z, b.w)};
  return *reinterpret_cast<uint4*>(p);
}

// ys[r * yld + i] = bf16(x[r * ldx + i]) for i < n (a multiple of 8) and
// r < NB, rows r >= B zero; every thread of the block takes part, 16 bytes
// of ys at a time. x, ys and the strides 16-byte aligned.
template <typename T>
__device__ __forceinline__ void stage_rows_bf16(const T* __restrict__ x, int ldx, int B,
                                                int NB, int n, __nv_bfloat16* ys, int yld) {
  const int per_row = n / 8;
  for (int i = threadIdx.x; i < NB * per_row; i += blockDim.x) {
    const int r = i / per_row, c = 8 * (i - r * per_row);
    const uint4 v = r < B ? bf16x8(x + (size_t)r * ldx + c) : make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(ys + (size_t)r * yld + c) = v;
  }
}

// ys[r * yld + i] = bf16(norm(x[r * D + i])) for r < NB, rows B..NB-1
// zero, in f32 as the Pallas kernels compute it (the rounding to bf16 is
// theirs, before the product):
//   LayerNorm (RMS = false): mean, then the mean of squared deviations;
//                            (x - mu) * rsqrt(var + eps) * g + b
//   RMSNorm   (RMS = true):  x * rsqrt(mean(x^2) + eps) * g   (b unused)
// One warp a row (rows w, w + WARPS), shuffle reductions only; lane i
// takes entries 8i + 256j, so D % 256 == 0. A bf16 x row is read from
// device memory once, into its row of ys, and normalised there in place;
// f32 x is reread from device memory in each pass. g and b (shared or
// device memory, read 16 bytes at a time: scalar loads conflict 8 ways) are
// read only after gb_bar, where given, has completed its first phase. The
// caller synchronises the block before it reads ys.
template <typename T, bool RMS>
__device__ __forceinline__ void norm_rows_bf16(const T* __restrict__ x, const float* g,
                                               const float* b, uint64_t* gb_bar, int B, int NB,
                                               int D, float eps, __nv_bfloat16* ys, int yld) {
  constexpr bool STAGE = sizeof(T) == 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < NB; r += WARPS) {
    __nv_bfloat16* yr = ys + r * yld;
    if (r >= B) {
      for (int i = lane * 8; i < D; i += 256)
        *reinterpret_cast<uint4*>(yr + i) = make_uint4(0, 0, 0, 0);
      continue;
    }
    const T* xg = x + (size_t)r * D;
    const T* xr = STAGE ? reinterpret_cast<const T*>(yr) : xg;   // the later passes' rows
    float v[8], acc = 0.f;
#pragma unroll 4
    for (int i = lane * 8; i < D; i += 256) {
      if constexpr (STAGE) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(xg + i));
        *reinterpret_cast<uint4*>(yr + i) = u;
        to_f32x8(u, v);
      } else {
        load8(xg + i, v);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) acc += RMS ? v[j] * v[j] : v[j];
    }
    float mu = 0.f, rs;
    if (RMS) {
      rs = rsqrtf(warp_sum(acc) / D + eps);
    } else {
      mu = warp_sum(acc) / D;
      float q = 0.f;
#pragma unroll 4
      for (int i = lane * 8; i < D; i += 256) {
        load8(xr + i, v);
#pragma unroll
        for (int j = 0; j < 8; ++j) q += (v[j] - mu) * (v[j] - mu);
      }
      rs = rsqrtf(warp_sum(q) / D + eps);
    }
    if (gb_bar) mbar_wait(gb_bar, 0);
#pragma unroll 4
    for (int i = lane * 8; i < D; i += 256) {
      load8(xr + i, v);            // in place when staged: each lane its own 8 entries
      float gv[8], bv[8];
      load8(g + i, gv);
      if (!RMS) load8(b + i, bv);
      float y[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        y[j] = RMS ? __fmul_rn(__fmul_rn(v[j], rs), gv[j])
                   : __fadd_rn(__fmul_rn(__fmul_rn(v[j] - mu, rs), gv[j]), bv[j]);
      uint32_t packed[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        __nv_bfloat162 p = __floats2bfloat162_rn(y[2 * j], y[2 * j + 1]);
        packed[j] = *reinterpret_cast<uint32_t*>(&p);
      }
      *reinterpret_cast<uint4*>(yr + i) = make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }
  }
}

// Kernel<<<grid, THREADS, smem, st>>>(args...) through cudaLaunchKernelEx:
// consecutive blocks in clusters of `cluster` (1: no cluster), and with
// `pdl` the launch may begin while the previous kernel on the stream runs
// (programmatic dependent launch; the kernel calls griddep_wait before it
// reads what that kernel wrote). The kernel may first take up to SMEM_MAX
// of dynamic shared memory: the attribute belongs to the current device, so
// it is set once per kernel and device, on the kernel's first launch there
// (devices past MAX_DEVICES set it on every launch).
constexpr int MAX_DEVICES = 64;

template <auto Kernel, typename... Args>
cudaError_t launch_ex(unsigned grid, size_t smem, unsigned cluster, bool pdl, cudaStream_t st,
                      Args... args) {
  static bool opted_in[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES || !opted_in[dev]) {
    err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) opted_in[dev] = true;
  }
  cudaLaunchAttribute attr[2];
  unsigned n = 0;
  if (cluster > 1) {
    attr[n].id = cudaLaunchAttributeClusterDimension;
    attr[n].val.clusterDim.x = cluster;
    attr[n].val.clusterDim.y = 1;
    attr[n].val.clusterDim.z = 1;
    ++n;
  }
  if (pdl) {
    attr[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[n].val.programmaticStreamSerializationAllowed = 1;
    ++n;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = n;
  err = cudaLaunchKernelEx(&cfg, Kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The same with no cluster and no dependent launch.
template <auto Kernel, typename... Args>
cudaError_t launch(unsigned grid, size_t smem, cudaStream_t st, Args... args) {
  return launch_ex<Kernel>(grid, smem, 1, false, st, args...);
}

}  // namespace
