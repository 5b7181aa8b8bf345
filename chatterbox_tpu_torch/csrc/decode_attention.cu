// Single-query decode attention over the KV cache, for Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels of chatterbox_tpu/ops/pallas_attention.py,
// which compute one function over different caches and windows:
//   B3  decode_attention_streamed      (_flash_decode_kernel): bf16 cache,
//         keys at lo[b] <= pos <= cur_len[b] (lo defaults to 0);
//   B4  decode_attention_streamed_int8 (_flash_decode_int8_kernel): int8
//         cache with one bf16 scale per (row, head, position); K's scale
//         multiplies the score, V's the softmax weight (the running sum
//         keeps the unscaled weights);
//   B7  decode_attention               (_decode_attn_kernel): any cache
//         length, keys at pos <= cur_len[b] (this kernel with lo = 0).
// out[b, h] = sum_t softmax_t(q[b, h] . k[b, h, t] / sqrt(D)) v[b, h, t]
// over the window, scores and sums in f32, written in q's type.
//
// What bounds it: each (row, head) reads its window's K and V once,
// 2 * (cur - lo + 1) * D elements (plus two scales a position for int8),
// and does ~4 operations per element, far below the card's compute, so
// the cache bytes over the memory rate bound it. At the decode paths'
// shapes (B <= 16, 16 heads, D = 64, windows of a few hundred keys) those
// bytes are a few MB or less, under 1 us at 3.35 TB/s, so one launch's
// latency and the serial chain of each block's loop are what a call costs.
//
// Design (simple and right first):
//   * The TPU kernels walk 256-key tiles in grid order, carrying the
//     running max / sum / accumulator in VMEM scratch, and clamp the tile
//     index so tiles outside [lo, cur] are never fetched. Blocks on Hopper
//     run in no order, so one block owns one (row, head) and loops over
//     exactly its window [lo, min(cur, T - 1)]: nothing outside it is read,
//     whatever T is, so no tile clamp is needed.
//   * A key row is D * sizeof(element) bytes (128 B for bf16 at D = 64,
//     64 B for int8), read with 16-byte loads by LPK lanes; a warp covers
//     32 / LPK keys at once and issues U such loads of K and V before it
//     uses any, so several loads are in flight per warp. Each group of LPK
//     lanes keeps its own running max, sum and D-wide accumulator (EPL
//     entries per lane) over the keys it sees.
//   * At the end the groups of a warp merge by shuffles and the warps
//     through shared memory, each state rescaled by exp(m_w - m).
// Numerics: f32 scores times 1 / sqrt(D) (then times K's scale), f32 online
// softmax, weights not rounded before the value product, the denominator
// clamped at 1e-30 as the Pallas kernels do; only the order of the sums
// differs. An empty window (lo > cur) gives 0, as theirs does.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int U = 4;           // key loads a warp issues before using them

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// The 16 bytes of a cache row held by one lane, as EPL floats: 8 bf16
// values or 16 int8 codes (the overload follows EPL = 16 / sizeof(KV)).
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 x = __bfloat1622float2(h[j]);
    f[2 * j] = x.x;
    f[2 * j + 1] = x.y;
  }
}

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[16]) {
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int j = 0; j < 16; ++j) f[j] = (float)c[j];
}

// exp(m - m_new) with an empty state (m = -inf) weighing nothing
__device__ __forceinline__ float rescale(float m, float m_new) {
  return m == -INFINITY ? 0.f : expf(m - m_new);
}

template <typename KV> struct Cache;
template <> struct Cache<__nv_bfloat16> { static constexpr bool INT8 = false; };
template <> struct Cache<int8_t> { static constexpr bool INT8 = true; };

// grid (H, B); block WARPS warps. q, out (B, H, D); k, v (B, H, T, D);
// k_s, v_s (B, H, T) bf16 (int8 only); cur_len (B,); lo (B,) or null.
template <typename KV, int D, typename QT>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const QT* __restrict__ q, const KV* __restrict__ k,
                    const KV* __restrict__ v, const __nv_bfloat16* __restrict__ k_s,
                    const __nv_bfloat16* __restrict__ v_s, const int* __restrict__ cur_len,
                    const int* __restrict__ lo, QT* __restrict__ out, int H, int T,
                    float scale) {
  constexpr bool INT8 = Cache<KV>::INT8;
  constexpr int EPL = 16 / sizeof(KV);   // elements a lane loads per key
  constexpr int LPK = D / EPL;           // lanes per key row
  constexpr int KPW = 32 / LPK;          // keys a warp covers per load
  static_assert(LPK >= 1 && LPK <= 32 && 32 % LPK == 0, "head_dim");
  __shared__ float sm_m[WARPS], sm_l[WARPS], sm_acc[WARPS][D];

  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / LPK, sub = lane % LPK;
  const int first = lo ? max(lo[b], 0) : 0;
  const int last = min(cur_len[b], T - 1);
  const size_t bh = (size_t)b * H + h;
  const KV* kb = k + bh * T * D + sub * EPL;
  const KV* vb = v + bh * T * D + sub * EPL;

  float qf[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) qf[e] = to_f32(q[bh * D + sub * EPL + e]);

  float m = -INFINITY, l = 0.f, acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;

  for (int t0 = first + warp * KPW * U; t0 <= last; t0 += WARPS * KPW * U) {
    uint4 kr[U], vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int tc = min(t0 + u * KPW + grp, last);   // idle groups re-read `last`
      kr[u] = __ldg(reinterpret_cast<const uint4*>(kb + (size_t)tc * D));
      vr[u] = __ldg(reinterpret_cast<const uint4*>(vb + (size_t)tc * D));
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * KPW + grp;
      float kf[EPL];
      unpack(kr[u], kf);
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) s += qf[e] * kf[e];
#pragma unroll
      for (int o = LPK / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (t <= last) {
        s *= scale;
        float pv_scale = 1.f;
        if (INT8) {
          s *= __bfloat162float(k_s[bh * T + t]);
          pv_scale = __bfloat162float(v_s[bh * T + t]);
        }
        const float m_new = fmaxf(m, s);
        const float alpha = rescale(m, m_new);
        const float p = expf(s - m_new);
        l = l * alpha + p;
        const float pv = p * pv_scale;
        float vf[EPL];
        unpack(vr[u], vf);
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[e] = acc[e] * alpha + pv * vf[e];
        m = m_new;
      }
    }
  }

  // merge the key groups of the warp: lanes with the same `sub` combine
  for (int o = LPK; o < 32; o <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, o);
    const float lo_ = __shfl_xor_sync(0xffffffffu, l, o);
    const float m_new = fmaxf(m, mo);
    const float a = rescale(m, m_new), c = rescale(mo, m_new);
    l = l * a + lo_ * c;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const float ao = __shfl_xor_sync(0xffffffffu, acc[e], o);
      acc[e] = acc[e] * a + ao * c;
    }
    m = m_new;
  }
  if (grp == 0) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[warp][sub * EPL + e] = acc[e];
    if (sub == 0) {
      sm_m[warp] = m;
      sm_l[warp] = l;
    }
  }
  __syncthreads();

  // merge the warps; one thread per output entry
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = rescale(sm_m[w], mx);
      den += sm_l[w] * c;
      num += sm_acc[w][d] * c;
    }
    store(out + bh * D + d, num / fmaxf(den, 1e-30f));
  }
}

template <typename KV, typename QT>
cudaError_t launch_typed(const void* q, const void* k, const void* v, const void* k_s,
                         const void* v_s, const int* cur_len, const int* lo, void* out,
                         int B, int H, int T, int D, cudaStream_t st) {
  const dim3 grid(H, B);
  const float scale = 1.0f / sqrtf((float)D);
#define CASE(DIM)                                                                        \
  case DIM:                                                                              \
    flash_decode_kernel<KV, DIM, QT><<<grid, THREADS, 0, st>>>(                          \
        (const QT*)q, (const KV*)k, (const KV*)v, (const __nv_bfloat16*)k_s,             \
        (const __nv_bfloat16*)v_s, cur_len, lo, (QT*)out, H, T, scale);                  \
    break;
  switch (D) {
    CASE(32)
    CASE(64)
    CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef CASE
  return cudaGetLastError();
}

}  // namespace

// The wrapper (kernels/decode_attention.py) checks devices, types, shapes
// (q, out (B, H, 1, D); k, v (B, H, T, D); k_s, v_s (B, H, T); cur_len and
// lo (B,) int32), contiguity, 16-byte alignment and D in {32, 64, 128}.
// kv_int8 selects the int8 cache (k_s, v_s given) over the bf16 one; lo may
// be null (every window starts at 0). Returns the CUDA error of the launch.
extern "C" int decode_attention_launch(const void* q, int q_bf16, const void* k,
                                       const void* v, int kv_int8, const void* k_s,
                                       const void* v_s, const int* cur_len, const int* lo,
                                       void* out, int B, int H, int T, int D, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (kv_int8)
    err = q_bf16 ? launch_typed<int8_t, __nv_bfloat16>(q, k, v, k_s, v_s, cur_len, lo, out,
                                                       B, H, T, D, st)
                 : launch_typed<int8_t, float>(q, k, v, k_s, v_s, cur_len, lo, out, B, H, T,
                                               D, st);
  else
    err = q_bf16 ? launch_typed<__nv_bfloat16, __nv_bfloat16>(q, k, v, k_s, v_s, cur_len, lo,
                                                              out, B, H, T, D, st)
                 : launch_typed<__nv_bfloat16, float>(q, k, v, k_s, v_s, cur_len, lo, out, B,
                                                      H, T, D, st);
  return (int)err;
}
