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
//         length, keys at pos <= cur_len[b] (B3's kernel with lo = 0).
// out[b, h] = sum_t softmax_t(q[b, h] . k[b, h, t] / sqrt(D)) v[b, h, t]
// over the window, scores and sums in f32, written in q's type.
//
// What bounds it: each (row, head) reads its window's K and V once,
// 2 * (cur - lo + 1) * D elements (plus two scales a position for int8),
// and does ~4 operations per element, far below the card's compute, so
// the cache bytes over the memory rate bound it. At the decode paths'
// shapes (B <= 16, 16 heads, D = 64, windows of a few hundred keys) those
// bytes are a few MB or less, under 1 us at 3.35 TB/s, so the latency of
// the chain of loads each block waits on, and the launch, are what a call
// costs.
//
// B3 / B7, split_decode_kernel: one (row, head) window split over S blocks.
// The first design gave one block to each (row, head): 16 blocks on 132 SMs
// at Turbo's single stream, each pulling ~136 KB through one SM in ~5
// dependent rounds of loads, then merging in series (9.56 us against 0.65
// us of bound, NVIDIA H100 80GB HBM3, 700 W power limit; chip_smoke.py
// phase 3). This design:
//   * Grid (S, H, B). S comes from the cache shape alone (the wrapper's
//     split_count), never from cur_len, so the launch depends on no host
//     value of the window and a CUDA graph can capture it with cur_len and
//     lo on the device. Block s takes keys [first + s*chunk, + chunk) of the
//     window [first, last] = [lo[b], min(cur_len[b], T - 1)], chunk =
//     ceil(window / S), computed on the device; a chunk may be empty.
//   * In the (B, H, T, D) layout a chunk of K is one contiguous run of
//     rows, and so is V's. One thread copies it by cp.async.bulk onto an
//     mbarrier, in pieces of PIECE keys through a two-slot ring, so shared
//     memory has a fixed size whatever T is; compute starts when the first
//     piece lands, while the second is in flight.
//   * Compute from shared memory: LPK lanes per key, 16 bytes each, a warp
//     covering KPW keys at once and SU such groups before it updates its
//     state; each group of LPK lanes keeps its own running max, sum and
//     D-wide accumulator, merged over the warp by shuffles and over the
//     warps through shared memory into the block's (m, l, acc).
//   * The S blocks form a thread-block cluster. Each writes its (m, l, acc)
//     into rank 0's shared memory (distributed shared memory) and arrives
//     on the cluster barrier, and rank 0 merges once all have. Timed
//     against it (chip_smoke.py's sweep; PERF.md): rank 0 reading the
//     peers' states between two cluster.sync() calls, and each block
//     writing its state to device memory with the last of an atomic ticket
//     merging, were both slower at every split count the wrappers pick.
// Numerics: f32 scores times 1 / sqrt(D) (then times K's scale), f32 online
// softmax, weights not rounded before the value product, each state
// rescaled by exp(m_s - m) with an empty one (m = -inf) weighing nothing,
// the denominator clamped at 1e-30 as the Pallas kernels do; only the order
// of the sums differs. An empty window (lo > cur) gives 0, as theirs does.
//
// B4 keeps the first design, flash_decode_kernel: grid (H, B), one block
// per (row, head) looping over its window with 16-byte __ldg loads, U loads
// of K and V in flight per warp before any is used.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int U = 4;           // key loads a warp issues before using them (B4)

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

template <typename QT>
cudaError_t launch_int8(const void* q, const void* k, const void* v, const void* k_s,
                        const void* v_s, const int* cur_len, const int* lo, void* out,
                        int B, int H, int T, int D, cudaStream_t st) {
  const dim3 grid(H, B);
  const float scale = 1.0f / sqrtf((float)D);
#define CASE(DIM)                                                                        \
  case DIM:                                                                              \
    flash_decode_kernel<int8_t, DIM, QT><<<grid, THREADS, 0, st>>>(                      \
        (const QT*)q, (const int8_t*)k, (const int8_t*)v, (const __nv_bfloat16*)k_s,     \
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

// ---------------------------------------------------------------------------
// B3 / B7: the window split over S blocks
// ---------------------------------------------------------------------------

constexpr int MAX_SPLITS = 16;     // the largest cluster Hopper schedules (non-portable > 8)
constexpr int SU = 2;              // key groups a warp scores before its state update

// one split's state; acc is relative to exp(m)
template <int D> struct SplitState {
  float m, l, acc[D];
};

// grid (S, H, B), cluster (S, 1, 1); block WARPS warps. q, out (B, H, D);
// k, v (B, H, T, D) bf16; cur_len (B,); lo (B,) or null.
template <int D, typename QT>
__global__ void __launch_bounds__(THREADS)
split_decode_kernel(const QT* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const int* __restrict__ cur_len,
                    const int* __restrict__ lo, QT* __restrict__ out, int H, int T,
                    float scale) {
  constexpr int EPL = 8;                 // bf16 a lane loads per key (16 bytes)
  constexpr int LPK = D / EPL;           // lanes per key row
  constexpr int KPW = 32 / LPK;          // keys a warp covers per load
  // keys of one bulk piece: 8 KB of K and 8 KB of V at D = 64 or 128 (4 KB
  // at D = 32), so the two-slot ring is 32 KB or less of static shared memory
  constexpr int PIECE = D <= 64 ? 64 : 32;
  static_assert(LPK >= 1 && LPK <= 32 && 32 % LPK == 0, "head_dim");
  __shared__ __align__(128) __nv_bfloat16 ks[2][PIECE * D];
  __shared__ __align__(128) __nv_bfloat16 vs[2][PIECE * D];
  __shared__ uint64_t bars[2];
  __shared__ float sm_m[WARPS], sm_l[WARPS], sm_acc[WARPS][D];
  __shared__ SplitState<D> states[MAX_SPLITS];   // rank 0's: every split's state

  const int S = gridDim.x, s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / LPK, sub = lane % LPK;
  const size_t bh = (size_t)b * H + h;

  // this block's chunk of the window, from the device's cur_len and lo
  const int first = lo ? max(lo[b], 0) : 0;
  const int last = min(cur_len[b], T - 1);
  const int window = max(last - first + 1, 0);
  const int chunk = (window + S - 1) / S;
  const int start = first + s * chunk;
  const int count = max(min(chunk, last + 1 - start), 0);
  const int pieces = (count + PIECE - 1) / PIECE;

  // piece p of the chunk into slot p % 2: K and V rows, one copy each
  const auto issue = [&](int p) {
    const int n = min(PIECE, count - p * PIECE);
    const uint32_t bytes = (uint32_t)n * D * sizeof(__nv_bfloat16);
    const size_t off = (bh * T + start + (size_t)p * PIECE) * D;
    mbar_expect_tx(&bars[p & 1], 2 * bytes);
    bulk_load(ks[p & 1], k + off, bytes, &bars[p & 1]);
    bulk_load(vs[p & 1], v + off, bytes, &bars[p & 1]);
  };
  if (threadIdx.x == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    mbar_fence_init();
    for (int p = 0; p < min(pieces, 2); ++p) issue(p);
  }

  float qf[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) qf[e] = to_f32(q[bh * D + sub * EPL + e]);

  float m = -INFINITY, l = 0.f, acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;
  __syncthreads();                       // the barriers are initialised
  // the first phase of the cluster barrier completes once every block of the
  // cluster runs: its peers' shared memory may then be written
  cluster_arrive_relaxed();

  for (int p = 0; p < pieces; ++p) {
    const int slot = p & 1;
    const int n = min(PIECE, count - p * PIECE);
    mbar_wait(&bars[slot], (p >> 1) & 1);
    const __nv_bfloat16* kp = ks[slot] + sub * EPL;
    const __nv_bfloat16* vp = vs[slot] + sub * EPL;
    for (int j0 = warp * KPW * SU; j0 < n; j0 += WARPS * KPW * SU) {
      float sc[SU];
#pragma unroll
      for (int u = 0; u < SU; ++u) {
        const int jc = min(j0 + u * KPW + grp, n - 1);   // idle groups re-read the last key
        float kf[EPL];
        unpack(*reinterpret_cast<const uint4*>(kp + jc * D), kf);
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot += qf[e] * kf[e];
#pragma unroll
        for (int o = LPK / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        sc[u] = dot * scale;
      }
#pragma unroll
      for (int u = 0; u < SU; ++u) {
        const int j = j0 + u * KPW + grp;
        if (j < n) {
          const float m_new = fmaxf(m, sc[u]);
          const float alpha = rescale(m, m_new);
          const float pr = expf(sc[u] - m_new);
          l = l * alpha + pr;
          float vf[EPL];
          unpack(*reinterpret_cast<const uint4*>(vp + j * D), vf);
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[e] = acc[e] * alpha + pr * vf[e];
          m = m_new;
        }
      }
    }
    __syncthreads();                     // slot read by every warp
    if (threadIdx.x == 0 && p + 2 < pieces) issue(p + 2);
  }

  // merge the key groups of the warp, then the warps, into the block's state
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
  static_assert(D <= THREADS, "one thread per output entry");
  const int d = threadIdx.x;
  float mx = -INFINITY, den = 0.f, num = 0.f;
  if (d < D) {
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w]);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = rescale(sm_m[w], mx);
      den += sm_l[w] * c;
      num += sm_acc[w][d] * c;
    }
  }

  // each block writes its state into rank 0's slot s, then arrives on the
  // second phase (release) and may exit; rank 0 waits for all (acquire)
  cluster_wait();                        // every block of the cluster runs
  if (d < D) {
    SplitState<D>* slot = cg::this_cluster().map_shared_rank(&states[s], 0);
    slot->acc[d] = num;
    if (d == 0) slot->m = mx, slot->l = den;
  }
  cluster_arrive_release();
  if (s != 0) return;
  cluster_wait();
  if (d >= D) return;
  float m_all = -INFINITY;
  for (int r = 0; r < S; ++r) m_all = fmaxf(m_all, states[r].m);
  float l_all = 0.f, acc_all = 0.f;
  for (int r = 0; r < S; ++r) {
    const float c = rescale(states[r].m, m_all);
    l_all += states[r].l * c;
    acc_all += states[r].acc[d] * c;
  }
  store(out + bh * D + d, acc_all / fmaxf(l_all, 1e-30f));
}

template <int D, typename QT>
cudaError_t launch_split_typed(const void* q, const void* k, const void* v,
                               const int* cur_len, const int* lo, void* out, int B, int H,
                               int T, int S, cudaStream_t st) {
  const auto kernel = split_decode_kernel<D, QT>;
  cudaError_t err;
  if (S > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, H, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, (const QT*)q, (const __nv_bfloat16*)k,
                           (const __nv_bfloat16*)v, cur_len, lo, (QT*)out, H, T,
                           1.0f / sqrtf((float)D));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename QT>
cudaError_t launch_split(const void* q, const void* k, const void* v, const int* cur_len,
                         const int* lo, void* out, int B, int H, int T, int D, int S,
                         cudaStream_t st) {
  switch (D) {
    case 32:
      return launch_split_typed<32, QT>(q, k, v, cur_len, lo, out, B, H, T, S, st);
    case 64:
      return launch_split_typed<64, QT>(q, k, v, cur_len, lo, out, B, H, T, S, st);
    case 128:
      return launch_split_typed<128, QT>(q, k, v, cur_len, lo, out, B, H, T, S, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// The wrappers (kernels/decode_attention.py) check devices, types, shapes
// (q, out (B, H, 1, D); k, v (B, H, T, D); k_s, v_s (B, H, T); cur_len and
// lo (B,) int32), contiguity, 16-byte alignment, D in {32, 64, 128} and
// 1 <= S <= 16; lo may be null (every window starts at 0). Each returns the
// CUDA error of the launch.

// B4: the int8 cache with its scales k_s, v_s.
extern "C" int flash_decode_int8_launch(const void* q, int q_bf16, const void* k,
                                        const void* v, const void* k_s, const void* v_s,
                                        const int* cur_len, const int* lo, void* out, int B,
                                        int H, int T, int D, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(q_bf16 ? launch_int8<__nv_bfloat16>(q, k, v, k_s, v_s, cur_len, lo, out, B, H,
                                                   T, D, st)
                      : launch_int8<float>(q, k, v, k_s, v_s, cur_len, lo, out, B, H, T, D,
                                           st));
}

// B3 / B7: the bf16 cache, the window split over a cluster of S blocks.
extern "C" int split_decode_launch(const void* q, int q_bf16, const void* k, const void* v,
                                   const int* cur_len, const int* lo, void* out, int B, int H,
                                   int T, int D, int S, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (S < 1 || S > MAX_SPLITS) return (int)cudaErrorInvalidValue;
  return (int)(q_bf16 ? launch_split<__nv_bfloat16>(q, k, v, cur_len, lo, out, B, H, T, D, S,
                                                    st)
                      : launch_split<float>(q, k, v, cur_len, lo, out, B, H, T, D, S, st));
}
