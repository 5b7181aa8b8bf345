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
// One kernel, split_decode_kernel, templated over the cache type, serves
// all three. The first design gave one block to each (row, head): 16 blocks
// on 132 SMs at Turbo's single stream, each pulling its window through one
// SM in dependent rounds of loads (B4 also read its two scales a key from
// device memory inside the update), then merging in series (B3 9.56 us
// against 0.65 us of bound, B4 8.03 us against 0.34; NVIDIA H100 80GB HBM3,
// 700 W power limit; chip_smoke.py phase 3). This design:
//   * Grid (S, H, B). S comes from the cache shape alone (the wrapper's
//     split_count), never from cur_len, so the launch depends on no host
//     value of the window and a CUDA graph can capture it with cur_len and
//     lo on the device. Block s takes keys [base + s*chunk, + chunk) of the
//     window [first, last] = [lo[b], min(cur_len[b], T - 1)], chunk =
//     ceil((last - base + 1) / S), computed on the device; a chunk may be
//     empty. base = first for the bf16 cache; for the int8 cache base and
//     chunk are rounded down and up to multiples of 8 keys (keys below
//     first masked), so that each piece's scales start 16-byte aligned.
//   * In the (B, H, T, D) layout a chunk of K is one contiguous run of
//     rows, and so is V's (and, int8, each of the two scale rows). One
//     thread copies it by cp.async.bulk onto an mbarrier, in pieces of PIECE
//     keys through a two-slot ring, so shared memory has a fixed size
//     whatever T is; compute starts when the first piece lands, while the
//     second is in flight. An int8 piece holds twice the keys of a bf16 one
//     in the same bytes, and its scales (rounded up to 8 keys, within T)
//     arrive on the same barrier.
//   * Compute from shared memory: LPK lanes per key, 16 bytes each (8 bf16
//     or 16 int8 values), a warp covering KPW keys at once and SU such
//     groups before it updates its state; each group of LPK lanes keeps its
//     own running max, sum and D-wide accumulator, merged over the warp by
//     shuffles and over the warps through shared memory into the block's
//     (m, l, acc). The int8 path, which does twice the arithmetic a cache
//     byte, takes the SU keys' maximum first and rescales its state once
//     for them, and turns codes into floats by an exponent trick instead of
//     the int-to-float conversion (B4 against its first design at phase 3's
//     batched shape: 0.913 without the two, 0.834 with them; PERF.md); the
//     bf16 path keeps its per-key update, timed as B3's split design.
//   * The S blocks form a thread-block cluster. Each writes its (m, l, acc)
//     into rank 0's shared memory (distributed shared memory) and arrives
//     on the cluster barrier, and rank 0 merges once all have. Timed
//     against it (chip_smoke.py's sweep; PERF.md): rank 0 reading the
//     peers' states between two cluster.sync() calls, and each block
//     writing its state to device memory with the last of an atomic ticket
//     merging, were both slower at every split count the wrappers pick.
// Numerics: f32 scores times 1 / sqrt(D) (then, int8, times K's scale), f32
// online softmax, weights not rounded before the value product (int8: the
// running sum takes the weight, the accumulator the weight times V's
// scale), each state rescaled by exp(m_s - m) with an empty one (m = -inf)
// weighing nothing, the denominator clamped at 1e-30 as the Pallas kernels
// do; only the order of the sums differs. An empty window (lo > cur) gives
// 0, as theirs does.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

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

// int8 codes without the int-to-float conversion (a quarter of the FP32
// rate): code b + 128 goes in the low mantissa bits of 2^23, and 2^23 + 128
// comes off, both exact.
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[16]) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t x = w[i] ^ 0x80808080u;      // each byte b + 128
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[4 * i + j] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440 | j)) - 8388736.f;
  }
}

// exp(m - m_new) with an empty state (m = -inf) weighing nothing
__device__ __forceinline__ float rescale(float m, float m_new) {
  return m == -INFINITY ? 0.f : expf(m - m_new);
}

constexpr int MAX_SPLITS = 16;     // the largest cluster Hopper schedules (non-portable > 8)
constexpr int SU = 2;              // key groups a warp scores before its state update

// one split's state; acc is relative to exp(m)
template <int D> struct SplitState {
  float m, l, acc[D];
};

// grid (S, H, B), cluster (S, 1, 1); block WARPS warps. q, out (B, H, D);
// k, v (B, H, T, D) bf16 or int8; k_s, v_s (B, H, T) bf16 (int8 only;
// T % 8 == 0); cur_len (B,); lo (B,) or null.
template <typename KV, int D, typename QT>
__global__ void __launch_bounds__(THREADS)
split_decode_kernel(const QT* __restrict__ q, const KV* __restrict__ k,
                    const KV* __restrict__ v, const __nv_bfloat16* __restrict__ k_s,
                    const __nv_bfloat16* __restrict__ v_s, const int* __restrict__ cur_len,
                    const int* __restrict__ lo, QT* __restrict__ out, int H, int T,
                    float scale) {
  constexpr bool INT8 = sizeof(KV) == 1;
  constexpr int EPL = 16 / sizeof(KV);   // elements a lane loads per key (16 bytes)
  constexpr int LPK = D / EPL;           // lanes per key row
  constexpr int KPW = 32 / LPK;          // keys a warp covers per load
  // keys of one bulk piece: 8 KB of K and 8 KB of V at D = 64 or 128 (4 KB
  // at D = 32), twice the keys for int8, so the ring of SLOTS pieces is 32
  // KB or less of static shared memory
  constexpr int PIECE = (D <= 64 ? 64 : 32) * (INT8 ? 2 : 1);
  constexpr int SLOTS = 2;
  // int8: chunks start on multiples of ALIGN keys, so a piece's scales (2
  // bytes a key) start 16-byte aligned for the bulk copy
  constexpr int ALIGN = INT8 ? 8 : 1;
  constexpr int SCALES = INT8 ? PIECE : 8;   // scale slots a piece (int8 only)
  static_assert(LPK >= 1 && LPK <= 32 && 32 % LPK == 0, "head_dim");
  __shared__ __align__(128) KV ks[SLOTS][PIECE * D];
  __shared__ __align__(128) KV vs[SLOTS][PIECE * D];
  __shared__ __align__(16) __nv_bfloat16 kss[SLOTS][SCALES];
  __shared__ __align__(16) __nv_bfloat16 vss[SLOTS][SCALES];
  __shared__ uint64_t bars[SLOTS];
  __shared__ float sm_m[WARPS], sm_l[WARPS], sm_acc[WARPS][D];
  __shared__ SplitState<D> states[MAX_SPLITS];   // rank 0's: every split's state

  const int S = gridDim.x, s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / LPK, sub = lane % LPK;
  const size_t bh = (size_t)b * H + h;

  // this block's chunk of the window, from the device's cur_len and lo
  const int first = lo ? max(lo[b], 0) : 0;
  const int last = min(cur_len[b], T - 1);
  const int base = first / ALIGN * ALIGN;
  const int window = max(last - base + 1, 0);
  const int chunk = ((window + S - 1) / S + ALIGN - 1) / ALIGN * ALIGN;
  const int start = base + s * chunk;
  const int count = max(min(chunk, last + 1 - start), 0);
  const int pieces = (count + PIECE - 1) / PIECE;

  // piece p of the chunk into slot p % SLOTS: K and V rows, one copy each,
  // and (int8) their scales rounded up to ALIGN keys, which stays inside T
  const auto issue = [&](int p) {
    const int n = min(PIECE, count - p * PIECE), slot = p % SLOTS;
    const uint32_t bytes = (uint32_t)n * D * sizeof(KV);
    const size_t row = bh * T + start + (size_t)p * PIECE;
    const uint32_t sbytes = INT8 ? (uint32_t)(n + ALIGN - 1) / ALIGN * ALIGN * 2 : 0;
    mbar_expect_tx(&bars[slot], 2 * bytes + 2 * sbytes);
    bulk_load(ks[slot], k + row * D, bytes, &bars[slot]);
    bulk_load(vs[slot], v + row * D, bytes, &bars[slot]);
    if constexpr (INT8) {
      bulk_load(kss[slot], k_s + row, sbytes, &bars[slot]);
      bulk_load(vss[slot], v_s + row, sbytes, &bars[slot]);
    }
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < SLOTS; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
    for (int p = 0; p < min(pieces, SLOTS); ++p) issue(p);
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
    const int slot = p % SLOTS;
    const int n = min(PIECE, count - p * PIECE);
    // int8: the keys of this piece below `first` (chunk 0's alignment) are masked
    const int skip = INT8 ? max(first - (start + p * PIECE), 0) : 0;
    mbar_wait(&bars[slot], (p / SLOTS) & 1);
    const KV* kp = ks[slot] + sub * EPL;
    const KV* vp = vs[slot] + sub * EPL;
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
        if constexpr (INT8) sc[u] *= __bfloat162float(kss[slot][jc]);
      }
      if constexpr (INT8) {
        // the SU keys' maximum first, then one rescale of the state for them
        float m_new = m;
#pragma unroll
        for (int u = 0; u < SU; ++u) {
          const int j = j0 + u * KPW + grp;
          if (j < n && j >= skip) m_new = fmaxf(m_new, sc[u]);
        }
        const float alpha = rescale(m, m_new);
        l *= alpha;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[e] *= alpha;
#pragma unroll
        for (int u = 0; u < SU; ++u) {
          const int j = j0 + u * KPW + grp;
          if (j < n && j >= skip) {
            const float pr = expf(sc[u] - m_new);
            l += pr;
            const float pv = pr * __bfloat162float(vss[slot][j]);
            float vf[EPL];
            unpack(*reinterpret_cast<const uint4*>(vp + j * D), vf);
#pragma unroll
            for (int e = 0; e < EPL; ++e) acc[e] += pv * vf[e];
          }
        }
        m = m_new;
      } else {
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
    }
    __syncthreads();                     // slot read by every warp
    if (threadIdx.x == 0 && p + SLOTS < pieces) issue(p + SLOTS);
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

template <typename KV, int D, typename QT>
cudaError_t launch_split_typed(const void* q, const void* k, const void* v, const void* k_s,
                               const void* v_s, const int* cur_len, const int* lo, void* out,
                               int B, int H, int T, int S, cudaStream_t st) {
  const auto kernel = split_decode_kernel<KV, D, QT>;
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
  err = cudaLaunchKernelEx(&cfg, kernel, (const QT*)q, (const KV*)k, (const KV*)v,
                           (const __nv_bfloat16*)k_s, (const __nv_bfloat16*)v_s, cur_len, lo,
                           (QT*)out, H, T, 1.0f / sqrtf((float)D));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename KV, typename QT>
cudaError_t launch_split(const void* q, const void* k, const void* v, const void* k_s,
                         const void* v_s, const int* cur_len, const int* lo, void* out, int B,
                         int H, int T, int D, int S, cudaStream_t st) {
  switch (D) {
    case 32:
      return launch_split_typed<KV, 32, QT>(q, k, v, k_s, v_s, cur_len, lo, out, B, H, T, S, st);
    case 64:
      return launch_split_typed<KV, 64, QT>(q, k, v, k_s, v_s, cur_len, lo, out, B, H, T, S, st);
    case 128:
      return launch_split_typed<KV, 128, QT>(q, k, v, k_s, v_s, cur_len, lo, out, B, H, T, S,
                                             st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// The wrappers (kernels/decode_attention.py) check devices, types, shapes
// (q, out (B, H, 1, D); k, v (B, H, T, D); k_s, v_s (B, H, T); cur_len and
// lo (B,) int32), contiguity, 16-byte alignment, D in {32, 64, 128}, T a
// multiple of 256 for the int8 cache, and 1 <= S <= 16; lo may be null
// (every window starts at 0).

// B3 / B4 / B7: the window split over a cluster of S blocks. k_s and v_s
// null: the bf16 cache (B3, B7); given: the int8 cache and its scales
// (B4). Returns the CUDA error of the launch.
extern "C" int split_decode_launch(const void* q, int q_bf16, const void* k, const void* v,
                                   const void* k_s, const void* v_s, const int* cur_len,
                                   const int* lo, void* out, int B, int H, int T, int D, int S,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (S < 1 || S > MAX_SPLITS || (k_s == nullptr) != (v_s == nullptr)
      || (k_s && T % 8))
    return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  if (k_s)
    return (int)(q_bf16 ? launch_split<int8_t, bf16>(q, k, v, k_s, v_s, cur_len, lo, out, B,
                                                     H, T, D, S, st)
                        : launch_split<int8_t, float>(q, k, v, k_s, v_s, cur_len, lo, out, B,
                                                      H, T, D, S, st));
  return (int)(q_bf16 ? launch_split<bf16, bf16>(q, k, v, k_s, v_s, cur_len, lo, out, B, H, T,
                                                 D, S, st)
                      : launch_split<bf16, float>(q, k, v, k_s, v_s, cur_len, lo, out, B, H,
                                                  T, D, S, st));
}
