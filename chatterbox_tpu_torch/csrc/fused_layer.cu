// Fused decode-layer kernels with int8 weights, for Hopper (sm_90a).
//
// Replaces the four int8 Pallas TPU kernels of chatterbox_tpu/ops/fused_layer.py
// and the one of chatterbox_tpu/ops/pallas_mlp.py:
//   GPT-2 (Turbo T3, 24 layers):
//   B1  ln_qkv_int8          (_ln_qkv_kernel_i8):
//         out = (bf16(LN1(x)) @ Wqkv_int8) * s + bias
//   B2  attnout_ln_mlp_int8  (_attnout_ln_mlp_kernel_i8):
//         r   = x + (bf16(a) @ Wo_int8) * so + bo
//         h   = bf16(gelu_new((bf16(LN2(r)) @ W1_int8) * s1 + b1))
//         out = r + b2 + sum over hidden tiles t of (h_t @ W2_int8_t) * s2
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
// Weights are stored OUT-MAJOR, (N, K) with K contiguous: the converter
// transposes the JAX (K, N) layout once. Every kernel here is a template on
// NB, the rows its MMA tiles take (8, or 16 for 9-16 rows): a call of B
// rows runs the smallest instance with NB >= B, and each weight byte is
// read once per call whatever B is. B1 and B5 share a tensor-core kernel,
// and B2, B6 and B11 the phases of another, each with its own note
// (norm_qkv_tc_kernel, tc_int8_kernel below). The TPU kernels compute the
// norm once at grid step 0 and keep it in VMEM scratch, relying on the
// sequential grid; blocks on Hopper run in no order, so every block
// normalises its input rows itself, while its weight slab streams.
// Each second half (B2, B6) has two dependencies across the whole width
// (attn-out and the norm before the MLP; all hidden units before the down
// projection), so each is three launches on one stream: attn-out +
// residual, norm + up-projection(s) + activation, down-projection +
// residual, with r (f32) and h (bf16: its values are bf16-rounded) in small
// global scratch buffers; B11 is the last two on x.
// Numerics mirror the Pallas kernels: norms in f32, the vector rounded to
// bf16 before each product, int8 -> bf16 exact, f32 accumulation, scale
// (and bias) applied after the K sum. B2 and B6 apply the down scale to each
// tw-wide hidden tile's sum and accumulate the tiles in order onto r, as
// the Pallas grid does; B11 scales the whole sum once, as its one-step
// Pallas kernel does.

#include <type_traits>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// B1 / B5 on the tensor cores: out = (bf16(norm(x)) @ W) * s (+ bias for
// the LayerNorm form). Bound: the int8 weight bytes (3.15 MB at D = 1024,
// N = 3072: 0.94 us at 3.35 TB/s) at every row count 1-16.
//
// The first design of these kernels (one warp per output column, the norm
// first, rows on the CUDA cores) took 7.43 us (B1, 1 row) and 10.60 us (B5,
// 2 rows), and grew to 67.26 / 60.20 us at 16 rows (NVIDIA H100 80GB HBM3,
// 700 W power limit; chip_smoke.py phase 3). This design:
//   * The weight stream starts first. A block owns QKV_COLS = 32 output
//     columns (96 blocks at N = 3072, one per SM); at entry one thread asks
//     for its whole slab (32 contiguous out-major columns x K bytes, 32 KB at
//     K = 1024) as one 1-D bulk copy (TMA) into shared memory, completing on
//     an mbarrier, and for g (and b) the same way on a second barrier. The
//     grid's slabs are in flight at once while the norm runs.
//   * The norm (norm_rows_bf16, common.cuh) runs one row per warp (rows w,
//     w + 8), with shuffle reductions only. A bf16 x row is read from device memory once, into
//     its norm row in shared memory, and normalised there in place; f32 x
//     (on no main path) is reread from device memory in each pass. The bf16
//     result is exact (the Pallas kernels round y to bf16 before the
//     product); rows B..NB-1 are zero. One __syncthreads, then each thread
//     waits on the weights.
//   * The rows go through the tensor cores: mma.sync m16n8k16 bf16 with f32
//     accumulation, A = 16 weight columns (int8 -> bf16 in registers, exact),
//     B = 8 norm rows (two tiles for 9-16 rows), so 1 and 8 rows cost the
//     same. Both operands take one permutation of k: over a 64-wide chunk,
//     lane (g, t) holds the MMA's k slots {2t, 2t+1, 2t+8, 2t+9} of k-step j
//     at physical k 16t + 4j + {0, 1, 2, 3}, so it reads 16 contiguous weight
//     bytes per column and 16 contiguous bf16 per row. The eight warps split
//     K; their partial sums meet in shared memory, summed in warp order.
//   * Epilogue: scale (and bias) after the full K sum, as the Pallas kernels
//     do; rows < B written.
// What grows with the rows is the norm, which every block computes for all
// B rows: 32 columns a block halves that work against 16 (192 blocks), and
// timed faster than 16 or 48 at 1-16 rows; x rows copied by TMA, or the
// norm split across warps at small B, timed slower than the plain loads and
// one warp per row here. Norm rows are padded by 16 bytes, so that a
// quarter-warp's 16-byte loads of them fall in distinct banks; the weight
// slab is not (one copy), and its 16-byte loads conflict two ways.
constexpr int QKV_COLS = 32;
constexpr int QKV_YPAD = 8;        // bf16 elements

// Shared memory of one block: two barriers, g (and b), the weight slab,
// NB norm rows, and the eight warps' partial sums.
__host__ __device__ constexpr size_t norm_qkv_smem(int NB, int D, bool rms) {
  return 16 + (size_t)(rms ? 1 : 2) * D * 4 + (size_t)QKV_COLS * D
         + (size_t)NB * (D + QKV_YPAD) * 2 + (size_t)WARPS * NB * QKV_COLS * 4;
}

// grid = N / QKV_COLS; NB = 8 or 16 rows (one or two 8-row MMA tiles);
// K % (WARPS * 64) == 0.
template <typename T, bool RMS, int NB>
__global__ void __launch_bounds__(THREADS)
norm_qkv_tc_kernel(const T* __restrict__ x, const float* __restrict__ g,
                   const float* __restrict__ b, const int8_t* __restrict__ w_t,
                   const float* __restrict__ s, const float* __restrict__ bias,
                   float* __restrict__ out, int B, int D, int N, float eps) {
  constexpr int RT = NB / 8, MT = QKV_COLS / 16;
  constexpr int EPT = (NB * QKV_COLS + THREADS - 1) / THREADS;   // outputs per thread
  extern __shared__ float4 smem4[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem4);       // [0] g, b; [1] weights
  float* gb = reinterpret_cast<float*>(smem4 + 1);            // g, then b (LayerNorm)
  int8_t* ws = reinterpret_cast<int8_t*>(gb + (RMS ? 1 : 2) * D);
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(ws + QKV_COLS * D);
  const int yld = D + QKV_YPAD;
  float* part = reinterpret_cast<float*>(ys + NB * yld);      // [warp][row][col]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * QKV_COLS;
  if (tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    mbar_fence_init();
    mbar_expect_tx(&bars[1], QKV_COLS * D);
    bulk_load(ws, w_t + (size_t)n0 * D, QKV_COLS * D, &bars[1]);
    mbar_expect_tx(&bars[0], (RMS ? 1 : 2) * D * 4);
    bulk_load(gb, g, D * 4, &bars[0]);
    if (!RMS) bulk_load(gb + D, b, D * 4, &bars[0]);
  }
  // the epilogue's operands, loaded while the copies fly: output o = tid +
  // e * THREADS is (row o / QKV_COLS, column o % QKV_COLS)
  float sc[EPT], bi[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int col = (tid + e * THREADS) % QKV_COLS;
    sc[e] = s[n0 + col];
    bi[e] = RMS ? 0.f : bias[n0 + col];
  }
  __syncthreads();  // the barriers are initialised

  norm_rows_bf16<T, RMS>(x, gb, gb + D, &bars[0], B, NB, D, eps, ys, yld);
  __syncthreads();  // the norm rows are written
  mbar_wait(&bars[1], 0);

  // products: warp w takes the contraction slice [w K / WARPS, (w + 1) K / WARPS)
  const int gq = lane >> 2, tq = lane & 3;
  float acc[MT][RT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][rt][j] = 0.f;
  const int kw = D / WARPS;
  for (int k0 = warp * kw; k0 < (warp + 1) * kw; k0 += 64) {
    uint4 xa[RT][2];
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) {
      const uint4* yrow =
          reinterpret_cast<const uint4*>(ys + (8 * rt + gq) * yld + k0 + 16 * tq);
      xa[rt][0] = yrow[0];
      xa[rt][1] = yrow[1];
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int8_t* wc = ws + (16 * mt + gq) * D + k0 + 16 * tq;
      const uint4 wlo = *reinterpret_cast<const uint4*>(wc);
      const uint4 whi = *reinterpret_cast<const uint4*>(wc + 8 * D);
      const uint32_t* lo = reinterpret_cast<const uint32_t*>(&wlo);
      const uint32_t* hi = reinterpret_cast<const uint32_t*>(&whi);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t a[4];  // columns g and g + 8, k slots 2t, 2t+1 | 2t+8, 2t+9
        i8x4_to_bf16x2(lo[j], a[0], a[2]);
        i8x4_to_bf16x2(hi[j], a[1], a[3]);
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) {
          const uint32_t* xb = reinterpret_cast<const uint32_t*>(&xa[rt][0]);
          mma_bf16_16816(acc[mt][rt], a, xb[2 * j], xb[2 * j + 1]);
        }
      }
    }
  }
  // lane (g, t) holds columns 16 mt + g, 16 mt + g + 8 of rows 8 rt + 2t, + 1
  float* pw = part + warp * NB * QKV_COLS;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) {
      float* p = pw + (8 * rt + 2 * tq) * QKV_COLS + 16 * mt + gq;
      p[0] = acc[mt][rt][0];
      p[QKV_COLS] = acc[mt][rt][1];
      p[8] = acc[mt][rt][2];
      p[QKV_COLS + 8] = acc[mt][rt][3];
    }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int o = tid + e * THREADS, row = o / QKV_COLS;
    if (row < B) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) sum += part[w * NB * QKV_COLS + o];
      sum = __fmul_rn(sum, sc[e]);
      if (!RMS) sum = __fadd_rn(sum, bi[e]);
      out[(size_t)row * N + n0 + o % QKV_COLS] = sum;
    }
  }
}

// ---------------------------------------------------------------------------
// The second halves of B2 and B6, and B11, on the tensor cores: one template
// (tc_int8_kernel) for their phases, each phase one launch:
//   TC_ATTN_OUT  r = res + (bf16(x) @ W) * s (+ bias)
//   TC_GLU       y = bf16(RMSNorm(x) * g);
//                h = bf16(silu((y @ Wg) * sg) * ((y @ Wu) * su))
//   TC_GELU      y = bf16(LayerNorm(x) * g + b);
//                h = bf16(gelu_new((y @ W) * s + bias))
//   TC_DOWN      out = (res + bias) + sum over tw-wide tiles t of
//                (x_t @ W_t) * s, the tiles added in order (B2, B6), or
//                out = res + ((sum of the tiles) * s + bias) (B11)
// B6 is TC_ATTN_OUT, TC_GLU, TC_DOWN; B2 is TC_ATTN_OUT (with bo), TC_GELU
// on r, TC_DOWN over tw = 1024 tiles onto r + b2; B11 is TC_GELU on x, then
// TC_DOWN with res = x in x's type. Bound: the int8 weight bytes, 13.6 MB
// (B6), 9.44 MB (B2) and 8.39 MB (B11) at D = 1024, I = 4096 (4.07, 2.82
// and 2.50 us at 3.35 TB/s), at every row count 1-16.
//
// The first design (one warp per output column, rows on the CUDA cores, the
// rows staged or normalised before any weight load) took B6 31.48 us at 2
// rows and 87.02 us at 8, B2 20.38 us at 1 row and 70.40 at 8, B11 16.24 at
// 1 row (NVIDIA H100 80GB HBM3, 700 W power limit; chip_smoke.py phase 3).
// This design is B1 / B5's:
//   * A block owns COLS output columns (TC_GLU: COLS / 2 hidden units, their
//     gate and up rows) and 1 / KS of the contraction. At entry one thread
//     starts the bulk copies (TMA) of its weight slab onto an mbarrier: one
//     copy when KS = 1 (out-major columns are contiguous; two for the gate
//     and up halves), else one per column. Then the rows are staged as bf16
//     (or normalised, TC_GLU and TC_GELU, one warp per row) while the slab
//     streams.
//   * The rows go through mma.sync m16n8k16 (bf16, f32 sums), 16 weight
//     columns as A (int8 -> bf16 in registers, exact), 8 rows as B (two
//     tiles for 9-16 rows), with B1 / B5's permutation of k on both.
//   * The contraction is cut in NT tiles: TC_DOWN's tw-wide hidden tiles,
//     else one per block. A block sums its NT / KS tiles one after another;
//     the warps split a tile into contiguous runs of 64-wide chunks, and
//     their partial sums meet in shared memory in warp order, giving the
//     tile's sum. With KS > 1 the KS blocks of a column slab form a cluster,
//     and each block writes its tiles' sums into rank 0's shared memory
//     (between the two halves of the cluster barrier, as B3 does); rank 0
//     applies the epilogue over the tiles in order: TC_ATTN_OUT (and B11's
//     TC_DOWN) sums them before the scale, B2 / B6's TC_DOWN adds each
//     tile's scaled sum onto res in turn (the Pallas grid's order).
//   * A phase after the first calls griddep_wait after its copies have
//     started and before it reads the previous phase's output, so with
//     programmatic dependent launch its weight stream overlaps the tail of
//     the phase before.
enum TcMode : int { TC_ATTN_OUT = 0, TC_GLU = 1, TC_GELU = 2, TC_DOWN = 3 };
constexpr int TC_PAD = 8;          // bf16 entries after each staged row

struct TcArgs {
  const void* x;        // rows (B, K): TC_DOWN bf16, the other phases type T
  const void* res;      // TC_ATTN_OUT, TC_DOWN: type T (B, N)
  const int8_t* w;      // out-major (N, K); TC_GLU: the gate rows
  const int8_t* w2;     // TC_GLU: the up rows
  const float* s;       // per-column scales of w
  const float* s2;      // TC_GLU: of w2
  const float* g;       // TC_GLU, TC_GELU: the norm weight (K,)
  const float* b;       // TC_GELU: the norm bias (K,)
  const float* bias;    // (N,) or null: TC_ATTN_OUT, TC_GELU after the scale;
                        // TC_DOWN onto res, or after the scale with scale_once
  void* out;            // TC_ATTN_OUT: (B, N) f32; TC_DOWN: type T; TC_GLU, TC_GELU: h bf16
  int B, K, N, tw;      // tw: TC_DOWN's tile (K otherwise)
  float eps;
  int scale_once;       // TC_DOWN: B11's order (see above)
};

// Shared memory of one block: the barrier, the slab, NB staged rows, the
// warps' partial sums and the NT tile sums.
__host__ __device__ constexpr size_t tc_smem(int NB, int cols, int KS, int K, int NT) {
  return 16 + (size_t)cols * (K / KS) + (size_t)NB * (K / KS + TC_PAD) * 2
         + (size_t)(WARPS + NT) * NB * cols * 4;
}

__device__ __forceinline__ float silu(float x) { return x * (1.0f / (1.0f + expf(-x))); }

// grid = N / UNITS * KS in clusters of KS consecutive blocks; NB = 8 or 16
// rows; the tiles (K / NT wide) a multiple of 64, NT a multiple of KS, and
// K a multiple of 256 for the norm phases (tc_phase checks them).
template <int MODE, typename T, int NB, int COLS, int KS>
__global__ void __launch_bounds__(THREADS) tc_int8_kernel(const TcArgs p) {
  constexpr bool NORM = MODE == TC_GLU || MODE == TC_GELU;
  static_assert(!NORM || KS == 1, "the norm needs the whole row");
  using XT = std::conditional_t<MODE == TC_DOWN, __nv_bfloat16, T>;
  constexpr int RT = NB / 8, MT = COLS / 16;
  constexpr int UNITS = MODE == TC_GLU ? COLS / 2 : COLS;     // outputs per row
  constexpr int EPT = (NB * UNITS + THREADS - 1) / THREADS;   // epilogue outputs a thread
  extern __shared__ float4 smem4[];
  const int B = p.B, K = p.K, kspan = K / KS;
  const int NT = MODE == TC_DOWN ? K / p.tw : KS, TPB = NT / KS;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem4);
  int8_t* ws = reinterpret_cast<int8_t*>(smem4 + 1);
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(ws + COLS * kspan);
  const int yld = kspan + TC_PAD;
  float* part = reinterpret_cast<float*>(ys + NB * yld);     // [warp][row][col]
  float* sums = part + WARPS * NB * COLS;                     // [tile][row][col], rank 0's

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ks = blockIdx.x % KS, n0 = blockIdx.x / KS * UNITS, kb = ks * kspan;
  if (warp == 0) {
    if (lane == 0) {
      mbar_init(bar, 1);
      mbar_fence_init();
      mbar_expect_tx(bar, COLS * kspan);
    }
    __syncwarp();
    if (KS == 1) {
      if (lane == 0 && MODE == TC_GLU) {
        bulk_load(ws, p.w + (size_t)n0 * K, UNITS * K, bar);
        bulk_load(ws + UNITS * K, p.w2 + (size_t)n0 * K, UNITS * K, bar);
      } else if (lane == 0) {
        bulk_load(ws, p.w + (size_t)n0 * K, COLS * K, bar);
      }
    } else {           // one copy a column, issued by the warp's lanes together
      for (int c = lane; c < COLS; c += 32)
        bulk_load(ws + c * kspan, p.w + (size_t)(n0 + c) * K + kb, kspan, bar);
    }
  }
  griddep_launch_dependents();
  griddep_wait();                  // the previous phase's output (rows, res) is written

  // the epilogue's operands, loaded while the slab streams: output o = tid +
  // e * THREADS is (row o / UNITS, column n0 + o % UNITS)
  const bool bias_on_res = MODE == TC_DOWN && !p.scale_once;
  float sc[EPT], sc2[EPT], rv[EPT], bv[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int o = tid + e * THREADS, row = o / UNITS, n = n0 + o % UNITS;
    const bool live = o < NB * UNITS && row < B;
    sc[e] = live ? p.s[n] : 0.f;
    sc2[e] = live && MODE == TC_GLU ? p.s2[n] : 0.f;
    rv[e] = bv[e] = 0.f;
    if (live && (MODE == TC_ATTN_OUT || MODE == TC_DOWN))
      rv[e] = to_f32(static_cast<const T*>(p.res)[(size_t)row * p.N + n]);
    if (live && MODE != TC_GLU && p.bias) {
      if (bias_on_res) rv[e] = __fadd_rn(rv[e], p.bias[n]);
      else bv[e] = p.bias[n];
    }
  }

  if constexpr (NORM)
    norm_rows_bf16<T, MODE == TC_GLU>(static_cast<const T*>(p.x), p.g, p.b, nullptr, B, NB, K,
                                      p.eps, ys, yld);
  else
    stage_rows_bf16(static_cast<const XT*>(p.x) + kb, K, B, NB, kspan, ys, yld);
  __syncthreads();                 // the barrier is initialised, the rows staged
  if (KS > 1) cluster_arrive_relaxed();
  mbar_wait(bar, 0);

  const int gq = lane >> 2, tq = lane & 3;
  const int tws = kspan / TPB, chunks = tws / 64, per_warp = (chunks + WARPS - 1) / WARPS;
  const int c_lo = min(warp * per_warp, chunks), c_hi = min(c_lo + per_warp, chunks);
  for (int tt = 0; tt < TPB; ++tt) {
    float acc[MT][RT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int rt = 0; rt < RT; ++rt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][rt][j] = 0.f;
    for (int c = c_lo; c < c_hi; ++c) {
      const int k0 = tt * tws + 64 * c;
      uint4 xa[RT][2];
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) {
        const uint4* yrow =
            reinterpret_cast<const uint4*>(ys + (8 * rt + gq) * yld + k0 + 16 * tq);
        xa[rt][0] = yrow[0];
        xa[rt][1] = yrow[1];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int8_t* wc = ws + (16 * mt + gq) * kspan + k0 + 16 * tq;
        const uint4 wlo = *reinterpret_cast<const uint4*>(wc);
        const uint4 whi = *reinterpret_cast<const uint4*>(wc + 8 * kspan);
        const uint32_t* lo = reinterpret_cast<const uint32_t*>(&wlo);
        const uint32_t* hi = reinterpret_cast<const uint32_t*>(&whi);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t a[4];  // columns g and g + 8, k slots 2t, 2t+1 | 2t+8, 2t+9
          i8x4_to_bf16x2(lo[j], a[0], a[2]);
          i8x4_to_bf16x2(hi[j], a[1], a[3]);
#pragma unroll
          for (int rt = 0; rt < RT; ++rt) {
            const uint32_t* xb = reinterpret_cast<const uint32_t*>(&xa[rt][0]);
            mma_bf16_16816(acc[mt][rt], a, xb[2 * j], xb[2 * j + 1]);
          }
        }
      }
    }
    // lane (g, t) holds columns 16 mt + g, + 8 of rows 8 rt + 2t, + 1
    float* pw = part + warp * NB * COLS;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) {
        float* q = pw + (8 * rt + 2 * tq) * COLS + 16 * mt + gq;
        q[0] = acc[mt][rt][0];
        q[COLS] = acc[mt][rt][1];
        q[8] = acc[mt][rt][2];
        q[COLS + 8] = acc[mt][rt][3];
      }
    __syncthreads();
    if (KS > 1 && tt == 0) cluster_wait();    // every block of the cluster runs
    float* tile = sums + (ks * TPB + tt) * NB * COLS;
    for (int o = tid; o < NB * COLS; o += THREADS) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) sum += part[w * NB * COLS + o];
      if (KS == 1) tile[o] = sum;
      else st_cluster(tile + o, 0, sum);
    }
    __syncthreads();                          // part is rewritten by the next tile
  }
  if (KS > 1) {
    cluster_arrive_release();
    if (ks != 0) return;
    cluster_wait();                           // every block's tile sums are in
  }

#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int o = tid + e * THREADS, row = o / UNITS, u = o % UNITS;
    if (o >= NB * UNITS || row >= B) continue;
    const size_t at = (size_t)row * p.N + n0 + u;
    if (MODE == TC_GLU) {
      const float ug = __fmul_rn(sums[row * COLS + u], sc[e]);
      const float uu = __fmul_rn(sums[row * COLS + UNITS + u], sc2[e]);
      static_cast<__nv_bfloat16*>(p.out)[at] =
          __float2bfloat16(__fmul_rn(silu(ug), uu));
    } else if (MODE == TC_GELU) {
      const float hu = __fadd_rn(__fmul_rn(sums[row * COLS + u], sc[e]), bv[e]);
      static_cast<__nv_bfloat16*>(p.out)[at] = __float2bfloat16(gelu_new(hu));
    } else if (MODE == TC_ATTN_OUT || p.scale_once) {
      float sum = 0.f;
      for (int t = 0; t < NT; ++t) sum += sums[t * NB * COLS + row * COLS + u];
      const float v = MODE == TC_ATTN_OUT
                          ? __fadd_rn(__fadd_rn(rv[e], __fmul_rn(sum, sc[e])), bv[e])
                          : __fadd_rn(rv[e], __fadd_rn(__fmul_rn(sum, sc[e]), bv[e]));
      store(static_cast<std::conditional_t<MODE == TC_DOWN, T, float>*>(p.out) + at, v);
    } else {
      float v = rv[e];
      for (int t = 0; t < NT; ++t)
        v = __fadd_rn(v, __fmul_rn(sums[t * NB * COLS + row * COLS + u], sc[e]));
      store(static_cast<T*>(p.out) + at, v);
    }
  }
}

template <int MODE, typename T, int NB, int COLS, int KS>
cudaError_t tc_launch(const TcArgs& p, unsigned grid, bool pdl, cudaStream_t st) {
  const int NT = MODE == TC_DOWN ? p.K / p.tw : KS;
  const size_t smem = tc_smem(NB, COLS, KS, p.K, NT);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  return launch_ex<tc_int8_kernel<MODE, T, NB, COLS, KS>>(grid, smem, KS, pdl, st, p);
}

// One phase at KS blocks a column slab (1, 2 or 4; the norm phases 1),
// after the checks of the shapes the kernel takes.
template <int MODE, typename T, int COLS>
cudaError_t tc_phase(const TcArgs& p, int ks, bool pdl, cudaStream_t st) {
  constexpr bool NORM = MODE == TC_GLU || MODE == TC_GELU;
  constexpr int UNITS = MODE == TC_GLU ? COLS / 2 : COLS;
  const int NT = MODE == TC_DOWN ? p.K / p.tw : ks;
  if (p.B < 1 || p.B > 16 || p.N % UNITS || ks < 1 || NT % ks || p.K % NT || (p.K / NT) % 64
      || (MODE == TC_DOWN && p.K % p.tw) || (NORM && (ks != 1 || p.K % 256)))
    return cudaErrorInvalidValue;
  const unsigned grid = p.N / UNITS * ks;
  const bool two = p.B > 8;      // two 8-row MMA tiles
  if (ks == 1)
    return two ? tc_launch<MODE, T, 16, COLS, 1>(p, grid, pdl, st)
               : tc_launch<MODE, T, 8, COLS, 1>(p, grid, pdl, st);
  if constexpr (!NORM) {
    if (ks == 2)
      return two ? tc_launch<MODE, T, 16, COLS, 2>(p, grid, pdl, st)
                 : tc_launch<MODE, T, 8, COLS, 2>(p, grid, pdl, st);
    if (ks == 4)
      return two ? tc_launch<MODE, T, 16, COLS, 4>(p, grid, pdl, st)
                 : tc_launch<MODE, T, 8, COLS, 4>(p, grid, pdl, st);
  }
  return cudaErrorInvalidValue;
}

constexpr int TC_COLS = 16;        // output columns a block of TC_ATTN_OUT / TC_DOWN owns

// TC_GELU at `units` hidden units a block (16, 32 or 64).
template <typename T>
cudaError_t gelu_phase(const TcArgs& p, int units, bool pdl, cudaStream_t st) {
  return units == 64   ? tc_phase<TC_GELU, T, 64>(p, 1, pdl, st)
         : units == 32 ? tc_phase<TC_GELU, T, 32>(p, 1, pdl, st)
         : units == 16 ? tc_phase<TC_GELU, T, 16>(p, 1, pdl, st)
                       : cudaErrorInvalidValue;
}

// B11: TC_GELU on x, then TC_DOWN with res = x, its KS blocks each taking
// one tile of I / KS hidden units; eps is the Pallas kernel's fixed 1e-5.
template <typename T>
cudaError_t fused_mlp(const TcArgs& gelu, const TcArgs& down, int units, int ks_down, bool pdl,
                      cudaStream_t st) {
  const cudaError_t err = gelu_phase<T>(gelu, units, false, st);
  if (err != cudaSuccess) return err;
  return tc_phase<TC_DOWN, T, TC_COLS>(down, ks_down, pdl, st);
}

template <bool RMS>
cudaError_t launch_norm_qkv(const void* x, int x_bf16, const float* g, const float* b,
                            const int8_t* w_t, const float* s, const float* bias, float* out,
                            int B, int D, int N, float eps, cudaStream_t st) {
  const int NB = B <= 8 ? 8 : 16;
  const size_t smem = norm_qkv_smem(NB, D, RMS);
  if (N % QKV_COLS || D % (WARPS * 64) || smem > SMEM_MAX) return cudaErrorInvalidValue;
  const unsigned grid = N / QKV_COLS;
#define NORM_QKV(T, NB_)                                                                \
  launch<norm_qkv_tc_kernel<T, RMS, NB_>>(grid, smem, st, (const T*)x, g, b, w_t, s, bias, \
                                          out, B, D, N, eps)
  if (x_bf16)
    return NB == 8 ? NORM_QKV(__nv_bfloat16, 8) : NORM_QKV(__nv_bfloat16, 16);
  return NB == 8 ? NORM_QKV(float, 8) : NORM_QKV(float, 16);
#undef NORM_QKV
}

}  // namespace

// The wrappers (kernels/fused_layer.py, kernels/fused_mlp.py) check shapes,
// types, 16-byte alignment, 1 <= B <= 16, the contraction a multiple of 512
// (and of N % QKV_COLS == 0 for B1, B5), the tilings, and that each launch's
// shared memory fits the 227 KB a block may opt in to. h_buf is (B, I) bf16
// scratch, r_buf (B, D) f32. Each function returns the first CUDA error of
// its launches (0 on success).
extern "C" {

int ln_qkv_int8_launch(const void* x, int x_bf16, const float* g, const float* b,
                       const int8_t* w_t, const float* s, const float* bias, float* out,
                       int B, int D, int N, float eps, void* stream) {
  return (int)launch_norm_qkv<false>(x, x_bf16, g, b, w_t, s, bias, out, B, D, N, eps,
                                     (cudaStream_t)stream);
}

// Shared memory bytes of one B1 (rms = 0) or B5 (rms = 1) block at B rows
// of width D: the wrapper refuses a shape whose blocks exceed SMEM_MAX.
size_t norm_qkv_int8_smem(int B, int D, int rms) {
  return norm_qkv_smem(B <= 8 ? 8 : 16, D, rms != 0);
}

int rms_qkv_int8_launch(const void* x, int x_bf16, const float* g, const int8_t* w_t,
                        const float* s, float* out, int B, int D, int N, float eps,
                        void* stream) {
  return (int)launch_norm_qkv<true>(x, x_bf16, g, nullptr, w_t, s, nullptr, out, B, D, N,
                                    eps, (cudaStream_t)stream);
}

// B2: the three tensor-core phases. tw: the hidden tile W2's scale applies
// to; ks_attn, ks_down: blocks a column slab of attn-out and down (1, 2 or
// 4); gelu_units: hidden units a TC_GELU block owns (16, 32 or 64); pdl:
// the second and third phases by programmatic dependent launch.
int attnout_ln_mlp_int8_launch(const void* a, const void* xres, int in_bf16,
                               const int8_t* wo_t, const float* so, const float* bo,
                               const float* g2, const float* be2,
                               const int8_t* w1_t, const float* s1, const float* b1,
                               const int8_t* w2_t, const float* s2, const float* b2,
                               float* r_buf, __nv_bfloat16* h_buf, float* out,
                               int B, int D, int I, int tw, float eps, int ks_attn,
                               int gelu_units, int ks_down, int pdl, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const TcArgs p1 = {a, xres, wo_t, nullptr, so, nullptr, nullptr, nullptr, bo, r_buf,
                     B, D, D, D, eps, 0};
  cudaError_t err = in_bf16 ? tc_phase<TC_ATTN_OUT, __nv_bfloat16, TC_COLS>(p1, ks_attn, false, st)
                            : tc_phase<TC_ATTN_OUT, float, TC_COLS>(p1, ks_attn, false, st);
  if (err != cudaSuccess) return (int)err;
  const TcArgs p2 = {r_buf, nullptr, w1_t, nullptr, s1, nullptr, g2, be2, b1, h_buf,
                     B, D, I, D, eps, 0};
  err = gelu_phase<float>(p2, gelu_units, pdl != 0, st);
  if (err != cudaSuccess) return (int)err;
  const TcArgs p3 = {h_buf, r_buf, w2_t, nullptr, s2, nullptr, nullptr, nullptr, b2, out,
                     B, I, D, tw, eps, 0};
  return (int)tc_phase<TC_DOWN, float, TC_COLS>(p3, ks_down, pdl != 0, st);
}

// B6: the three tensor-core phases. ks_attn, ks_down: blocks a column slab
// of attn-out and down (1, 2 or 4); glu_units: hidden units a TC_GLU block
// owns (16 or 32); pdl: the second and third phases by programmatic
// dependent launch.
int attnout_rms_glu_int8_launch(const void* a, const void* xres, int in_bf16,
                                const int8_t* wo_t, const float* so, const float* g2,
                                const int8_t* wg_t, const float* sg,
                                const int8_t* wu_t, const float* su,
                                const int8_t* wd_t, const float* sd,
                                float* r_buf, __nv_bfloat16* h_buf, float* out,
                                int B, int D, int I, int tw, float eps, int ks_attn,
                                int glu_units, int ks_down, int pdl, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const TcArgs p1 = {a, xres, wo_t, nullptr, so, nullptr, nullptr, nullptr, nullptr, r_buf,
                     B, D, D, D, eps, 0};
  cudaError_t err = in_bf16 ? tc_phase<TC_ATTN_OUT, __nv_bfloat16, TC_COLS>(p1, ks_attn, false, st)
                            : tc_phase<TC_ATTN_OUT, float, TC_COLS>(p1, ks_attn, false, st);
  if (err != cudaSuccess) return (int)err;
  const TcArgs p2 = {r_buf, nullptr, wg_t, wu_t, sg, su, g2, nullptr, nullptr, h_buf,
                     B, D, I, D, eps, 0};
  err = glu_units == 32   ? tc_phase<TC_GLU, float, 64>(p2, 1, pdl != 0, st)
        : glu_units == 16 ? tc_phase<TC_GLU, float, 32>(p2, 1, pdl != 0, st)
                          : cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  const TcArgs p3 = {h_buf, r_buf, wd_t, nullptr, sd, nullptr, nullptr, nullptr, nullptr, out,
                     B, I, D, tw, eps, 0};
  return (int)tc_phase<TC_DOWN, float, TC_COLS>(p3, ks_down, pdl != 0, st);
}

// B11: out (x's type) = x + MLP(LN(x)); gelu_units and ks_down as B2's, the
// down phase by programmatic dependent launch with pdl.
int fused_mlp_int8_launch(const void* x, int x_bf16, const float* g, const float* b,
                          const int8_t* w1_t, const float* s1, const float* b1,
                          const int8_t* w2_t, const float* s2, const float* b2,
                          __nv_bfloat16* h_buf, void* out, int B, int D, int I, int gelu_units,
                          int ks_down, int pdl, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (ks_down < 1 || I % ks_down) return (int)cudaErrorInvalidValue;
  const TcArgs gelu = {x, nullptr, w1_t, nullptr, s1, nullptr, g, b, b1, h_buf,
                       B, D, I, D, 1e-5f, 0};
  const TcArgs down = {h_buf, x, w2_t, nullptr, s2, nullptr, nullptr, nullptr, b2, out,
                       B, I, D, I / ks_down, 1e-5f, 1};
  if (x_bf16)
    return (int)fused_mlp<__nv_bfloat16>(gelu, down, gelu_units, ks_down, pdl != 0, st);
  return (int)fused_mlp<float>(gelu, down, gelu_units, ks_down, pdl != 0, st);
}

}  // extern "C"
