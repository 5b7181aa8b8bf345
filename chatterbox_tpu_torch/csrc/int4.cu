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
// All three run one tensor-core kernel (int4_tc_kernel below, with its own
// note), B10 as three launches of it.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int GROUP = 256;                 // rows per scale group

// ---------------------------------------------------------------------------
// B8, B9 and B10's three phases on the tensor cores (int4_tc_kernel, one
// template; MODE selects the function):
//   I4_MATMUL  B8:  out = x @ W (row split)
//   I4_LN      B9:  out = bias + bf16(LN(x)) @ W (row split)
//   I4_ATTN    B10 attn-out: r = (res + bf16(x) @ Wo) + bias
//   I4_FC_IN   B10 LN2 + fc_in: packed column c gives hidden units c (low
//              nibbles) and c + N (high), both over y = bf16(LN2(r)):
//              h = bf16(gelu_new(b1 + y @ W1)) (column split)
//   I4_DOWN    B10 fc_out: out = (r + b2) + h @ W2 (row split)
// Bound: the packed bytes and scales, 1.05 MB for B8 at K = 4096, N = 1024
// (0.31 us at 3.35 TB/s), 1.62 MB for B9 at D = 1024, N = 3072 (0.49 us),
// 4.86 MB for B10 at D = 1024, I = 4096 (1.45 us), at every row count (B8
// 1-8, B9 and B10 1-16).
//
// The first designs (one warp per output column on the CUDA cores, the rows
// staged as bf16 or normalised by every block before its first weight load,
// one nibble at a time into floats and B FMAs a nibble; B10's three launches
// in strict series) took B8 7.62 us a call at 2 rows and 21.82 us at 8, B9
// 7.00 us at 1 row and 31.32 at 8, B10 16.73 us at 1 row and 111.20 at 16
// (NVIDIA H100 80GB HBM3, 700 W power limit; chip_smoke.py phase 3). This
// design is B1 / B5's:
//   * A block owns COLS output columns (I4_FC_IN: COLS packed columns, i.e.
//     2 COLS hidden units) and 1 / KS of the packed rows. At entry one
//     thread starts the bulk copies (TMA) of its packed slab (one copy when
//     KS = 1: out-major columns are contiguous; else one a column) and of
//     the columns' lo and hi scales (and the LayerNorm's g and b), on two
//     mbarriers. While they fly the block stages x's two halves as bf16
//     (16-byte loads, f32 rounded), or, I4_LN and I4_FC_IN, computes
//     bf16(LN(x)) of its rows (norm_rows_bf16, one warp a row, as B1): the
//     normalised row is the two halves side by side, the layout B8 stages,
//     or, column split, the one row both nibbles of a byte meet.
//   * Nibbles become bf16 in registers, two at a time, exactly: the nibble
//     XOR 8 is put in the mantissa of 128 (0x4300) and 136 is taken off.
//   * mma.sync m16n8k16 (bf16, f32 sums): 16 columns as A, 8 rows as B (two
//     tiles for 9-16 rows), so 1 and 8 rows cost the same; B1 / B5's
//     permutation of k serves both operands (lane (g, t) reads 16 packed
//     bytes of a column, i.e. 16 low and 16 high nibbles, and the matching
//     16 bf16 of each half of the rows, or, column split, of the one row:
//     the low nibbles' MMA and the high nibbles' take the same B fragment).
//   * The warps split the block's packed rows into contiguous runs of
//     64-row chunks. The low and high nibbles' MMAs accumulate in fresh
//     fragments for as long as the chunks stay in one 256-row group; each
//     takes its group's scale (s_lo, s_hi) once before it joins the warp's
//     running sum, the Pallas order of operations (column split: two running
//     sums, one for each hidden unit of a packed column). The warps' sums
//     meet in shared memory and are added in warp order onto the start (B9
//     and I4_FC_IN: the bias, I4_DOWN: r + b2, as the Pallas accumulators
//     start); with KS > 1 the KS blocks of a column slab form a cluster,
//     each writes its sum into rank 0's shared memory (as B3 does), and rank
//     0 adds them in order onto the start.
//   * The result is written in the type the caller names (f32, the Pallas
//     contract, or bf16: nn.linear's cast done in the kernel; B9 f32); B10's
//     phases write r (f32), h (bf16, gelu_new of the sum) and out (f32).
//   * B10's phases call griddep_wait after their copies have started and
//     before they read the previous phase's output, so with programmatic
//     dependent launch each phase's weight stream overlaps the tail of the
//     phase before (as B2's).
// COLS and KS come from the wrappers (int4_tiling, ln_qkv_int4_tiling,
// int4_mlp_tiling, from chip_smoke.py's sweeps on the card). The norm
// phases take no split: every block must read whole rows.
constexpr int I4_PAD = 8;          // bf16 entries after each staged row

enum I4Mode : int { I4_MATMUL = 0, I4_LN = 1, I4_ATTN = 2, I4_FC_IN = 3, I4_DOWN = 4 };

__host__ __device__ constexpr bool i4_norm(int mode) { return mode == I4_LN || mode == I4_FC_IN; }

// The eight nibbles of four packed bytes as bf16 pairs: lo01 / lo23 the low
// nibbles of bytes 0, 1 and 2, 3 (the lower byte in the lower half), hi01 /
// hi23 the high ones; each value ((n & 15) ^ 8) - 8, exact.
__device__ __forceinline__ void nibbles_to_bf16(uint32_t w, uint32_t& lo01, uint32_t& lo23,
                                                uint32_t& hi01, uint32_t& hi23) {
  const uint32_t b01 = __byte_perm(w, 0, 0x4140);   // byte 0 | byte 1 << 16
  const uint32_t b23 = __byte_perm(w, 0, 0x4342);
  const __nv_bfloat162 off = __floats2bfloat162_rn(136.f, 136.f);
  const auto cvt = [off](uint32_t v) {
    const uint32_t u = (v & 0x000F000Fu) ^ 0x43084308u;     // 128 + (n ^ 8)
    const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&u), off);
    return *reinterpret_cast<const uint32_t*>(&r);
  };
  lo01 = cvt(b01);
  lo23 = cvt(b23);
  hi01 = cvt(b01 >> 4);
  hi23 = cvt(b23 >> 4);
}

// Shared memory of one block: two barriers, g and b (the norm modes: a row
// each), the scales, the slab, NB staged rows (both halves; column split:
// the one row), the warps' partial sums and the KS sums, over the block's
// outputs (2 cols a row for the column split).
__host__ __device__ constexpr size_t int4_tc_smem(int NB, int cols, int ks, int K2, int mode) {
  return 16 + (i4_norm(mode) ? (size_t)2 * (mode == I4_FC_IN ? K2 : 2 * K2) * 4 : 0)
         + (size_t)2 * cols * (K2 / GROUP) * 4 + (size_t)cols * (K2 / ks)
         + (size_t)NB * ((mode == I4_FC_IN ? 1 : 2) * (K2 / ks) + I4_PAD) * 2
         + (size_t)(WARPS + ks) * NB * (mode == I4_FC_IN ? 2 : 1) * cols * 4;
}

// grid = N / COLS * KS in clusters of KS consecutive blocks; B <= NB (8, or
// 16 but for I4_MATMUL); K2 / KS a multiple of 64; the norm modes KS = 1.
// x: (B, K) rows of type T (K = 2 K2, or K2 for the column split); res:
// I4_ATTN (B, N) of type T, I4_DOWN (B, N) f32; bias: I4_LN, I4_ATTN,
// I4_DOWN (N,), I4_FC_IN (2N,); out (B, N) of type OUT, I4_FC_IN (B, 2N).
template <int MODE, typename T, typename OUT, int NB, int COLS, int KS>
__global__ void __launch_bounds__(THREADS)
int4_tc_kernel(const T* __restrict__ x, const void* __restrict__ res,
               const float* __restrict__ g, const float* __restrict__ b,
               const int8_t* __restrict__ wp_t, const float* __restrict__ slo_t,
               const float* __restrict__ shi_t, const float* __restrict__ bias,
               OUT* __restrict__ out, int B, int K2, int N, float eps) {
  constexpr bool LN = i4_norm(MODE), COLSPLIT = MODE == I4_FC_IN;
  constexpr bool PDL = MODE == I4_ATTN || MODE == I4_FC_IN || MODE == I4_DOWN;
  static_assert(!LN || KS == 1, "the norm needs the whole row");
  constexpr int RT = NB / 8, MT = COLS / 16;
  constexpr int UNITS = COLSPLIT ? 2 * COLS : COLS;           // outputs a row
  constexpr int EPT = (NB * UNITS + THREADS - 1) / THREADS;   // epilogue outputs a thread
  using RES = std::conditional_t<MODE == I4_ATTN, T, float>;
  extern __shared__ float4 smem4[];
  const int kspan = K2 / KS, G = K2 / GROUP, K = COLSPLIT ? K2 : 2 * K2;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem4);        // [0] scales (g, b), [1] slab
  float* gb = reinterpret_cast<float*>(smem4 + 1);             // LN: g, then b
  float* scl = gb + (LN ? 2 * K : 0);                          // [col][group]
  float* sch = scl + COLS * G;
  int8_t* ws = reinterpret_cast<int8_t*>(sch + COLS * G);
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(ws + COLS * kspan);
  const int yld = (COLSPLIT ? 1 : 2) * kspan + I4_PAD;        // low half, then high
  float* part = reinterpret_cast<float*>(ys + NB * yld);      // [warp][row][unit]
  float* sums = part + WARPS * NB * UNITS;                     // [rank][row][unit], rank 0's

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ks = blockIdx.x % KS, n0 = blockIdx.x / KS * COLS, kb = ks * kspan;
  if (warp == 0) {
    if (lane == 0) {
      mbar_init(&bars[0], 1);
      mbar_init(&bars[1], 1);
      mbar_fence_init();
      mbar_expect_tx(&bars[1], COLS * kspan);
      mbar_expect_tx(&bars[0], 2 * COLS * G * 4 + (LN ? 2 * K * 4 : 0));
      bulk_load(scl, slo_t + (size_t)n0 * G, COLS * G * 4, &bars[0]);
      bulk_load(sch, shi_t + (size_t)n0 * G, COLS * G * 4, &bars[0]);
      if (LN) {
        bulk_load(gb, g, K * 4, &bars[0]);
        bulk_load(gb + K, b, K * 4, &bars[0]);
      }
    }
    __syncwarp();
    if (KS == 1) {
      if (lane == 0) bulk_load(ws, wp_t + (size_t)n0 * K2, COLS * K2, &bars[1]);
    } else {           // one copy a column, issued by the warp's lanes together
      for (int c = lane; c < COLS; c += 32)
        bulk_load(ws + c * kspan, wp_t + (size_t)(n0 + c) * K2 + kb, kspan, &bars[1]);
    }
  }
  if constexpr (PDL) {
    griddep_launch_dependents();
    griddep_wait();                // the previous phase's output (x, res) is written
  }
  // the sums' start (and I4_ATTN's residual and bias), loaded while the
  // copies fly: output o = tid + e * THREADS is (row o / UNITS, unit o %
  // UNITS: column n0 + u, or, column split, hidden unit n0 + u for u < COLS
  // and N + n0 + u - COLS above)
  float start[EPT], rv[EPT], bv[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int o = tid + e * THREADS, row = o / UNITS, u = o % UNITS;
    const bool live = o < NB * UNITS;
    start[e] = rv[e] = bv[e] = 0.f;
    if (live && MODE == I4_LN) start[e] = bias[n0 + u];
    if (live && MODE == I4_FC_IN) start[e] = bias[u < COLS ? n0 + u : N + n0 + u - COLS];
    if (live && row < B && MODE == I4_DOWN)
      start[e] = __fadd_rn(to_f32(static_cast<const RES*>(res)[(size_t)row * N + n0 + u]),
                           bias[n0 + u]);
    if (live && row < B && MODE == I4_ATTN) {
      rv[e] = to_f32(static_cast<const RES*>(res)[(size_t)row * N + n0 + u]);
      bv[e] = bias[n0 + u];
    }
  }
  if constexpr (LN) {
    __syncthreads();               // the barriers are initialised
    norm_rows_bf16<T, false>(x, gb, gb + K, &bars[0], B, NB, K, eps, ys, yld);
  } else {
    stage_rows_bf16(x + kb, K, B, NB, kspan, ys, yld);
    stage_rows_bf16(x + K2 + kb, K, B, NB, kspan, ys + kspan, yld);
  }
  __syncthreads();                 // the barriers are initialised, the rows staged
  if (KS > 1) cluster_arrive_relaxed();
  mbar_wait(&bars[0], 0);
  mbar_wait(&bars[1], 0);

  const int gq = lane >> 2, tq = lane & 3;
  const int chunks = kspan / 64, per_warp = (chunks + WARPS - 1) / WARPS;
  const int c_lo = min(warp * per_warp, chunks), c_hi = min(c_lo + per_warp, chunks);
  constexpr int MT2 = COLSPLIT ? MT : 1;
  float run[MT][RT][4], run2[MT2][RT][4], alo[MT][RT][4], ahi[MT][RT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        run[mt][rt][i] = alo[mt][rt][i] = ahi[mt][rt][i] = 0.f;
        if (COLSPLIT) run2[mt % MT2][rt][i] = 0.f;
      }
  // the group's sums, scaled, onto the running sum (column split: the low
  // nibbles' onto run, the high ones' onto run2); fragment entry i holds
  // column 16 mt + g (+ 8 for i >= 2)
  const auto fold = [&](int grp) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = 16 * mt + gq + (i >= 2 ? 8 : 0);
        const float sl = scl[col * G + grp], sh = sch[col * G + grp];
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) {
          if constexpr (COLSPLIT) {
            run[mt][rt][i] = __fadd_rn(run[mt][rt][i], __fmul_rn(alo[mt][rt][i], sl));
            run2[mt][rt][i] = __fadd_rn(run2[mt][rt][i], __fmul_rn(ahi[mt][rt][i], sh));
          } else {
            run[mt][rt][i] = __fadd_rn(run[mt][rt][i], __fadd_rn(__fmul_rn(alo[mt][rt][i], sl),
                                                                 __fmul_rn(ahi[mt][rt][i], sh)));
          }
          alo[mt][rt][i] = ahi[mt][rt][i] = 0.f;
        }
      }
  };
  int grp = c_lo < c_hi ? (kb + 64 * c_lo) / GROUP : 0;
  for (int c = c_lo; c < c_hi; ++c) {
    const int k0 = 64 * c;
    if ((kb + k0) / GROUP != grp) {
      fold(grp);
      grp = (kb + k0) / GROUP;
    }
    uint4 xl[RT][2], xh[RT][2];
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) {
      const __nv_bfloat16* xr = ys + (8 * rt + gq) * yld + k0 + 16 * tq;
      xl[rt][0] = reinterpret_cast<const uint4*>(xr)[0];
      xl[rt][1] = reinterpret_cast<const uint4*>(xr)[1];
      if constexpr (!COLSPLIT) {
        xh[rt][0] = reinterpret_cast<const uint4*>(xr + kspan)[0];
        xh[rt][1] = reinterpret_cast<const uint4*>(xr + kspan)[1];
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int8_t* wc = ws + (16 * mt + gq) * kspan + k0 + 16 * tq;
      const uint4 w0 = *reinterpret_cast<const uint4*>(wc);              // column g
      const uint4 w1 = *reinterpret_cast<const uint4*>(wc + 8 * kspan);  // column g + 8
      const uint32_t* p0 = reinterpret_cast<const uint32_t*>(&w0);
      const uint32_t* p1 = reinterpret_cast<const uint32_t*>(&w1);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t al[4], ah[4];   // columns g and g + 8, k slots 2t, 2t+1 | 2t+8, 2t+9
        nibbles_to_bf16(p0[j], al[0], al[2], ah[0], ah[2]);
        nibbles_to_bf16(p1[j], al[1], al[3], ah[1], ah[3]);
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) {
          const uint32_t* xlb = reinterpret_cast<const uint32_t*>(&xl[rt][0]);
          const uint32_t* xhb = reinterpret_cast<const uint32_t*>(COLSPLIT ? &xl[rt][0]
                                                                           : &xh[rt][0]);
          mma_bf16_16816(alo[mt][rt], al, xlb[2 * j], xlb[2 * j + 1]);
          mma_bf16_16816(ahi[mt][rt], ah, xhb[2 * j], xhb[2 * j + 1]);
        }
      }
    }
  }
  if (c_lo < c_hi) fold(grp);

  // lane (g, t) holds columns 16 mt + g, + 8 of rows 8 rt + 2t, + 1 (column
  // split: run2's units COLS further)
  float* pw = part + warp * NB * UNITS;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) {
      float* q = pw + (8 * rt + 2 * tq) * UNITS + 16 * mt + gq;
      q[0] = run[mt][rt][0];
      q[UNITS] = run[mt][rt][1];
      q[8] = run[mt][rt][2];
      q[UNITS + 8] = run[mt][rt][3];
      if constexpr (COLSPLIT) {
        q[COLS] = run2[mt][rt][0];
        q[UNITS + COLS] = run2[mt][rt][1];
        q[COLS + 8] = run2[mt][rt][2];
        q[UNITS + COLS + 8] = run2[mt][rt][3];
      }
    }
  __syncthreads();
  if (KS > 1) cluster_wait();      // every block of the cluster runs
  // output o's value from its sum
  const auto finish = [&](int e, int o, float sum) {
    const int row = o / UNITS, u = o % UNITS;
    if constexpr (MODE == I4_ATTN) {
      out[(size_t)row * N + n0 + u] = __fadd_rn(__fadd_rn(rv[e], sum), bv[e]);
    } else if constexpr (COLSPLIT) {
      const int unit = u < COLS ? n0 + u : N + n0 + u - COLS;
      out[(size_t)row * 2 * N + unit] = __float2bfloat16(gelu_new(sum));
    } else {
      store(out + (size_t)row * N + n0 + u, sum);
    }
  };
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int o = tid + e * THREADS;
    if (o >= NB * UNITS) continue;
    float sum = KS > 1 ? 0.f : start[e];
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += part[w * NB * UNITS + o];
    if (KS > 1) st_cluster(sums + ks * NB * UNITS + o, 0, sum);
    else if (o / UNITS < B) finish(e, o, sum);
  }
  if (KS == 1) return;
  cluster_arrive_release();
  if (ks != 0) return;
  cluster_wait();                  // every block's sum is in
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int o = tid + e * THREADS;
    if (o >= NB * UNITS || o / UNITS >= B) continue;
    float sum = start[e];
#pragma unroll
    for (int r = 0; r < KS; ++r) sum += sums[r * NB * UNITS + o];
    finish(e, o, sum);
  }
}

// One launch of int4_tc_kernel over N / COLS column slabs, KS blocks each
// (a cluster), after the checks of what the kernel takes.
template <int MODE, typename T, typename OUT, int NB, int COLS, int KS>
cudaError_t int4_tc_launch(const void* x, const void* res, const float* g, const float* b,
                           const int8_t* wp_t, const float* slo_t, const float* shi_t,
                           const float* bias, void* out, int B, int K2, int N, float eps,
                           bool pdl, cudaStream_t st) {
  const size_t smem = int4_tc_smem(NB, COLS, KS, K2, MODE);
  if (B < 1 || B > NB || N % COLS || K2 % GROUP || K2 % KS || (K2 / KS) % 64
      || smem > SMEM_MAX)
    return cudaErrorInvalidValue;
  return launch_ex<int4_tc_kernel<MODE, T, OUT, NB, COLS, KS>>(
      N / COLS * KS, smem, KS, pdl, st, (const T*)x, res, g, b, wp_t, slo_t, shi_t, bias,
      (OUT*)out, B, K2, N, eps);
}

template <typename T, typename OUT>
cudaError_t matmul_int4_dispatch(const void* x, const int8_t* wp_t, const float* slo_t,
                                 const float* shi_t, void* out, int B, int K2, int N, int cols,
                                 int ks, cudaStream_t st) {
#define I4_TC(C, S)                                                                         \
  if (cols == C && ks == S)                                                                \
    return int4_tc_launch<I4_MATMUL, T, OUT, 8, C, S>(x, nullptr, nullptr, nullptr, wp_t,  \
                                                      slo_t, shi_t, nullptr, out, B, K2, N, \
                                                      0.f, false, st)
  I4_TC(16, 1); I4_TC(16, 2); I4_TC(16, 4);
  I4_TC(32, 1); I4_TC(32, 2); I4_TC(32, 4);
#undef I4_TC
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t ln_qkv_int4_dispatch(const void* x, const float* g, const float* b,
                                 const int8_t* wp_t, const float* slo_t, const float* shi_t,
                                 const float* bias, float* out, int B, int K2, int N, int cols,
                                 float eps, cudaStream_t st) {
#define B9_TC(NB, C)                                                                         \
  if (B <= NB && cols == C)                                                                 \
    return int4_tc_launch<I4_LN, T, float, NB, C, 1>(x, nullptr, g, b, wp_t, slo_t, shi_t,  \
                                                     bias, out, B, K2, N, eps, false, st)
  B9_TC(8, 16); B9_TC(8, 32); B9_TC(8, 64);
  B9_TC(16, 16); B9_TC(16, 32); B9_TC(16, 64);
#undef B9_TC
  return cudaErrorInvalidValue;
}

// B10: attn-out at cols_attn columns a block, LN2 + fc_in at cols_fc_in
// packed columns, fc_out at cols_down columns and ks_down blocks a column
// slab; with pdl the second and third by programmatic dependent launch.
template <typename T>
cudaError_t int4_mlp(const void* a, const void* xres, const int8_t* wo_t, const float* so_lo,
                     const float* so_hi, const float* bo, const float* g2, const float* be2,
                     const int8_t* w1c_t, const float* s1_lo, const float* s1_hi,
                     const float* b1, const int8_t* w2_t, const float* s2_lo,
                     const float* s2_hi, const float* b2, float* r_buf, __nv_bfloat16* h_buf,
                     float* out, int B, int D, int I, float eps, int cols_attn, int cols_fc_in,
                     int cols_down, int ks_down, bool pdl, cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  const bool two = B > 8;
  const int IH = I / 2;
  cudaError_t err = cudaErrorInvalidValue;
#define ATTN(NB, C)                                                                        \
  if (two == (NB == 16) && cols_attn == C)                                                \
    err = int4_tc_launch<I4_ATTN, T, float, NB, C, 1>(a, xres, nullptr, nullptr, wo_t,     \
                                                      so_lo, so_hi, bo, r_buf, B, D / 2, D, \
                                                      eps, false, st)
  ATTN(8, 16); ATTN(8, 32); ATTN(16, 16); ATTN(16, 32);
#undef ATTN
  if (err != cudaSuccess) return err;
  err = cudaErrorInvalidValue;
#define FC_IN(NB, C)                                                                       \
  if (two == (NB == 16) && cols_fc_in == C)                                               \
    err = int4_tc_launch<I4_FC_IN, float, bf16, NB, C, 1>(r_buf, nullptr, g2, be2, w1c_t,  \
                                                         s1_lo, s1_hi, b1, h_buf, B, D, IH, \
                                                         eps, pdl, st)
  FC_IN(8, 16); FC_IN(8, 32); FC_IN(8, 64); FC_IN(16, 16); FC_IN(16, 32); FC_IN(16, 64);
#undef FC_IN
  if (err != cudaSuccess) return err;
  err = cudaErrorInvalidValue;
#define DOWN(NB, C, S)                                                                     \
  if (two == (NB == 16) && cols_down == C && ks_down == S)                                \
    err = int4_tc_launch<I4_DOWN, bf16, float, NB, C, S>(h_buf, r_buf, nullptr, nullptr,   \
                                                        w2_t, s2_lo, s2_hi, b2, out, B, IH, \
                                                        D, eps, pdl, st)
  DOWN(8, 16, 1); DOWN(8, 16, 2); DOWN(8, 16, 4); DOWN(8, 32, 1); DOWN(8, 32, 2);
  DOWN(8, 32, 4); DOWN(16, 16, 1); DOWN(16, 16, 2); DOWN(16, 16, 4); DOWN(16, 32, 1);
  DOWN(16, 32, 2); DOWN(16, 32, 4);
#undef DOWN
  return err;
}

}  // namespace

// The wrappers (kernels/int4_matmul.py, kernels/fused_layer.py) check
// shapes, types, out-major contiguity, 16-byte alignment, the row counts
// (B8: 1-8; B9, B10: 1-16), that every packed half is a whole number of
// 256-row groups (and of 64 rows a block of a cluster), and that each
// launch's shared memory fits the 227 KB a block may opt in to. h_buf is
// (B, I) bf16 scratch, r_buf (B, D) f32. Each function returns the first
// CUDA error of its launches (0 on success).
extern "C" {

// B8 of B <= 8 rows: out (B, N) f32 (out_bf16 = 0) or bf16; cols (16 or
// 32) output columns and ks (1, 2 or 4) blocks a column slab.
int matmul_int4_launch(const void* x, int x_bf16, const int8_t* wp_t, const float* slo_t,
                       const float* shi_t, void* out, int out_bf16, int B, int K2, int N,
                       int cols, int ks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B < 1 || B > 8 || ks < 1 || cols < 1 || N % cols || K2 % GROUP || (K2 / ks) % 64
      || K2 % ks)
    return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  if (x_bf16)
    return (int)(out_bf16 ? matmul_int4_dispatch<bf16, bf16>(x, wp_t, slo_t, shi_t, out, B, K2, N,
                                                         cols, ks, st)
                          : matmul_int4_dispatch<bf16, float>(x, wp_t, slo_t, shi_t, out, B, K2,
                                                          N, cols, ks, st));
  return (int)(out_bf16 ? matmul_int4_dispatch<float, bf16>(x, wp_t, slo_t, shi_t, out, B, K2, N,
                                                        cols, ks, st)
                        : matmul_int4_dispatch<float, float>(x, wp_t, slo_t, shi_t, out, B, K2, N,
                                                         cols, ks, st));
}

// B9 of 1-16 rows: out (B, N) f32; cols (16, 32 or 64) output columns a
// block.
int ln_qkv_int4_launch(const void* x, int x_bf16, const float* g, const float* b,
                       const int8_t* wp_t, const float* slo_t, const float* shi_t,
                       const float* bias, float* out, int B, int D, int N, int cols, float eps,
                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int K2 = D / 2;
  if (B < 1 || B > 16 || cols < 1 || N % cols || D % 2 || K2 % GROUP)
    return (int)cudaErrorInvalidValue;
  if (x_bf16)
    return (int)ln_qkv_int4_dispatch<__nv_bfloat16>(x, g, b, wp_t, slo_t, shi_t, bias, out, B,
                                                    K2, N, cols, eps, st);
  return (int)ln_qkv_int4_dispatch<float>(x, g, b, wp_t, slo_t, shi_t, bias, out, B, K2, N,
                                          cols, eps, st);
}

// B10 of 1-16 rows: the three tensor-core phases. cols_attn (16 or 32)
// output columns an attn-out block, cols_fc_in (16, 32 or 64) packed
// columns an LN2 + fc_in block, cols_down (16 or 32) output columns and
// ks_down (1, 2 or 4) blocks a column slab of fc_out; pdl: the second and
// third phases by programmatic dependent launch.
int attnout_ln_mlp_int4_launch(const void* a, const void* xres, int in_bf16,
                               const int8_t* wo_t, const float* so_lo, const float* so_hi,
                               const float* bo, const float* g2, const float* be2,
                               const int8_t* w1c_t, const float* s1_lo, const float* s1_hi,
                               const float* b1, const int8_t* w2_t, const float* s2_lo,
                               const float* s2_hi, const float* b2, float* r_buf,
                               __nv_bfloat16* h_buf, float* out, int B, int D, int I, float eps,
                               int cols_attn, int cols_fc_in, int cols_down, int ks_down,
                               int pdl, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B < 1 || B > 16 || D % (2 * GROUP) || I % (2 * GROUP)) return (int)cudaErrorInvalidValue;
  if (in_bf16)
    return (int)int4_mlp<__nv_bfloat16>(a, xres, wo_t, so_lo, so_hi, bo, g2, be2, w1c_t, s1_lo,
                                        s1_hi, b1, w2_t, s2_lo, s2_hi, b2, r_buf, h_buf, out, B,
                                        D, I, eps, cols_attn, cols_fc_in, cols_down, ks_down,
                                        pdl != 0, st);
  return (int)int4_mlp<float>(a, xres, wo_t, so_lo, so_hi, bo, g2, be2, w1c_t, s1_lo, s1_hi,
                              b1, w2_t, s2_lo, s2_hi, b2, r_buf, h_buf, out, B, D, I, eps,
                              cols_attn, cols_fc_in, cols_down, ks_down, pdl != 0, st);
}

}  // extern "C"
