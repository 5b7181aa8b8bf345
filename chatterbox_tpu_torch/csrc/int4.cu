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
// B8 and B9 run a tensor-core kernel with its own note (int4_tc_kernel
// below). The design of B10 (B2's first one, simple and right first; no
// TMA, no tensor cores):
//   * Packed weights and scales are stored OUT-MAJOR (every int4 kernel):
//     (N, K/2) bytes and (N, G) scales for the row split, (N/2, K) and
//     (N/2, G) for the column split. One warp owns one output column (phase
//     2: one packed column, i.e. hidden units c and c + I/2) and streams its
//     bytes with 16-byte loads, 512 bytes a warp per iteration.
//   * 16 packed bytes are 16 rows of one 256-row group, so a lane scales
//     its partial sums per load; the high nibble comes from the signed byte
//     by an arithmetic shift, the low one as ((b & 15) ^ 8) - 8.
//   * Phase 2 recomputes the LayerNorm rows in every block, as B1's first
//     design did; B10 is three launches on one stream, as B2 is:
//     attn-out + residual, LN2 + fc_in + gelu, fc_out + residual, with r
//     (f32) and h (bf16) in global scratch.

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

// ---------------------------------------------------------------------------
// B8 and B9 on the tensor cores (int4_tc_kernel, one template; LN selects
// B9). Bound: the packed bytes and scales, 1.05 MB for B8 at K = 4096,
// N = 1024 (0.31 us at 3.35 TB/s), 1.62 MB for B9 at D = 1024, N = 3072
// (0.49 us), at every row count (B8 1-8, B9 1-16).
//
// The first designs (one warp per output column, the rows staged as bf16 or
// normalised by every block before its first weight load, one nibble at a
// time into floats and B FMAs a nibble) took B8 7.62 us a call at 2 rows and
// 21.82 us at 8, B9 7.00 us at 1 row and 31.32 at 8 (NVIDIA H100 80GB HBM3,
// 700 W power limit; chip_smoke.py phase 3). This design is B1 / B5's:
//   * A block owns COLS output columns and 1 / KS of the packed rows. At
//     entry one thread starts the bulk copies (TMA) of its packed slab (one
//     copy when KS = 1: out-major columns are contiguous; else one a column)
//     and of the columns' lo and hi scales (and B9's LayerNorm g and b), on
//     two mbarriers. While they fly the block stages x's two halves as bf16
//     (16-byte loads, f32 rounded), or, B9, computes bf16(LN(x)) of its rows
//     (norm_rows_bf16, one warp a row, as B1): the normalised row is the two
//     halves side by side, the layout B8 stages.
//   * Nibbles become bf16 in registers, two at a time, exactly: the nibble
//     XOR 8 is put in the mantissa of 128 (0x4300) and 136 is taken off.
//   * mma.sync m16n8k16 (bf16, f32 sums): 16 columns as A, 8 rows as B (two
//     tiles for 9-16 rows), so 1 and 8 rows cost the same; B1 / B5's
//     permutation of k serves both operands (lane (g, t) reads 16 packed
//     bytes of a column, i.e. 16 low and 16 high nibbles, and the matching
//     16 bf16 of each half of the rows).
//   * The warps split the block's packed rows into contiguous runs of
//     64-row chunks. The low and high halves' MMAs accumulate in fresh
//     fragments for as long as the chunks stay in one 256-row group; each
//     takes its group's scale (s_lo, s_hi) once before it joins the warp's
//     running sum, the Pallas order of operations. The warps' sums meet in
//     shared memory and are added in warp order, B9's onto the bias (the
//     Pallas accumulator starts at the bias and takes the groups in order);
//     with KS > 1 the KS blocks of a column slab form a cluster, each writes
//     its sum into rank 0's shared memory (as B3 does), and rank 0 adds them
//     in order.
//   * The result is written in the type the caller names (f32, the Pallas
//     contract, or bf16: nn.linear's cast done in the kernel; B9 f32).
// COLS and KS come from the wrappers (int4_tiling, ln_qkv_int4_tiling, from
// chip_smoke.py's sweeps on the card). B9 takes no split: its norm needs
// every block to read whole rows.
constexpr int I4_PAD = 8;          // bf16 entries after each staged row

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

// Shared memory of one block: two barriers, g and b (B9: 2 K floats), the
// scales, the slab, NB staged rows of both halves, the warps' partial sums
// and the KS sums.
__host__ __device__ constexpr size_t int4_tc_smem(int NB, int cols, int ks, int K2, bool ln) {
  return 16 + (ln ? (size_t)4 * K2 * 4 : 0) + (size_t)2 * cols * (K2 / GROUP) * 4
         + (size_t)cols * (K2 / ks) + (size_t)NB * (2 * (K2 / ks) + I4_PAD) * 2
         + (size_t)(WARPS + ks) * NB * cols * 4;
}

// grid = N / COLS * KS in clusters of KS consecutive blocks; B <= NB (8, or
// 16 with LN); K2 / KS a multiple of 64; LN: KS = 1, g, b and bias given.
template <typename T, typename OUT, int NB, int COLS, int KS, bool LN>
__global__ void __launch_bounds__(THREADS)
int4_tc_kernel(const T* __restrict__ x, const float* __restrict__ g, const float* __restrict__ b,
               const int8_t* __restrict__ wp_t, const float* __restrict__ slo_t,
               const float* __restrict__ shi_t, const float* __restrict__ bias,
               OUT* __restrict__ out, int B, int K2, int N, float eps) {
  static_assert(!LN || KS == 1, "the norm needs the whole row");
  constexpr int RT = NB / 8, MT = COLS / 16;
  constexpr int EPT = (NB * COLS + THREADS - 1) / THREADS;    // epilogue outputs a thread
  extern __shared__ float4 smem4[];
  const int kspan = K2 / KS, G = K2 / GROUP, K = 2 * K2;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem4);        // [0] scales (g, b), [1] slab
  float* gb = reinterpret_cast<float*>(smem4 + 1);             // LN: g, then b
  float* scl = gb + (LN ? 2 * K : 0);                          // [col][group]
  float* sch = scl + COLS * G;
  int8_t* ws = reinterpret_cast<int8_t*>(sch + COLS * G);
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(ws + COLS * kspan);
  const int yld = 2 * kspan + I4_PAD;                         // low half, then high
  float* part = reinterpret_cast<float*>(ys + NB * yld);      // [warp][row][col]
  float* sums = part + WARPS * NB * COLS;                      // [rank][row][col], rank 0's

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
  // the sums' start, loaded while the copies fly: output o = tid + e *
  // THREADS is (row o / COLS, column n0 + o % COLS)
  float start[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e)
    start[e] = LN && tid + e * THREADS < NB * COLS ? bias[n0 + (tid + e * THREADS) % COLS] : 0.f;
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
  float run[MT][RT][4], alo[MT][RT][4], ahi[MT][RT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int i = 0; i < 4; ++i) run[mt][rt][i] = alo[mt][rt][i] = ahi[mt][rt][i] = 0.f;
  // the group's sums, scaled, onto the running sum; fragment entry i holds
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
          run[mt][rt][i] = __fadd_rn(run[mt][rt][i], __fadd_rn(__fmul_rn(alo[mt][rt][i], sl),
                                                               __fmul_rn(ahi[mt][rt][i], sh)));
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
      xh[rt][0] = reinterpret_cast<const uint4*>(xr + kspan)[0];
      xh[rt][1] = reinterpret_cast<const uint4*>(xr + kspan)[1];
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
          const uint32_t* xhb = reinterpret_cast<const uint32_t*>(&xh[rt][0]);
          mma_bf16_16816(alo[mt][rt], al, xlb[2 * j], xlb[2 * j + 1]);
          mma_bf16_16816(ahi[mt][rt], ah, xhb[2 * j], xhb[2 * j + 1]);
        }
      }
    }
  }
  if (c_lo < c_hi) fold(grp);

  // lane (g, t) holds columns 16 mt + g, + 8 of rows 8 rt + 2t, + 1
  float* pw = part + warp * NB * COLS;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) {
      float* q = pw + (8 * rt + 2 * tq) * COLS + 16 * mt + gq;
      q[0] = run[mt][rt][0];
      q[COLS] = run[mt][rt][1];
      q[8] = run[mt][rt][2];
      q[COLS + 8] = run[mt][rt][3];
    }
  __syncthreads();
  if (KS > 1) cluster_wait();      // every block of the cluster runs
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int o = tid + e * THREADS;
    if (o >= NB * COLS) continue;
    float sum = start[e];
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += part[w * NB * COLS + o];
    if (KS > 1) st_cluster(sums + ks * NB * COLS + o, 0, sum);
    else if (o / COLS < B) store(out + (size_t)(o / COLS) * N + n0 + o % COLS, sum);
  }
  if (KS == 1) return;
  cluster_arrive_release();
  if (ks != 0) return;
  cluster_wait();                  // every block's sum is in
  for (int o = tid; o < B * COLS; o += THREADS) {
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < KS; ++r) sum += sums[r * NB * COLS + o];
    store(out + (size_t)(o / COLS) * N + n0 + o % COLS, sum);
  }
}

template <typename T, typename OUT, int NB, int COLS, int KS, bool LN>
cudaError_t int4_tc_launch(const void* x, const float* g, const float* b, const int8_t* wp_t,
                           const float* slo_t, const float* shi_t, const float* bias, void* out,
                           int B, int K2, int N, float eps, cudaStream_t st) {
  const size_t smem = int4_tc_smem(NB, COLS, KS, K2, LN);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  return launch_ex<int4_tc_kernel<T, OUT, NB, COLS, KS, LN>>(
      N / COLS * KS, smem, KS, false, st, (const T*)x, g, b, wp_t, slo_t, shi_t, bias,
      (OUT*)out, B, K2, N, eps);
}

template <typename T, typename OUT>
cudaError_t matmul_int4_dispatch(const void* x, const int8_t* wp_t, const float* slo_t,
                                 const float* shi_t, void* out, int B, int K2, int N, int cols,
                                 int ks, cudaStream_t st) {
#define I4_TC(C, S)                                                                        \
  if (cols == C && ks == S)                                                               \
    return int4_tc_launch<T, OUT, 8, C, S, false>(x, nullptr, nullptr, wp_t, slo_t, shi_t, \
                                                  nullptr, out, B, K2, N, 0.f, st)
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
#define B9_TC(NB, C)                                                                      \
  if (B <= NB && cols == C)                                                              \
    return int4_tc_launch<T, float, NB, C, 1, true>(x, g, b, wp_t, slo_t, shi_t, bias, out, \
                                                    B, K2, N, eps, st)
  B9_TC(8, 16); B9_TC(8, 32); B9_TC(8, 64);
  B9_TC(16, 16); B9_TC(16, 32); B9_TC(16, 64);
#undef B9_TC
  return cudaErrorInvalidValue;
}

}  // namespace

// The wrappers (kernels/int4_matmul.py, kernels/fused_layer.py) check
// shapes, types, out-major contiguity, 16-byte alignment, the row counts
// (B8: 1-8; B9, B10: 1-16), that every packed half is a whole number of
// 256-row groups (B8: of 64 rows a block of a cluster), and that each
// launch's shared memory fits the 227 KB a block may opt in to. h_buf is (B, I) bf16 scratch, r_buf (B, D) f32. Each
// function returns the first CUDA error of its launches (0 on success).
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
