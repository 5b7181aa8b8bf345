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
// Weights are stored OUT-MAJOR, (N, K) with K contiguous: the converter
// transposes the JAX (K, N) layout once. B1 and B5 share a tensor-core
// kernel with its own note (norm_qkv_tc_kernel below). The design of B2, B6
// and B11 (simple and right first; no TMA / wgmma / split-K yet):
//   * One warp owns one output column and streams its K int8 weights with
//     16-byte loads: a warp reads 512 contiguous bytes per iteration, and
//     every warp of the grid is resident at once, so all weight loads are in
//     flight together.
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
//   * The norm runs one row per warp (rows w, w + 8), with shuffle
//     reductions only. A bf16 x row is read from device memory once, into
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

// c (16 x 8, f32) += a (16 x 16, bf16, row) @ b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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
  constexpr bool STAGE = sizeof(T) == 2;   // bf16 x rows normalised in shared memory
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

  // norm rows: warp w takes rows w, w + WARPS; lane i takes entries 8i + 256j
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
    mbar_wait(&bars[0], 0);
#pragma unroll 4
    for (int i = lane * 8; i < D; i += 256) {
      load8(xr + i, v);            // in place when staged: each lane its own 8 entries
      float gv[8], bv[8];          // 16-byte loads: scalar ones conflict 8 ways
      load8(gb + i, gv);
      if (!RMS) load8(gb + D + i, bv);
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
// alignment, 1 <= B <= 16, K % K_STEP == 0, N % QKV_COLS == 0 (B1, B5),
// tw % K_STEP == 0 and I % tw == 0, and that each launch's shared memory
// fits the 227 KB a block may opt in to. h_buf is (B, I) bf16 scratch, r_buf
// (B, D) f32. B11's out has x's type. Each function returns the first CUDA
// error of its launches (0 on success).
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
