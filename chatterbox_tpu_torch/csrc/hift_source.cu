// HiFT's harmonic source, f0 to the tanh, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes the source in plain jnp
// (chatterbox_tpu/models/s3gen/hift.py, hift_source, whose phase is a
// jnp.cumsum over every sample). The port's plain version
// (chatterbox_tpu_torch/models/s3gen/hift.py) sums the phase in float64
// with torch.cumsum along the sample axis; on the card that is ATen's
// outer-dim scan, one thread to each (row, harmonic) walking every sample
// in series, about 8 ms an audio second.
//
// For row b, harmonic h = 1..9, mel frame k and sample t = frame * k + j:
//   x_k   = fl32(fl32(f0_k * h) * fl32(1 / sr))   (torch's f32 product, and
//           its division by a Python scalar on the card, which multiplies
//           by the scalar's f32 reciprocal)
//   C_k   = frac(carry + frac(sum over k' < k of frac(frame * x_k')))
//   r_t   = fl32(frac(C_k + (j + 1) * x_k))       (float64, then rounded)
//   sine  = fl32(0.1) * sinf(fl32(2 pi) * r_t + phase_h)   (phase_1 = 0)
//   uv    = f0_k > threshold
//   v_h   = sine * uv + amp(uv) * noise[t, h]
//   s_t   = tanhf(sum_h w_h v_h + bias)
// f0 repeats over the frame's samples, so the phase inside a frame is the
// closed form above and only the frames are scanned. Every term
// frac(480 * x) and every partial sum kept mod 1 lies in [0, 1) on the grid
// of 32 times the smallest x's ulp (480 = 32 * 15), which is 2^-52 or
// coarser for any x >= 2^-34 (an f0 above 1.4e-6 Hz): each sum of two is
// exact in float64, so the frame scan's bits do not depend on its order or
// on how it is split. The carry is added once, rounded once. The float32 operations are written as
// __fmul_rn / __fadd_rn so that nvcc contracts none of them into an fma:
// each rounds where torch's separate operations round. sinf and tanhf are
// the accurate functions (no fast math).
//
// What bounds it: a sample reads 9 noise floats (36 B) and writes one
// (4 B), about 0.96 MB an audio second; 0.3 us an audio second at 3.35
// TB/s. Two launches on one stream:
//   * frame_scan_kernel, one block a row: each thread sums a run of frames
//     mod 1, the runs' sums are scanned by warp shuffles and across the
//     warps in shared memory, and each thread writes its frames' starts C
//     (B, T, 9) float64.
//   * source_kernel, grid (samples / 256, B): a block stages its 256
//     samples' noise in shared memory, consecutive threads reading
//     consecutive floats of a contiguous noise (any strides are taken),
//     then each thread makes its sample from the shared words (stride 9,
//     no bank conflicts), the frame's start and f0.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HARMONICS = 9;        // NB_HARMONICS + 1, the fundamental first
constexpr int SCAN_THREADS = 256;
constexpr int SCAN_WARPS = SCAN_THREADS / 32;
constexpr int SAMPLE_THREADS = 256;

__device__ __forceinline__ double frac(double v) { return v - floor(v); }

// torch's f0 * h / sr on the card: the f32 product, then the f32 reciprocal
__device__ __forceinline__ float harmonic_step(float f0, int h, float inv_sr) {
  return __fmul_rn(__fmul_rn(f0, (float)(h + 1)), inv_sr);
}

__global__ void __launch_bounds__(SCAN_THREADS)
frame_scan_kernel(const float* __restrict__ f0, const double* __restrict__ carry,
                  double* __restrict__ start, int T, int frame, float inv_sr) {
  const int b = blockIdx.x;
  const float* f = f0 + (int64_t)b * T;
  const int per = (T + SCAN_THREADS - 1) / SCAN_THREADS;
  const int k0 = min(T, (int)threadIdx.x * per), k1 = min(T, k0 + per);
  const double fr = (double)frame;

  double s[HARMONICS];
#pragma unroll
  for (int h = 0; h < HARMONICS; ++h) s[h] = 0.0;
  for (int k = k0; k < k1; ++k) {
    const float p = f[k];
#pragma unroll
    for (int h = 0; h < HARMONICS; ++h)
      s[h] = frac(s[h] + frac(fr * (double)harmonic_step(p, h, inv_sr)));
  }

  // exclusive scan of the runs' sums, mod 1 (exact, so any order)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int h = 0; h < HARMONICS; ++h) {
      const double o = __shfl_up_sync(0xffffffffu, s[h], d);
      if (lane >= d) s[h] = frac(s[h] + o);
    }
  }
  __shared__ double warp_sum[HARMONICS][SCAN_WARPS];
  if (lane == 31) {
#pragma unroll
    for (int h = 0; h < HARMONICS; ++h) warp_sum[h][warp] = s[h];
  }
  __syncthreads();
  double e[HARMONICS];
#pragma unroll
  for (int h = 0; h < HARMONICS; ++h) {
    const double incl_before = __shfl_up_sync(0xffffffffu, s[h], 1);
    double acc = lane ? incl_before : 0.0;
    for (int w = 0; w < warp; ++w) acc = frac(acc + warp_sum[h][w]);
    e[h] = acc;
  }

  double c[HARMONICS];
#pragma unroll
  for (int h = 0; h < HARMONICS; ++h) c[h] = carry ? carry[b * HARMONICS + h] : 0.0;
  double* out = start + (int64_t)b * T * HARMONICS;
  for (int k = k0; k < k1; ++k) {
    const float p = f[k];
#pragma unroll
    for (int h = 0; h < HARMONICS; ++h) {
      out[(int64_t)k * HARMONICS + h] = frac(c[h] + e[h]);
      e[h] = frac(e[h] + frac(fr * (double)harmonic_step(p, h, inv_sr)));
    }
  }
}

struct SourceArgs {
  const float* f0;          // (B, T)
  const double* start;      // (B, T, 9) frame starts C
  const float* phase;       // (B, 9) with strides phase_sb, phase_sh
  const float* noise;       // (B, T * frame, 9) with strides nsb, nst, nsh
  const float* w;           // (9,)
  const float* bias;        // (1,)
  float* out;               // (B, T * frame)
  int64_t phase_sb, phase_sh, nsb, nst, nsh;
  int T, frame;
  float inv_sr, two_pi, sine_amp, noise_std, threshold;
};

__global__ void __launch_bounds__(SAMPLE_THREADS) source_kernel(SourceArgs a) {
  const int b = blockIdx.y;
  const int64_t n = (int64_t)a.T * a.frame;
  const int64_t t0 = (int64_t)blockIdx.x * SAMPLE_THREADS;
  const int count = (int)min((int64_t)SAMPLE_THREADS, n - t0);

  __shared__ float nz[SAMPLE_THREADS * HARMONICS];
  const float* nb = a.noise + (int64_t)b * a.nsb;
  for (int i = threadIdx.x; i < count * HARMONICS; i += SAMPLE_THREADS) {
    const int q = i / HARMONICS, h = i - q * HARMONICS;
    nz[i] = nb[(t0 + q) * a.nst + h * a.nsh];
  }
  __syncthreads();
  if ((int)threadIdx.x >= count) return;

  const int64_t t = t0 + threadIdx.x;
  const int k = (int)(t / a.frame);
  const int j = (int)(t - (int64_t)k * a.frame);
  const float p = a.f0[(int64_t)b * a.T + k];
  const double* c = a.start + ((int64_t)b * a.T + k) * HARMONICS;
  const float uv = p > a.threshold ? 1.0f : 0.0f;
  // uv * noise_std + (1 - uv) * sine_amp / 3, the division as torch's
  // product with the f32 reciprocal (equal to the quotient for 0.1)
  const float amp = __fadd_rn(__fmul_rn(uv, a.noise_std),
                              __fmul_rn(__fmul_rn(__fsub_rn(1.0f, uv), a.sine_amp),
                                        1.0f / 3.0f));
  const double jj = (double)(j + 1);
  const float* nt = nz + threadIdx.x * HARMONICS;

  float acc = 0.0f;
#pragma unroll
  for (int h = 0; h < HARMONICS; ++h) {
    const double x = (double)harmonic_step(p, h, a.inv_sr);
    const float r = __double2float_rn(frac(__dadd_rn(c[h], __dmul_rn(jj, x))));
    float arg = __fmul_rn(a.two_pi, r);
    if (h) arg = __fadd_rn(arg, a.phase[b * a.phase_sb + h * a.phase_sh]);
    const float sine = __fmul_rn(a.sine_amp, sinf(arg));
    const float v = __fadd_rn(__fmul_rn(sine, uv), __fmul_rn(amp, nt[h]));
    acc = fmaf(v, a.w[h], acc);
  }
  a.out[(int64_t)b * n + t] = tanhf(__fadd_rn(acc, a.bias[0]));
}

}  // namespace

// f0 (B, T) f32, carry (B, 9) f64 or null, phase (B, 9) and noise (B, T *
// frame, 9) f32 with the given element strides, w (9,) and bias (1,) f32;
// start (B, T, 9) f64 scratch, out (B, T * frame) f32. Returns the CUDA
// error of the launches (0 on success).
extern "C" int hift_source_launch(const float* f0, const double* carry, const float* phase,
                                  int phase_sb, int phase_sh, const float* noise,
                                  int nsb, int nst, int nsh, const float* w,
                                  const float* bias, double* start, float* out, int B, int T,
                                  int frame, float inv_sr, float two_pi, float sine_amp,
                                  float noise_std, float threshold, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B < 1 || B > 65535 || T < 1 || frame < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = ((int64_t)T * frame + SAMPLE_THREADS - 1) / SAMPLE_THREADS;
  if (blocks > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  frame_scan_kernel<<<B, SCAN_THREADS, 0, st>>>(f0, carry, start, T, frame, inv_sr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess)
    return (int)err;
  SourceArgs a{f0, start, phase, noise, w, bias, out, phase_sb, phase_sh, nsb, nst, nsh,
               T, frame, inv_sr, two_pi, sine_amp, noise_std, threshold};
  source_kernel<<<dim3((unsigned)blocks, B), SAMPLE_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}
