// Fused SincNet front end (K8), eval forward, for sm_90a: the sinc conv,
// |.|, the ceil-mode max pool over time and the activation in one launch.
//
// Replaces the TPU kernel `_mk_kernel` in tpu_slu/ops/pallas_frontend.py:45
// (`pallas_call` at :81), reached through `sinc_frontend_fused` (:159) from
// the eval branch of `_apply_stack` (tpu_slu/models/encoder.py:327-355).
// Same function: x (B, T) and the filter bank (F, K) from `sinc_filters` ->
//   out[b, f, p] = act(max over t in [p*pool, min((p+1)*pool, t_out)) of
//                      |sum_k filt[f, k] * xpad[b, t*S + k]|),
// with xpad the waveform padded by `pad` zeros on both sides and t_out =
// (T + 2 pad - K) / S + 1. The activation runs after |.| (a no-op in exact
// arithmetic, applied as the TPU kernel does). Only the POOLED rows are
// written, channels-first (B, F, t_pool), so that the 5-tap convs after it
// take them as they are; the wrapper hands out the (B, t_pool, F) view.
//
// The TPU kernel frames the waveform into (T/S, S) rows and runs nseg
// displaced matmuls over a two-spec halo, Mosaic workarounds. Here the conv
// is an implicit GEMM: since the stride is the frame width, row t of the
// im2col matrix is the contiguous window xpad[t*S : t*S + K], so A is a
// strided view of the waveform (M = B * t_out rows, depth K) and B is the
// filter bank (N = F). No padded copy and no im2col matrix is made: the left
// and right pads are index masks on the staged window.
//
// What bounds it on this card: the f32 operations, 2 * B * t_out * F * K
// (0.82 GFLOP at B = 16 on 4 s of audio, 0.012 ms at 67 TFLOP/s), against
// 6.3 MB of input, filters and pooled output (0.002 ms at 3.35 TB/s). The
// unfused composition also writes and reads back the full-rate (B, F,
// t_out) conv output and pays three more launches.
//
// What the design does about it (a plain f32 SIMT tiling; no tensor cores:
// the front end is held to f32, and TF32 keeps ~3 decimal digits):
//   * One CTA per (tile of pooled rows, example, tile of 80 filters). Its
//     conv rows come in sub-tiles of kRT = 32; pool | rows a CTA owns, so
//     no pooling window straddles two CTAs. At B = 1 the 400 pooled rows of
//     4 s give 25 CTAs.
//   * A sub-tile's window of the waveform, (kRT - 1) * S + K samples (11.5
//     KB at the flagship's S = 80, K = 401), is staged in shared memory
//     once; the filters follow in chunks of at most 80 taps x 80 filters
//     (25.9 KB), never the whole bank.
//   * 128 threads, each 4 rows x 5 filters of accumulators: per tap 9
//     shared-memory reads (broadcasts, conflict-free) for 20 FMAs.
//   * The epilogue takes |.|, masks rows at t_out with -inf, max-pools into
//     a per-CTA pooled accumulator, applies the activation and writes the
//     pooled rows, so the full-rate conv output never reaches device memory.
// Measured on an H100 SXM (700 W; PERF.md): 0.069 / 0.090 / 0.468 ms at B =
// 1 / 16 / 128 on 4 s, against 0.030 / 0.086 / 0.575 ms for cuDNN's f32 conv
// alone; with 4 warps a CTA, 25 CTAs at B = 1 leave most of the card idle.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRT = 32;       // conv rows of a sub-tile
constexpr int kFT = 80;       // filters of a CTA
constexpr int kFP = kFT + 1;  // pitch of a staged filter tap row and of the epilogue tile
constexpr int kKC = 80;       // most taps of a staged filter chunk

struct Dims {
  int T, F, K, S, pad, t_out, pool, t_pool, PR, nchunk, kc, leaky;
};

// Floats of dynamic shared memory: the waveform window, the filter chunk
// (reused by the epilogue tile), the pooled accumulator.
inline size_t smem_floats(const Dims& d) {
  return (size_t)(kRT - 1) * d.S + d.K + (size_t)kKC * kFP + (size_t)d.PR * kFT;
}

__global__ void __launch_bounds__(kThreads) sinc_frontend_kernel(
    const float* __restrict__ x,     // (B, T)
    const float* __restrict__ filt,  // (F, K)
    float* __restrict__ out,         // (B, F, t_pool)
    Dims d) {
  extern __shared__ __align__(16) float smem[];
  const int win = (kRT - 1) * d.S + d.K;
  float* xs = smem;          // [win]
  float* ws = xs + win;      // [kKC][kFP]; the epilogue's [kRT][kFP] after the taps
  float* pacc = ws + kKC * kFP;  // [PR][kFT]

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int b = blockIdx.y, f0 = blockIdx.z * kFT;
  const int p0 = blockIdx.x * d.PR;
  const int np = min(d.PR, d.t_pool - p0);       // pooled rows of this CTA
  const int r_begin = p0 * d.pool;
  const int r_end = min((p0 + np) * d.pool, d.t_out);  // conv rows of this CTA
  const float* __restrict__ xb = x + (size_t)b * d.T;

  for (int e = tid; e < d.PR * kFT; e += kThreads) pacc[e] = -INFINITY;

  for (int r0 = r_begin; r0 < r_end; r0 += kRT) {
    __syncthreads();  // the previous sub-tile is done with xs, ws and pacc
    const long long s0 = (long long)r0 * d.S - d.pad;  // x index of the window's first sample
    for (int i = tid; i < win; i += kThreads) {
      const long long g = s0 + i;
      xs[i] = (g >= 0 && g < d.T) ? __ldg(xb + g) : 0.0f;
    }
    float acc[4][5] = {};
    for (int c = 0; c < d.nchunk; ++c) {
      const int k0 = c * d.kc, klen = min(d.kc, d.K - k0);
      __syncthreads();  // the previous chunk is consumed
      for (int e = tid; e < kFT * klen; e += kThreads) {
        const int f = e / klen, kk = e % klen;
        ws[kk * kFP + f] = f0 + f < d.F ? __ldg(filt + (size_t)(f0 + f) * d.K + k0 + kk) : 0.0f;
      }
      __syncthreads();
      const float* xk = xs + k0;
#pragma unroll 4
      for (int kk = 0; kk < klen; ++kk) {
        float a[4], w[5];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xk[(ty + 8 * i) * d.S + kk];
#pragma unroll
        for (int j = 0; j < 5; ++j) w[j] = ws[kk * kFP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 5; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
    }
    // epilogue of the sub-tile: |.| with the rows past this CTA's (and t_out)
    // at -inf, then the max over each pooling window's rows in the sub-tile
    __syncthreads();
    float* ys = ws;  // [kRT][kFP]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 8 * i;
#pragma unroll
      for (int j = 0; j < 5; ++j)
        ys[r * kFP + tx + 16 * j] = r0 + r < r_end ? fabsf(acc[i][j]) : -INFINITY;
    }
    __syncthreads();
    for (int e = tid; e < np * kFT; e += kThreads) {
      const int pr = e / kFT, f = e % kFT;
      const int lo = max((p0 + pr) * d.pool, r0), hi = min((p0 + pr + 1) * d.pool, r0 + kRT);
      float m = pacc[e];
      for (int r = lo; r < hi; ++r) m = fmaxf(m, ys[(r - r0) * kFP + f]);
      pacc[e] = m;
    }
  }
  __syncthreads();
  // the activation, and the pooled rows out, neighbouring threads on neighbouring p
  for (int e = tid; e < np * kFT; e += kThreads) {
    const int f = e / np, pr = e % np;
    if (f0 + f >= d.F) continue;
    float v = pacc[pr * kFT + f];
    v = d.leaky ? (v >= 0.0f ? v : 0.2f * v) : fmaxf(v, 0.0f);
    out[((size_t)b * d.F + f0 + f) * d.t_pool + p0 + pr] = v;
  }
}

}  // namespace

extern "C" {

// The fused front end of B waveforms x (B, T) f32 with the filter bank filt
// (F, K) f32 (row-major, `sinc_filters`), conv stride S and padding pad, a
// ceil max pool of `pool` rows and leaky ReLU (slope 0.2; leaky == 0:
// ReLU). Writes out (B, F, ceil(t_out / pool)) f32, t_out = (T + 2 pad - K) /
// S + 1 >= 1. Returns cudaSuccess (0) or the first error of the launch; does
// not synchronise.
int tsl_sinc_frontend_fwd(const float* x, const float* filt, float* out, int B, int T, int F,
                          int K, int S, int pad, int pool, int leaky, void* stream) {
  if (B < 1 || T < 1 || F < 1 || K < 1 || S < 1 || pad < 0 || pool < 1)
    return (int)cudaErrorInvalidValue;
  const long long t_out = ((long long)T + 2LL * pad - K) / S + 1;
  if ((long long)T + 2LL * pad < K || t_out < 1) return (int)cudaErrorInvalidValue;
  Dims d;
  d.T = T;
  d.F = F;
  d.K = K;
  d.S = S;
  d.pad = pad;
  d.t_out = (int)t_out;
  d.pool = pool;
  d.t_pool = (d.t_out + pool - 1) / pool;
  d.PR = pool <= kRT ? kRT / pool : 1;  // pooled rows of a CTA
  d.nchunk = (K + kKC - 1) / kKC;
  d.kc = (K + d.nchunk - 1) / d.nchunk;  // taps of a chunk, as even as the chunks allow
  d.leaky = leaky;
  const size_t smem = sizeof(float) * smem_floats(d);
  cudaError_t err = cudaFuncSetAttribute(sinc_frontend_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((d.t_pool + d.PR - 1) / d.PR, B, (F + kFT - 1) / kFT);
  sinc_frontend_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(x, filt, out, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
