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
// and right pads are zero-filled copies of the staged window.
//
// What bounds it on this card: the f32 operations, 2 * B * t_out * F * K
// (0.82 GFLOP at B = 16 on 4 s of audio, 0.012 ms at 67 TFLOP/s), against
// 6.3 MB of input, filters and pooled output (0.002 ms at 3.35 TB/s). No
// tensor cores: the front end is held to f32, and TF32 keeps ~3 decimal
// digits.
//
// What the design does about it (a register-tiled f32 SIMT implicit GEMM):
//   * A work item is (example, tile of RT conv rows, tile of FT filters); RT
//     is a whole number of pooling windows, so no window straddles two
//     items. The grid is persistent, at most one CTA an SM: CTA c owns
//     filter tile c % nft for its whole life and walks the (example, row
//     tile) items c / nft, c / nft + grid / nft, ... The plan (RT, FT, the
//     tap split KS, the grid, the shared-memory bytes) is one pure Python
//     function, `frontend_plan` in ops/frontend_fused.py, checked here. On
//     4 s of audio it takes, on an H100, 16-filter tiles of 32 rows with the
//     taps split 16 ways at B = 1 (125 CTAs), and the whole bank in items of
//     104 rows at B = 16 (128 CTAs, one item each) and of 96 rows at B = 128
//     (~9 items a CTA).
//   * The filter tile is resident in shared memory, loaded once a CTA,
//     tap-major ([k][f]) and zero-padded to a multiple of 4 taps (80 x 404
//     floats, 135 KB with its pitch, at the flagship's whole bank); a warp
//     copies 8 taps x 4 filters at a time into a pitch whose quarter is odd,
//     so that the copies' writes fall in distinct banks.
//   * The waveform windows, (RT - 1) S + K samples an item, come through a
//     ring of two stages by cp.async (16-byte copies where S, pad and T are
//     multiples of 4), zero-filled outside [0, T): the next item's copy
//     overlaps this item's FMAs.
//   * Each thread holds 8 consecutive rows x 4 filters of accumulators (32).
//     With S % 4 == 0 (the flagship's 80) one 128-bit shared load of x covers
//     4 taps of a row (row r's window starts at r S in the staged segment),
//     and one 128-bit load of the tap-major filters covers the thread's 4
//     filters at one tap: a group of 4 taps is 12 loads for 128 FMAs. Other
//     strides read x a tap at a time (8 loads a tap for 32 FMAs).
//   * The epilogue: where one group holds the whole taps (KS = 1) and the
//     pool divides 8 (the flagship's 2), |.|, the rows at or past t_out at
//     -inf, the max over each window and the activation run in registers and
//     the pooled rows go through a shared tile to coalesced stores; else each
//     tap group's sums go to the tile, and the threads that write the pooled
//     rows add them in a fixed order first. The full-rate conv output never
//     reaches device memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kRowsT = 8;   // conv rows a thread holds
constexpr int kFiltT = 4;   // filters a thread holds: one float4 of a tap row
constexpr int kRing = 2;    // waveform windows in the cp.async ring
constexpr int kMaxThreads = 384;
constexpr size_t kSmemLimit = 232448;

struct Dims {
  int B, T, F, K, S, pad, pool, leaky;
  int t_out, t_pool;
  int RT, FT, KS;      // the plan: conv rows and filters of an item, tap groups
  int NRG, NFG, K4;    // row groups RT / 8, filter groups FT / 4, taps padded to 4
  int FP, EP;          // pitches: a tap row of the filter tile, a filter's row of the epilogue's tile
  int win, nrt, nft;   // floats of a window, row tiles of an example, filter tiles
  int vec_copy;        // 16-byte copies of the waveform
};

inline int window_floats(int RT, int S, int K4) { return ((RT - 1) * S + K4 + 3) / 4 * 4; }
inline int filter_pitch(int FT) { return FT / 4 % 2 ? FT : FT + 4; }

// Pitch of a filter's row in the epilogue's tile: the item's pooled rows where
// they are pooled in registers (KS == 1, pool 1, 2, 4 or 8), else its conv
// rows; one more, odd, against bank conflicts.
inline int tile_pitch(int RT, int KS, int pool) {
  return (KS == 1 && kRowsT % pool == 0 ? RT / pool : RT) + 1;
}

// Floats of dynamic shared memory: the filter tile, the window ring, the
// epilogue's tile (KS x FT rows: the pooled rows, or each tap group's sums).
inline size_t smem_floats(int RT, int FT, int KS, int win, int K4, int pool) {
  return (size_t)filter_pitch(FT) * K4 + (size_t)kRing * win +
         (size_t)KS * FT * tile_pitch(RT, KS, pool);
}

__device__ __forceinline__ float comp(const float4& v, int t) {
  return t == 0 ? v.x : t == 1 ? v.y : t == 2 ? v.z : v.w;
}

// Item `it`'s window into xs: samples [s0, s0 + win) of example it / nrt,
// s0 = (it % nrt) RT S - pad, zeros outside [0, T).
__device__ __forceinline__ void stage_window(float* xs, const float* __restrict__ x, const Dims& d,
                                             int it) {
  const int b = it / d.nrt, rt = it % d.nrt;
  const long long s0 = (long long)rt * d.RT * d.S - d.pad;
  const float* xb = x + (size_t)b * d.T;
  if (d.vec_copy) {
    for (int c = threadIdx.x; c < d.win / 4; c += blockDim.x) {
      const long long g = s0 + 4 * c;
      const bool ok = g >= 0 && g + 4 <= d.T;
      cp_async16(xs + 4 * c, ok ? xb + g : xb, ok);
    }
  } else {
    for (int i = threadIdx.x; i < d.win; i += blockDim.x) {
      const long long g = s0 + i;
      const bool ok = g >= 0 && g < d.T;
      cp_async4(xs + i, ok ? xb + g : xb, ok);
    }
  }
}

__device__ __forceinline__ float act(float v, int leaky) {
  return leaky ? (v >= 0.0f ? v : 0.2f * v) : fmaxf(v, 0.0f);
}

// VEC: S % 4 == 0, x read by 128-bit loads of 4 taps a row; else a tap at a
// time.
template <bool VEC>
__global__ void __launch_bounds__(kMaxThreads, 1) sinc_frontend_kernel(
    const float* __restrict__ x,     // (B, T)
    const float* __restrict__ filt,  // (F, K)
    float* __restrict__ out,         // (B, F, t_pool)
    const Dims d) {
  extern __shared__ __align__(16) float smem[];
  const int FT = d.FT, FP = d.FP, EP = d.EP, RT = d.RT, K4 = d.K4;
  float* ws = smem;                          // [K4][FP]
  float* ring = ws + (size_t)FP * K4;        // [kRing][win]
  float* tile = ring + kRing * d.win;        // [KS][FT][EP]: pooled rows, or raw sums
  const int tid = threadIdx.x, nt = blockDim.x;
  const int ftile = blockIdx.x % d.nft, per_tile = gridDim.x / d.nft;
  const int f0 = ftile * FT;
  const int n_items = d.B * d.nrt;
  int it = blockIdx.x / d.nft;
  if (it >= n_items) return;

  // the filter tile, once: a warp copies 8 taps x 4 filters at a time, so the
  // reads take 32-byte runs of 4 filter rows and, FP / 4 being odd, the
  // writes fall in 32 distinct banks; each CTA starts at another filter, so
  // that the CTAs' first reads spread over the bank's lines
  {
    const int warp = tid / 32, nwarps = nt / 32, kk = tid % 8, ff = tid % 32 / 8;
    for (int i = 0; i < FT; i += 4) {
      const int f = (i + 4 * (int)blockIdx.x) % FT + ff;
      for (int k = 8 * warp + kk; k < K4; k += 8 * nwarps) {
        const bool ok = k < d.K && f0 + f < d.F;
        cp_async4(ws + k * FP + f, ok ? filt + (size_t)(f0 + f) * d.K + k : filt, ok);
      }
    }
  }
  stage_window(ring, x, d, it);
  cp_async_commit();
  if (it + per_tile < n_items) stage_window(ring + d.win, x, d, it + per_tile);
  cp_async_commit();

  // this thread's part of the tile: rows 8 rg .. 8 rg + 7, filters 4 fc ..
  // 4 fc + 3, tap group ks
  const int fc = tid % d.NFG, rg = tid / d.NFG % d.NRG, ks = tid / (d.NFG * d.NRG);
  const bool computes = ks < d.KS;
  // this group's share of the taps: quads [g0, g1)
  const int S = d.S, KQ = K4 / 4, per = (KQ + d.KS - 1) / d.KS;
  const int g0 = min(KQ, ks * per), g1 = min(KQ, g0 + per);
  const int pool = d.pool, NP = RT / pool;  // pooled rows of an item
  const bool reg_pool = d.KS == 1 && kRowsT % pool == 0;  // pooled in registers
  const int fv = min(FT, d.F - f0);

  for (int n = 0; it < n_items; ++n, it += per_tile) {
    cp_async_wait<1>();
    __syncthreads();  // item n's window (and the filter tile) have landed
    const float* xs = ring + (n % kRing) * d.win;
    const int b = it / d.nrt, rt = it % d.nrt;
    const int r_lim = d.t_out - rt * RT;  // rows of this item inside [0, t_out)
    const int p0 = rt * NP, np = min(NP, d.t_pool - p0);
    float acc[kRowsT][kFiltT];
#pragma unroll
    for (int i = 0; i < kRowsT; ++i)
#pragma unroll
      for (int j = 0; j < kFiltT; ++j) acc[i][j] = 0.0f;
    if (computes) {
      const float* xr = xs + kRowsT * rg * S + 4 * g0;
      const float* wr = ws + (size_t)4 * g0 * FP + 4 * fc;
#pragma unroll 2
      for (int q = g0; q < g1; ++q, xr += 4, wr += 4 * FP) {
        float4 xv[kRowsT];
        if constexpr (VEC) {
#pragma unroll
          for (int i = 0; i < kRowsT; ++i) xv[i] = *reinterpret_cast<const float4*>(xr + i * S);
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float4 w = *reinterpret_cast<const float4*>(wr + t * FP);
#pragma unroll
          for (int i = 0; i < kRowsT; ++i) {
            float a;
            if constexpr (VEC) a = comp(xv[i], t);
            else a = xr[i * S + t];
            acc[i][0] = fmaf(a, w.x, acc[i][0]);
            acc[i][1] = fmaf(a, w.y, acc[i][1]);
            acc[i][2] = fmaf(a, w.z, acc[i][2]);
            acc[i][3] = fmaf(a, w.w, acc[i][3]);
          }
        }
      }
      // into the tile: where the item's sums are whole (KS == 1) and the
      // windows lie within a thread's 8 rows (pool 1, 2, 4 or 8), |.| with
      // the rows at or past t_out at -inf, pooled in registers, activated;
      // else each tap group's raw sums
#pragma unroll
      for (int j = 0; j < kFiltT; ++j) {
        float* tf = tile + ((size_t)ks * FT + kFiltT * fc + j) * EP;
        if (reg_pool) {
          float m = 0.0f;
#pragma unroll
          for (int i = 0; i < kRowsT; ++i) {
            const float v = kRowsT * rg + i < r_lim ? fabsf(acc[i][j]) : -INFINITY;
            m = (i & (pool - 1)) == 0 ? v : fmaxf(m, v);
            if ((i & (pool - 1)) == pool - 1) tf[(kRowsT * rg + i) / pool] = act(m, d.leaky);
          }
        } else {
#pragma unroll
          for (int i = 0; i < kRowsT; ++i) tf[kRowsT * rg + i] = acc[i][j];
        }
      }
    }
    __syncthreads();  // the tile is whole, and xs is free
    if (it + 2 * per_tile < n_items) stage_window(ring + (n % kRing) * d.win, x, d, it + 2 * per_tile);
    cp_async_commit();

    // the pooled rows out, neighbouring threads on neighbouring p; from the
    // raw sums: the tap groups' sum in a fixed order, |.|, the rows at or
    // past t_out out, the max over each window, the activation
    for (int e = tid; e < fv * np; e += nt) {
      const int f = e / np, p = e % np;
      float v;
      if (reg_pool) {
        v = tile[f * EP + p];
      } else {
        float m = -INFINITY;
        for (int q = 0; q < pool; ++q) {
          const int r = p * pool + q;
          if (r < r_lim) {
            float sum = 0.0f;
            for (int k = 0; k < d.KS; ++k) sum += tile[((size_t)k * FT + f) * EP + r];
            m = fmaxf(m, fabsf(sum));
          }
        }
        v = act(m, d.leaky);
      }
      out[((size_t)b * d.F + f0 + f) * d.t_pool + p0 + p] = v;
    }
  }
  cp_async_wait<0>();
}

template <bool VEC>
cudaError_t launch_frontend(const float* x, const float* filt, float* out, const Dims& d, int grid,
                            int threads, size_t smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(sinc_frontend_kernel<VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  sinc_frontend_kernel<VEC><<<grid, threads, smem, st>>>(x, filt, out, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The fused front end of B waveforms x (B, T) f32 with the filter bank filt
// (F, K) f32 (row-major, `sinc_filters`), conv stride S and padding pad, a
// ceil max pool of `pool` rows and leaky ReLU (slope 0.2; leaky == 0:
// ReLU), on the launch plan of ops/frontend_fused.py `frontend_plan`: items
// of `rows` conv rows (a multiple of 8 and of pool) and `ftile` filters (a
// multiple of 4), the taps split over `ksplit` thread groups, `grid` CTAs
// (a multiple of the filter tiles) of ksplit * rows / 8 * ftile / 4 threads
// rounded up to a warp, `smem`
// bytes of dynamic shared memory (checked against the plan's). Writes out
// (B, F, ceil(t_out / pool)) f32, t_out = (T + 2 pad - K) / S + 1 >= 1.
// Returns cudaSuccess (0), cudaErrorInvalidValue for arguments or a plan it
// does not take, or the first error of the launch; does not synchronise.
int tsl_sinc_frontend_fwd(const float* x, const float* filt, float* out, int B, int T, int F,
                          int K, int S, int pad, int pool, int leaky, int rows, int ftile,
                          int ksplit, int grid, int smem, void* stream) {
  if (B < 1 || T < 1 || F < 1 || K < 1 || S < 1 || pad < 0 || pool < 1)
    return (int)cudaErrorInvalidValue;
  const long long t_out = ((long long)T + 2LL * pad - K) / S + 1;
  if ((long long)T + 2LL * pad < K || t_out < 1) return (int)cudaErrorInvalidValue;
  Dims d;
  d.B = B;
  d.T = T;
  d.F = F;
  d.K = K;
  d.S = S;
  d.pad = pad;
  d.pool = pool;
  d.leaky = leaky;
  d.t_out = (int)t_out;
  d.t_pool = (d.t_out + pool - 1) / pool;
  d.RT = rows;
  d.FT = ftile;
  d.KS = ksplit;
  d.K4 = (K + 3) / 4 * 4;
  if (rows < kRowsT || rows % kRowsT != 0 || rows % pool != 0 || ftile < kFiltT ||
      ftile % kFiltT != 0 || ksplit < 1 || ksplit > d.K4 / 4)
    return (int)cudaErrorInvalidValue;
  d.NRG = rows / kRowsT;
  d.NFG = ftile / kFiltT;
  d.FP = filter_pitch(ftile);
  d.EP = tile_pitch(rows, ksplit, pool);
  d.win = window_floats(rows, S, d.K4);
  d.nrt = (d.t_out + rows - 1) / rows;
  d.nft = (F + ftile - 1) / ftile;
  d.vec_copy = S % 4 == 0 && pad % 4 == 0 && T % 4 == 0 && (uintptr_t)x % 16 == 0;
  const int threads = (ksplit * d.NRG * d.NFG + 31) / 32 * 32;
  const size_t bytes = sizeof(float) * smem_floats(rows, ftile, ksplit, d.win, d.K4, pool);
  if (threads > kMaxThreads || (size_t)smem != bytes || bytes > kSmemLimit || grid < d.nft ||
      grid % d.nft != 0 || (long long)B * T >= (1LL << 31) || (long long)B * F * d.t_pool >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(S % 4 == 0 ? launch_frontend<true>(x, filt, out, d, grid, threads, bytes, st)
                          : launch_frontend<false>(x, filt, out, d, grid, threads, bytes, st));
}

}  // extern "C"
