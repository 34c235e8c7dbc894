// Pieces shared by the bi-GRU kernels (K1 and K6 bigru_shared_fwd.cu, K2
// bigru_trainpool_fwd.cu, K3 bigru_shared_bwd.cu, K4f and K5f
// bigru_masked_fwd.cu): the one-CTA forward recurrence of K2 and K6 (K1's
// is the cluster recurrence of gru_cluster.cuh), the dropout hash and the
// choice of batch tile; the input projection is the GEMM core's
// (bigru_gemm.cuh). Everything is f32 with f32
// accumulation. Included by each source; the anonymous namespace gives each
// its own copy.
//
// RS (K6, the row-stacked layout): gi of both directions lives in one (T,
// 2B, 3H) array, forward rows 0:B at natural t, backward rows B:2B written
// pre-reversed (step s holds t = T - 1 - s), so that step s reads row s for
// both directions; b_hh's r and z columns are folded into b_ih at
// projection time, and only b_hh's n column stays in the recurrence, added
// to the recurrent product before the r gate multiplies it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bigru_gemm.cuh"

namespace {

__device__ __forceinline__ float sigmoid_(float x) { return 1.0f / (1.0f + expf(-x)); }

// Pitch in floats of a W_hh row in the forward recurrence's shared memory:
// 32k + 4, so that the 128-bit row loads of a step are free of bank conflicts.
__host__ __device__ inline int whh_pitch(int H) { return (H + 31) / 32 * 32 + 4; }

// Dropout keep decision of the fused train path at natural (t, b, h):
// `_keep_mask` of tpu_slu/ops/pallas_gru.py, bit for bit (two rounds of a
// murmur-style finaliser, top 24 bits against thresh = round((1-p) 2^24)).
__device__ __forceinline__ bool keep_hash(uint32_t seed, uint32_t salt, uint32_t t, uint32_t b,
                                          uint32_t h, uint32_t thresh) {
  uint32_t x = (seed ^ salt) + t * 0x9E3779B1u + b * 0x85EBCA77u + h * 0xC2B2AE3Du;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    x ^= x >> 16;
    x *= 0x7FEB352Du;
    x ^= x >> 15;
    x *= 0x846CA68Bu;
  }
  x ^= x >> 16;
  return (x >> 8) < thresh;
}

constexpr uint32_t kSaltF = 0x9E3779B9u;
constexpr uint32_t kSaltB = 0x7F4A7C15u;
constexpr uint32_t kKeepAll = 1u << 24;  // thresh for p = 0: every element kept

// Forward recurrence. One CTA per (batch tile of NB rows, direction);
// blockDim.x >= 3H. Thread j < 3H owns gate column j of the recurrent
// product and reads its W_hh row and h with 128-bit loads; h and the pool
// accumulator live in shared memory. The ceil pool runs in the epilogue of
// each step, so outputs are written at the pooled rate only.
//
// TRAIN = false: eval; avg or max pool (K6, with RS).
// TRAIN = true (K2): also stores each direction's previous-step h at natural
// t into hp (zero at the start of that direction's walk), and drops h at
// the full frame rate (kept: h / (1 - p); `keep_hash` on the natural t, the
// GLOBAL batch row and h) before the avg pool.
// RS = true (K6, eval): gi is the row-stacked (T, 2B, 3H) array; the r and z
// columns of the recurrent product take no bias (folded into gi), the n
// column takes b_hh's after the product.
template <int NB, bool TRAIN, bool RS = false>
__global__ void bigru_rec_kernel(
    const float* __restrict__ gi,  // (2, T, B, 3H); RS: (T, 2B, 3H)
    const float* __restrict__ whh_f, const float* __restrict__ bhh_f,
    const float* __restrict__ whh_b, const float* __restrict__ bhh_b,
    float* __restrict__ out_f, float* __restrict__ out_b,  // (ceil(T/pool), B, H)
    float* __restrict__ hp_f, float* __restrict__ hp_b,    // (T, B, H), TRAIN only
    int T, int B, int H, int pool, int pool_max, uint32_t seed, uint32_t thresh,
    float inv_keep) {
  extern __shared__ __align__(16) float smem[];
  const int H3 = 3 * H, HP = whh_pitch(H);
  float* w_s = smem;                // [3H][HP]
  float* h_s = w_s + H3 * HP;       // [NB][H]
  float* gh_s = h_s + NB * H;       // [NB][3H]
  float* pacc_s = gh_s + NB * H3;   // [NB][H]

  const int dir = blockIdx.y;
  const int b0 = blockIdx.x * NB;
  const int nb = min(NB, B - b0);
  const float* __restrict__ whh = dir == 0 ? whh_f : whh_b;
  const float* __restrict__ bhh = dir == 0 ? bhh_f : bhh_b;
  const float* __restrict__ gid = gi + (size_t)dir * (RS ? B : T * B) * H3;
  float* __restrict__ out = dir == 0 ? out_f : out_b;
  float* __restrict__ hp = dir == 0 ? hp_f : hp_b;
  const uint32_t salt = dir == 0 ? kSaltF : kSaltB;
  const bool drop = TRAIN && thresh < kKeepAll;
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int e = tid; e < H3 * H; e += nt) w_s[(e / H) * HP + e % H] = whh[e];
  for (int e = tid; e < NB * H; e += nt) h_s[e] = 0.0f;
  const float bj = tid < H3 && !(RS && tid < 2 * H) ? bhh[tid] : 0.0f;
  __syncthreads();

  // gate-phase elements per thread: NB*H <= kIt * nt because nt >= 3H
  constexpr int kIt = (NB + 2) / 3;
  const int H4 = H / 4;
  for (int s = 0; s < T; ++s) {
    const int t = dir == 0 ? s : T - 1 - s;
    const float* __restrict__ git = RS ? gid + ((size_t)s * 2 * B + b0) * H3
                                       : gid + ((size_t)t * B + b0) * H3;
    float gr[kIt], gz[kIt], gn[kIt];
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int e = tid + it * nt;
      if (e < nb * H) {
        const float* g = git + (e / H) * H3 + e % H;
        gr[it] = g[0];
        gz[it] = g[H];
        gn[it] = g[2 * H];
      }
    }
    if (tid < H3) {
      float acc[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) acc[b] = RS ? 0.0f : bj;
      const float4* wrow = reinterpret_cast<const float4*>(w_s + tid * HP);
#pragma unroll 4
      for (int k4 = 0; k4 < H4; ++k4) {
        const float4 w = wrow[k4];
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const float4 h = reinterpret_cast<const float4*>(h_s + b * H)[k4];
          acc[b] = fmaf(h.x, w.x, acc[b]);
          acc[b] = fmaf(h.y, w.y, acc[b]);
          acc[b] = fmaf(h.z, w.z, acc[b]);
          acc[b] = fmaf(h.w, w.w, acc[b]);
        }
      }
#pragma unroll
      for (int b = 0; b < NB; ++b)
        if (b < nb) gh_s[b * H3 + tid] = RS ? acc[b] + bj : acc[b];
    }
    __syncthreads();
    const int wi = t / pool;
    const int cnt = min(pool, T - wi * pool);  // rows of this window inside [0, T)
    const int r = t - wi * pool;
    const bool first = dir == 0 ? r == 0 : r == cnt - 1;
    const bool last = dir == 0 ? r == cnt - 1 : r == 0;
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int e = tid + it * nt;
      if (e < nb * H) {
        const int b = e / H, i = e % H;
        const float* gh = gh_s + b * H3;
        const float rg = sigmoid_(gr[it] + gh[i]);
        const float zg = sigmoid_(gz[it] + gh[H + i]);
        const float ng = tanhf(gn[it] + rg * gh[2 * H + i]);
        const float hprev = h_s[e];
        const float hn = ng + zg * (hprev - ng);
        h_s[e] = hn;
        float v = hn;
        if (TRAIN) {
          hp[((size_t)t * B + b0 + b) * H + i] = hprev;
          if (drop) v = keep_hash(seed, salt, t, b0 + b, i, thresh) ? hn * inv_keep : 0.0f;
        }
        float a = v;
        if (!first) a = pool_max ? fmaxf(pacc_s[e], v) : pacc_s[e] + v;
        if (last) {
          out[((size_t)wi * B + b0 + b) * H + i] = pool_max ? a : a / (float)cnt;
        } else {
          pacc_s[e] = a;
        }
      }
    }
    __syncthreads();
  }
}

template <int NB, bool TRAIN, bool RS>
cudaError_t launch_rec(const float* gi, const float* whh_f, const float* bhh_f,
                       const float* whh_b, const float* bhh_b, float* out_f, float* out_b,
                       float* hp_f, float* hp_b, int T, int B, int H, int pool, int pool_max,
                       uint32_t seed, uint32_t thresh, float inv_keep, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * ((size_t)3 * H * whh_pitch(H) + (size_t)NB * H * 5);
  cudaError_t err = cudaFuncSetAttribute(
      bigru_rec_kernel<NB, TRAIN, RS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int threads = (3 * H + 31) / 32 * 32;
  dim3 grid((B + NB - 1) / NB, 2);
  bigru_rec_kernel<NB, TRAIN, RS><<<grid, threads, smem, st>>>(
      gi, whh_f, bhh_f, whh_b, bhh_b, out_f, out_b, hp_f, hp_b, T, B, H, pool, pool_max, seed,
      thresh, inv_keep);
  return cudaGetLastError();
}

// The smallest batch tile of 1, 2, 4 or 8 rows whose ctas * ceil(B / tile)
// CTAs (ctas a tile: one per direction, or K5f's cluster of C) fit in one
// wave of the card's SMs: a serial step's time grows with the rows a CTA
// carries, and the CTAs run side by side.
inline cudaError_t pick_batch_tile(int B, int* nb, int ctas = 2) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  *nb = 8;
  for (int cand = 1; cand < 8; cand *= 2) {
    if (ctas * ((B + cand - 1) / cand) <= sms) {
      *nb = cand;
      break;
    }
  }
  return cudaSuccess;
}

// Input projection, then the recurrence at the batch tile pick_batch_tile
// chooses: K2 (TRAIN) and K6 (RS, the row-stacked layout, eval only).
template <bool TRAIN, bool RS = false>
cudaError_t bigru_forward(const float* x1, int d1, const float* x2, int d2, const float* wih_f,
                          const float* bih_f, const float* whh_f, const float* bhh_f,
                          const float* wih_b, const float* bih_b, const float* whh_b,
                          const float* bhh_b, float* gi_scratch, float* out_f, float* out_b,
                          float* hp_f, float* hp_b, int T, int B, int H, int pool, int pool_max,
                          uint32_t seed, uint32_t thresh, float inv_keep, cudaStream_t st) {
  static_assert(!(TRAIN && RS), "the row-stacked layout is eval only");
  cudaError_t err =
      RS ? launch_gi_proj_rs(x1, d1, x2, d2, wih_f, bih_f, bhh_f, wih_b, bih_b, bhh_b, gi_scratch,
                             T, B, 3 * H, st)
         : launch_gi_proj(x1, d1, x2, d2, wih_f, bih_f, wih_b, bih_b, gi_scratch, T * B, 3 * H, 2,
                          st);
  if (err != cudaSuccess) return err;
  int nb = 8;
  err = pick_batch_tile(B, &nb);
  if (err != cudaSuccess) return err;
#define TSL_REC(NBV)                                                                           \
  launch_rec<NBV, TRAIN, RS>(gi_scratch, whh_f, bhh_f, whh_b, bhh_b, out_f, out_b, hp_f, hp_b, \
                             T, B, H, pool, pool_max, seed, thresh, inv_keep, st)
  switch (nb) {
    case 1:
      return TSL_REC(1);
    case 2:
      return TSL_REC(2);
    case 4:
      return TSL_REC(4);
    default:
      return TSL_REC(8);
  }
#undef TSL_REC
}

}  // namespace
