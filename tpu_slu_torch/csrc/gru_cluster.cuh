// The cluster recurrence of a GRU layer, for sm_90a: one template that every
// forward recurrence of the port instantiates. K1 (bigru_shared_fwd.cu: two
// directions, time-major, a ceil pool in the epilogue), K6 (the same file:
// K1's layer on the row-stacked gi, the ROWS flag), K2
// (bigru_trainpool_fwd.cu: K1's layer in training, with h_prev stored and
// the hash dropout before the pool), K4f (bigru_masked_fwd.cu: two
// directions, batch-major, valid lengths) and K5f (the same file: one
// direction, batch-major, valid lengths). The input projection gi = x W_ih^T
// + b_ih has run before it, on the GEMM core (bigru_gemm.cuh), over all rows
// at once.
//
// What bounds a step of a one-CTA recurrence at small B (one batch row a CTA,
// most SMs idle): the CTA reads all of W_hh (192 KB at H = 128) from shared
// memory every step, ~1,900 shared-memory cycles, ~1.0 us of a ~2.4-2.6 us
// step; two CTA barriers and the gate math make the rest. The design:
//   * a thread-block cluster of C CTAs runs each (batch tile, direction):
//     CTA c owns hidden units [c H/C, (c+1) H/C) and the r, z and n rows of
//     W_hh for them, so a tile's step runs on C SMs; the grid holds every
//     direction's clusters, so the two directions of a bidirectional layer
//     run side by side on different SMs;
//   * the slice lives in registers, read from device memory once: 8 lanes a
//     unit, each holding the three rows' float4 chunks j = lane, lane + 8, ...
//     (48 floats a thread at H = 128), so the matvec reads only h from
//     shared memory, by broadcast, and a warp's 8 distinct chunks are one
//     wavefront; the 8 lanes' partial sums meet by warp shuffles, so every
//     lane holds the unit's three gate sums and no CTA barrier is needed;
//   * lane b of a unit then runs the gate math of batch row b and sends the
//     new h to every CTA of the cluster by `st.async` into distributed
//     shared memory, double-buffered by step parity; each store's bytes
//     complete that buffer's mbarrier in the receiving CTA, which starts the
//     next step once all H x nb values have landed (cluster_sync.cuh);
//   * gi streams through a 4-step ring in shared memory by cp.async, issued
//     three steps ahead, off the chain;
//   * the same lane keeps the ceil pool's accumulator (avg with torch's
//     partial-window divisor, or max) in a register and writes the output
//     only at the pooled rate, tracking its window from step to step (no
//     division a step); the backward direction visits a window's frames
//     last to first. The pool is a template flag, so a layer without one
//     runs the plain epilogue;
//   * in training (the TRAIN flag, K2) the same lane also stores the h it
//     started the step from at its frame (K3's residuals) and drops the new
//     h at the full frame rate by the counter hash `keep_hash`, before the
//     pool; the cluster still receives the undropped h;
//   * the batch tile is the smallest of 1, 2, 4, 8 rows that keeps the
//     grid's CTAs within one wave (`pick_batch_tile`); a larger B runs
//     further waves. H <= 128 (the slice's registers are sized for it),
//     H % 4 == 0.
// Rows with valid lengths step to the tile's largest length and write zeros
// at t >= n_b (pool 1: K4f, K5f). f32 arithmetic and accumulation.
//
// The stream type TS (K1 and K2 at compute_dtype=bfloat16: bf16, as the TPU
// kernels round at pallas_gru.py:796-829 and :1196-1230): W_hh's slice is
// rounded to bf16 as it is read into its registers (kept as f32 words, so
// the matvec is the f32 one); gi stays an f32
// scratch; each lane keeps its f32 carry h for n + z (h - n), and the h it
// sends to the cluster for the next step's product is rounded to bf16 (the
// values stay f32 words, so the exchange and the inner loop are the f32
// ones); outputs and h_prev are stored rounded once, the pool (and K2's
// dropout) taken on the f32 h first. The f32 instantiations keep the
// registers and the times they had (PERF.md section 6).

#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "bigru_common.cuh"
#include "cluster_sync.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kGruMaxH = 128;   // the W_hh slice's registers are sized for H <= 128
constexpr int kUnitLanes = 8;   // lanes that share a hidden unit's matvec
constexpr int kRing = 4;        // steps of gi in flight a lane

// A layer's recurrence: direction d reads gi at gi + d * gi_dir and writes
// out[d]; strides in floats. Batch-major (B, T, .) or time-major (T, B, .)
// layouts differ only in the strides. 128 bytes: a kernel parameter past
// that made nvcc recompute the step loop's 64-bit addresses every step
// (K1 and K5f ~2% slower on an H100), so the train epilogue's fields live
// in ClusterTrainRec, the parameter of the TRAIN instantiations alone. TS is
// the streams' storage type (f32, or bf16): its pointers take the f32 ones'
// places, so neither struct grows.
template <typename TS>
struct ClusterRecT {
  const float* gi;           // x W_ih^T + b_ih: 3H floats a (row, frame)
  long long gi_dir, gi_b, gi_t;
  const long long* lengths;  // (B,) valid frames, clamped to [0, T]; null: T in every row
  const float* whh[2];       // (3H, H), torch layout
  const float* bhh[2];       // (3H)
  TS* out[2];                // H values a (row, pooled frame)
  long long out_b, out_t;
  int T, B, H;
  int pool, pool_max;        // ceil pool of `pool` frames, avg or max; 1 with lengths
};
using ClusterRec = ClusterRecT<float>;
static_assert(sizeof(ClusterRec) == 128 && sizeof(ClusterRecT<__nv_bfloat16>) == 128,
              "the recurrence's parameter stays within 128 bytes");

template <typename TS>
struct ClusterTrainRecT : ClusterRecT<TS> {
  TS* hp[2];                 // H values a (row, frame), the h each step started from
  long long hp_b, hp_t;
  uint32_t seed, thresh;     // the dropout hash's seed, round((1 - p) 2^24)
  float inv_keep;            // 1 / (1 - p)
};
using ClusterTrainRec = ClusterTrainRecT<float>;

template <bool TRAIN, typename TS = float>
using ClusterArgs = std::conditional_t<TRAIN, ClusterTrainRecT<TS>, ClusterRecT<TS>>;

// CTA c = rank in its cluster of C owns units [c H/C, (c+1) H/C) of batch
// tile (cluster % tiles) of direction (cluster / tiles), NB rows; thread u * 8
// + l holds the r, z and n rows of W_hh for unit u, float4 chunks l, l + 8,
// ... of each, in registers. Step s reads h from h_s[s & 1]; the lanes that
// run the gate math send the new h to every CTA's h_s[(s + 1) & 1] by
// st.async, whose bytes complete that buffer's mbarrier there: a CTA starts
// step s + 1 when all H x nb values of it have landed.
// POOL: a.pool > 1 (every row walks all T frames); else each step's h is
// written at its frame.
// TRAIN (no lengths; a is a ClusterTrainRec): the lane also stores the h it
// started step s from at hp[dir] (row, frame(s)), zero where the walk
// starts, and, while thresh <
// kKeepAll, writes (or pools) keep_hash(seed, salt of dir, t, row, unit) ?
// h * inv_keep : 0 at the natural frame t and global batch row: K3
// (bigru_shared_bwd.cu) regenerates the same mask from the same coordinates.
// ROWS (K6's row-stacked gi; no lengths): step s of either direction reads
// gi at s * gi_t, the backward rows being stored pre-reversed, and the r and
// z columns of the recurrent product take no b_hh (folded into gi); only
// the n column adds b_hh's, inside r * (W_hn h + b_hn). The flag keeps
// ClusterRec at its 128 bytes.
// TS: the streams' storage type (f32; bf16 for K1 and K2 at
// compute_dtype=bfloat16, W_hh then rounded to bf16 in the registers).
template <int C, int NB, bool POOL, bool TRAIN, bool ROWS = false, typename TS = float>
__global__ void __launch_bounds__(kGruMaxH / C * kUnitLanes)
    gru_cluster_kernel(const ClusterArgs<TRAIN, TS> a) {
  constexpr bool kBF = !std::is_same_v<TS, float>;
  static_assert(NB <= kUnitLanes, "one lane of a unit per batch row");
  constexpr int kJ = kGruMaxH / 4 / kUnitLanes;  // float4 chunks of a row a lane holds
  __shared__ __align__(16) float h_s[2][NB][kGruMaxH];
  __shared__ float gi_s[kRing][3][NB][kGruMaxH / C];
  __shared__ __align__(8) unsigned long long full[2];  // h_s[q] holds the next step's h
  __shared__ int n_s[NB];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();
  const int T = a.T, H = a.H;
  const int tiles = (a.B + NB - 1) / NB;
  const int dir = (int)(blockIdx.x / C) / tiles;
  const int b0 = (int)(blockIdx.x / C) % tiles * NB;
  const int nb = min(NB, a.B - b0);
  const float* __restrict__ whh = dir == 0 ? a.whh[0] : a.whh[1];
  const float* __restrict__ bhh = dir == 0 ? a.bhh[0] : a.bhh[1];
  const int Hc = H / C, H4 = H / 4;
  const int tid = threadIdx.x, u = tid / kUnitLanes, lane = tid % kUnitLanes;
  const bool unit = u < Hc;
  const int col = c * Hc + u;  // the hidden unit, in [0, H)
  const unsigned step_bytes = (unsigned)(nb * H) * 4u;

  float4 w[3][kJ];
  float bias[3];
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    bias[g] = unit && (!ROWS || g == 2) ? bhh[g * H + col] : 0.0f;
#pragma unroll
    for (int i = 0; i < kJ; ++i) {
      const int j = lane + kUnitLanes * i;
      w[g][i] = unit && j < H4
                    ? reinterpret_cast<const float4*>(whh + (size_t)(g * H + col) * H)[j]
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if constexpr (kBF) {  // the bf16 product's operand
        w[g][i] = make_float4(bf16_round(w[g][i].x), bf16_round(w[g][i].y), bf16_round(w[g][i].z),
                              bf16_round(w[g][i].w));
      }
    }
  }
  for (int e = tid; e < 2 * NB * kGruMaxH; e += blockDim.x) (&h_s[0][0][0])[e] = 0.0f;
  if (tid < NB) {
    const long long n = tid < nb ? (a.lengths ? a.lengths[b0 + tid] : T) : 0;
    n_s[tid] = (int)(n < 0 ? 0 : (n > T ? T : n));
  }
  const unsigned bar0 = smem_addr(&full[0]);  // full[q] at bar0 + 8 q
  if (tid == 0) {
    mbar_init(bar0);
    mbar_init(bar0 + 8);
    mbar_init_fence();
    mbar_expect(bar0 + 8, step_bytes);  // step 1's h
    mbar_expect(bar0, step_bytes);      // step 2's h
  }
  // h_s and full[0] of every CTA of the cluster, this one's too
  unsigned peer_h[C], peer_bar[C];
#pragma unroll
  for (int r = 0; r < C; ++r) {
    peer_h[r] = peer_addr(smem_addr(&h_s[0][0][0]), r);
    peer_bar[r] = peer_addr(bar0, r);
  }
  cluster.sync();  // every CTA's h_s is zero and its mbarriers armed before any CTA sends
  int nmax = 0;
#pragma unroll
  for (int b = 0; b < NB; ++b) nmax = max(nmax, n_s[b]);

  // lane b of a unit runs batch row b's gate math; its gi streams through a
  // ring of kRing steps in shared memory, copied kRing - 1 steps ahead
  const bool mine = unit && lane < nb;
  const int n_mine = mine ? n_s[lane] : 0;
  const int row = b0 + (mine ? lane : 0);
  const float* gib = a.gi + dir * a.gi_dir + row * a.gi_b + col;
  TS* ob = (dir == 0 ? a.out[0] : a.out[1]) + row * a.out_b + col;
  TS* hpb = nullptr;
  if constexpr (TRAIN) hpb = (dir == 0 ? a.hp[0] : a.hp[1]) + row * a.hp_b + col;
  auto frame = [&](int s) { return dir == 0 ? s : n_mine - 1 - s; };  // of step s < n_mine
  auto fetch = [&](int s) {  // step s's gi into its ring slot; zeros past the row's length
    if (mine) {
      const bool ok = s < n_mine;
      const float* g = ok ? gib + (ROWS ? s : frame(s)) * a.gi_t : gib;
#pragma unroll
      for (int k = 0; k < 3; ++k) cp_async4(&gi_s[s % kRing][k][lane][u], g + k * H, ok);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) fetch(s);
  float hprev = 0.0f;
  // the ceil pool: window wi holds frames [wi pool, wi pool + cnt), r is the
  // step's frame within it; the forward direction meets a window's frames
  // first to last, the backward last to first
  const int t_first = n_mine > 0 ? frame(0) : 0;
  int wi = POOL ? t_first / a.pool : 0;
  int r = t_first - wi * a.pool;
  int cnt = POOL ? min(a.pool, T - wi * a.pool) : 1;
  float pacc = 0.0f;    // the window's running sum or max
  unsigned parity = 0;  // of the next phase of full[1]; full[0]'s runs one step behind
  for (int s = 0; s < nmax; ++s) {
    const int p = s & 1;
    if (s > 0) {
      mbar_wait(bar0 + 8 * p, parity);  // step s's h has landed
      if (p == 0) parity ^= 1u;
      if (tid == 0) mbar_expect(bar0 + 8 * p, step_bytes);  // step s + 2's h
    }
    float acc[3][NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
#pragma unroll
      for (int g = 0; g < 3; ++g) acc[g][b] = 0.0f;
      if (unit) {
#pragma unroll
        for (int i = 0; i < kJ; ++i) {
          const int j = lane + kUnitLanes * i;
          if (j < H4) {
            const float4 h = reinterpret_cast<const float4*>(&h_s[p][b][0])[j];
#pragma unroll
            for (int g = 0; g < 3; ++g) {
              float t = w[g][i].x * h.x;
              t = fmaf(w[g][i].y, h.y, t);
              t = fmaf(w[g][i].z, h.z, t);
              t = fmaf(w[g][i].w, h.w, t);
              acc[g][b] += t;
            }
          }
        }
      }
    }
#pragma unroll
    for (int off = kUnitLanes / 2; off > 0; off /= 2)
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int g = 0; g < 3; ++g) acc[g][b] += __shfl_xor_sync(0xffffffffu, acc[g][b], off);
    cp_async_wait<kRing - 2>();  // step s's gi has landed
    if (mine) {
      float v = 0.0f;
      int t = s;  // past the row's length: a zero at frame s
      if (s < n_mine) {
        float gh[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int b = 0; b < NB; ++b)
          if (b == lane) {
#pragma unroll
            for (int g = 0; g < 3; ++g) gh[g] = acc[g][b] + bias[g];
          }
        const float* gs = &gi_s[s % kRing][0][lane][u];
        const int gstride = NB * (kGruMaxH / C);
        const float rg = sigmoid_(gs[0] + gh[0]);
        const float zg = sigmoid_(gs[gstride] + gh[1]);
        const float ng = tanhf(gs[2 * gstride] + rg * gh[2]);
        v = ng + zg * (hprev - ng);
        t = frame(s);
        if constexpr (TRAIN) hpb[t * a.hp_t] = from_f32<TS>(hprev);
        hprev = v;
      }
      if (s + 1 < nmax) {  // every row sends every step, so a step's byte count is fixed
        const unsigned off = (unsigned)(((p ^ 1) * NB + lane) * kGruMaxH + col) * 4u;
        const float hs = kBF ? bf16_round(hprev) : hprev;  // the product's operand
#pragma unroll
        for (int r = 0; r < C; ++r) st_async(peer_h[r] + off, hs, peer_bar[r] + 8 * (p ^ 1));
      }
      if constexpr (TRAIN) {
        if (a.thresh < kKeepAll)
          v = keep_hash(a.seed, dir == 0 ? kSaltF : kSaltB, t, row, col, a.thresh) ? v * a.inv_keep
                                                                                  : 0.0f;
      }
      if (POOL) {
        const bool first = dir == 0 ? r == 0 : r == cnt - 1;
        const bool last = dir == 0 ? r == cnt - 1 : r == 0;
        const float acc_v = first ? v : (a.pool_max ? fmaxf(pacc, v) : pacc + v);
        if (last) {
          ob[wi * a.out_t] = from_f32<TS>(a.pool_max ? acc_v : acc_v / (float)cnt);
        } else {
          pacc = acc_v;
        }
        if (dir == 0 && ++r == cnt) {  // the next window; only the last may be partial
          r = 0;
          ++wi;
          cnt = min(a.pool, T - wi * a.pool);
        } else if (dir != 0 && r-- == 0) {
          --wi;
          cnt = a.pool;
          r = cnt - 1;
        }
      } else {
        ob[t * a.out_t] = from_f32<TS>(v);  // zeros past the row's length
      }
    }
    fetch(s + kRing - 1);
  }
  cp_async_wait<0>();
  // frames [nmax, T) of every row of the tile, this CTA's units (lengths only)
  if (unit) {
    TS* od = dir == 0 ? a.out[0] : a.out[1];
    for (int e = lane; e < nb * (T - nmax); e += kUnitLanes) {
      const int b = e / (T - nmax), t = nmax + e % (T - nmax);
      od[(b0 + b) * a.out_b + t * a.out_t + col] = from_f32<TS>(0.0f);
    }
  }
  cluster.sync();  // no CTA leaves while a peer may still address its shared memory
}

template <int C, int NB, bool POOL, bool TRAIN, bool ROWS, typename TS>
cudaError_t launch_gru_cluster(const ClusterArgs<TRAIN, TS>& a, int ndir, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(ndir * ((a.B + NB - 1) / NB) * C));
  cfg.blockDim = dim3((unsigned)((a.H / C * kUnitLanes + 31) / 32 * 32));
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, gru_cluster_kernel<C, NB, POOL, TRAIN, ROWS, TS>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The cluster size of a layer of `ndir` directions at batch B, each rule from
// an A/B on an H100 (PERF.md section 6): one direction (K5f) takes 4 while
// 4 B CTAs fit one wave of the card's SMs, else 2 (C = 4 beat C = 2 by 13%
// at B = 16 and lost by 19% at B = 64); two directions (K1, K2, K4f) take 4
// while their 8 B CTAs fill at most three quarters of the SMs (B <= 12 on
// 132), else 2 (K1: C = 4 won by 10-11% at B = 1 to 12 and lost by 3% at
// B = 16, where 128 CTAs leave some SMs holding two; K4f with mixed
// lengths: C = 4 won by 10-11% at B = 1 and 8 and lost by 16% at B = 64;
// K2: C = 2 won by 5% at B = 16 and 19% at B = 64; tools/torch_cluster_ab.py).
inline cudaError_t gru_cluster_size(int B, int ndir, int* C) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  *C = (ndir == 1 ? 4 * B <= sms : 4 * 8 * B <= 3 * sms) ? 4 : 2;
  return cudaSuccess;
}

// The recurrence on clusters of C CTAs at the batch tile pick_batch_tile
// chooses for ndir * C CTAs a tile; POOL: a.pool > 1; TRAIN: the epilogue of
// the train forward (no lengths); ROWS: K6's row-stacked gi (no lengths); TS
// the streams' type. The rule above takes C = 4 only where that tile is one
// row, and C = 2 at any tile.
template <bool POOL, bool TRAIN, bool ROWS = false, typename TS = float>
cudaError_t gru_cluster_rec(const ClusterArgs<TRAIN, TS>& a, int ndir, int C, cudaStream_t st) {
  if (a.H % 4 != 0 || a.H > kGruMaxH || (ndir != 1 && ndir != 2) || POOL != (a.pool > 1) ||
      (POOL && a.lengths != nullptr) || ((TRAIN || ROWS) && a.lengths != nullptr) || a.pool < 1)
    return cudaErrorInvalidValue;
  int nb = 8;
  cudaError_t err = pick_batch_tile(a.B, &nb, ndir * C);
  if (err != cudaSuccess) return err;
  if (C == 4) return nb == 1 ? launch_gru_cluster<4, 1, POOL, TRAIN, ROWS, TS>(a, ndir, st) : cudaErrorInvalidValue;
  if (C != 2) return cudaErrorInvalidValue;
  switch (nb) {
    case 1:
      return launch_gru_cluster<2, 1, POOL, TRAIN, ROWS, TS>(a, ndir, st);
    case 2:
      return launch_gru_cluster<2, 2, POOL, TRAIN, ROWS, TS>(a, ndir, st);
    case 4:
      return launch_gru_cluster<2, 4, POOL, TRAIN, ROWS, TS>(a, ndir, st);
    default:
      return launch_gru_cluster<2, 8, POOL, TRAIN, ROWS, TS>(a, ndir, st);
  }
}

// A time-major bidirectional layer over natural-order parts (K1, and K2 with
// TRAIN): the GEMM core's projection of both directions into the (2, T, B,
// 3H) scratch gi, then the recurrence with the pool in its epilogue, both
// directions' clusters in one grid, on clusters of the size
// gru_cluster_size(B, 2) picks. Outputs (ceil(T/pool), B, H) a direction;
// TRAIN: hp_f and hp_b (T, B, H) and the dropout (seed, thresh, inv_keep)
// as ClusterRec's; else they are unused. TS: the parts' and the outputs'
// type (f32, or bf16: the f32 weights are then rounded to bf16 as they are
// read); the weights, the biases and gi are f32.
template <bool TRAIN, typename TS = float>
cudaError_t bigru_cluster_forward(const TS* x1, int d1, const TS* x2, int d2, const float* wih_f,
                                  const float* bih_f, const float* whh_f, const float* bhh_f,
                                  const float* wih_b, const float* bih_b, const float* whh_b,
                                  const float* bhh_b, float* gi, TS* out_f, TS* out_b,
                                  same_t<TS>* hp_f, same_t<TS>* hp_b, int T, int B, int H, int pool,
                                  int pool_max,
                                  uint32_t seed, uint32_t thresh, float inv_keep,
                                  cudaStream_t st) {
  if (H % 4 != 0 || H > kGruMaxH) return cudaErrorInvalidValue;
  int C = 4;
  cudaError_t err = gru_cluster_size(B, 2, &C);
  if (err != cudaSuccess) return err;
  err = launch_gi_proj(x1, d1, x2, d2, wih_f, bih_f, wih_b, bih_b, gi, T * B, 3 * H, 2, st);
  if (err != cudaSuccess) return err;
  ClusterArgs<TRAIN, TS> a = {};
  a.gi = gi;
  a.gi_dir = (long long)T * B * 3 * H;
  a.gi_b = 3 * H;
  a.gi_t = (long long)B * 3 * H;
  a.whh[0] = whh_f;
  a.whh[1] = whh_b;
  a.bhh[0] = bhh_f;
  a.bhh[1] = bhh_b;
  a.out[0] = out_f;
  a.out[1] = out_b;
  a.out_b = H;
  a.out_t = (long long)B * H;
  if constexpr (TRAIN) {
    a.hp[0] = hp_f;
    a.hp[1] = hp_b;
    a.hp_b = H;
    a.hp_t = (long long)B * H;
    a.seed = seed;
    a.thresh = thresh;
    a.inv_keep = inv_keep;
  }
  a.T = T;
  a.B = B;
  a.H = H;
  a.pool = pool;
  a.pool_max = pool_max;
  return pool > 1 ? gru_cluster_rec<true, TRAIN, false, TS>(a, 2, C, st)
                  : gru_cluster_rec<false, TRAIN, false, TS>(a, 2, C, st);
}

}  // namespace
