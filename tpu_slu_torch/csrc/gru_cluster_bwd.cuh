// The backward cluster recurrence of a GRU layer, for sm_90a: the serial dh
// chain (phase 2) of every GRU backward of the port, K3 (bigru_shared_bwd.cu:
// two directions, time-major, the SPLIT flag), K4b and K5b
// (bigru_masked_bwd.cu: two directions or one, batch-major, valid lengths),
// beside the forward one of gru_cluster.cuh, whose plumbing it shares: the
// cluster layout, the st.async exchange on per-buffer mbarriers
// (cluster_sync.cuh) and the cp.async ring. Layouts and each direction's walk
// are parameters.
//
// A direction's chain, for batch row b at step s of its walk, frame t: with
// phase 1's gate tensor [gh_n r(1-r), z, n, r], h_prev and the cotangent dy
// at t, and d = dh + dy,
//   dn = d (1 - z)(1 - n^2), dz = d (h_prev - n) z (1 - z), dr = dn gh_n r (1 - r)
//   dgi = [dr, dz, dn] and dgh = [dr, dz, dn r] at t (3H each)
//   dh <- dgh W_hh + d z
// Frames t >= n_b get exact zeros in dgi and dgh.
//
// What bounds a step of the one-CTA chains this replaced (one CTA a batch
// tile and direction, first K4b's and K5b's, then K3's): the CTA read all of
// a direction's W_hh (192 KB at H = 128, 96 KB as bf16) from shared memory
// every step and crossed two CTA barriers, ~2.4-3.1 us a step at B = 64 on
// an H100 (this design: ~1.1 us at K5b's shapes). The design is the
// forward's, transposed:
//   * a thread-block cluster of C CTAs runs each (batch tile, direction): CTA
//     c owns hidden units [c H/C, (c+1) H/C) and, for each of its units col,
//     holds the column W_hh[:, col] (3H floats) in registers: 8 lanes a
//     unit, float4 chunks j = lane, lane + 8, ... of the column (48 floats a
//     lane at H = 128, the forward's budget);
//   * a step's product is one 3H-long dot a (unit, row): each lane reads the
//     row's whole dgh vector of the step before from shared memory by
//     broadcast, and the 8 lanes meet by warp shuffles; no CTA barrier;
//   * lane b of a unit runs row b's element math: its four gate values, dy
//     and h_prev stream through a cp.async ring kRing - 1 steps ahead of the
//     chain; it writes dgi and dgh at the row's frame, keeps dh in a
//     register and sends its unit's three dgh values to every CTA of the
//     cluster by st.async, double-buffered by step parity, each store
//     completing that buffer's mbarrier in the receiver: 3 H nb floats land
//     in each CTA a step, three times the forward's h;
//   * a row past its walk sends zeros, so every step's byte count is fixed;
//   * the sum order is fixed (chunk order, then a fixed shuffle tree) and
//     there are no float atomics, so a call repeats bit for bit; each unit's
//     sums do not depend on C.
// H <= 128 (the column's registers are sized for it), H % 4 == 0. f32
// operands and accumulation.
//
// BF (K3, K4b and K5b at compute_dtype=bfloat16, the TPU kernels' points,
// pallas_gru.py:1384-1441, :471 and :233): each unit's column of W_hh is
// rounded to bf16 as it is read into its registers (kept as f32 words, so
// the dot is the f32 one), and the dgh values a lane sends to the cluster
// for the next step's product are rounded to bf16; the dgi and dgh it stores
// for phase 3's dW, the carry and the element math stay f32. The f32
// instantiation keeps the registers and the time it had.
//
// SPLIT (K3): each direction's h_prev and cotangent are tensors of their own
// (ClusterBwdSplitRec); at bf16 h_prev stays bf16 (see there).

#pragma once

#include "gru_cluster.cuh"

namespace {

constexpr int kBwdVals = 6;  // a (row, unit)'s ring values a step: gh_n r(1-r), z, n, r, dy, h_prev

// A layer's backward chain, as ClusterRec is its forward: direction d reads
// and writes at d * <name>_dir floats past each base, row b of frame t at b *
// <name>_b + t * <name>_t; strides in floats, int (the wrappers bound every
// tensor below 2^31 elements). 128 bytes (see ClusterRec).
struct ClusterBwdRec {
  const float* gates;        // phase 1's [gh_n r(1-r), z, n, r]: 4H floats a (row, frame)
  const float* hp;           // h_prev: H floats a (row, frame)
  const float* dy;           // the cotangent: H floats a (row, frame)
  float* dgi;                // out: 3H floats a (row, frame)
  float* dgh;                // out, at dgi's offsets
  const float* whh[2];       // (3H, H), torch layout
  const long long* lengths;  // (B,) valid frames, clamped to [0, T]; null: T in every row
  int gates_dir, hp_dir, dy_dir, dg_dir;
  int gates_b, gates_t, hp_b, hp_t, dy_b, dy_t, dg_b, dg_t;
  int T, B, H;
  int up;  // bit d set: direction d's gradient walks t = 0..n_b-1 (its forward ran n_b-1..0); else n_b-1..0
};
static_assert(sizeof(ClusterBwdRec) == 128, "K4b's and K5b's parameter stays within 128 bytes");

// K3's chain (SPLIT): its caller's h_prev and cotangent of each direction are
// tensors of their own, so the record carries a base for each direction, in
// place of ClusterBwdRec's hp, dy, hp_dir and dy_dir (unused). TH is h_prev's
// type: f32, or bf16 (K3 at bf16 keeps the caller's bf16 h_prev: the ring
// copies the 4-byte word that holds a unit's value, and the lane takes its
// half; hp_b and hp_t count TH elements). Its own parameter, as
// ClusterTrainRec is the train forward's, so that ClusterBwdRec keeps its
// 128 bytes.
template <typename TH>
struct ClusterBwdSplitRec : ClusterBwdRec {
  const TH* hps[2];    // h_prev of each direction: H values a (row, frame)
  const float* dys[2]; // the cotangent of each direction: H floats a (row, frame)
};

// h_prev's type in the ring's source: bf16 for K3's bf16 chain, else f32
template <bool SPLIT, bool BF>
using BwdHp = std::conditional_t<SPLIT && BF, __nv_bfloat16, float>;
template <bool SPLIT, bool BF>
using ClusterBwdArgs = std::conditional_t<SPLIT, ClusterBwdSplitRec<BwdHp<SPLIT, BF>>, ClusterBwdRec>;

// The bf16 value at byte offset 2 hi of a 4-byte word read as a float
__device__ __forceinline__ float bf16_half(float word, unsigned hi) {
  const unsigned w = __float_as_uint(word);
  return __uint_as_float(hi ? w & 0xffff0000u : w << 16);
}

// Floats of a ring row: a CTA's units, padded to 4 past a multiple of 32 so
// that the 4 units x 8 rows of a warp fall in 32 different banks.
template <int C>
__host__ __device__ constexpr int bwd_pitch() {
  return kGruMaxH / C + 4;
}

// Floats of dynamic shared memory: the two dgh buffers and the ring.
template <int C, int NB>
__host__ __device__ constexpr int bwd_smem_floats() {
  return 2 * NB * 3 * kGruMaxH + kRing * kBwdVals * NB * bwd_pitch<C>();
}

// CTA c = rank in its cluster of C owns units [c H/C, (c+1) H/C) of batch
// tile (cluster % tiles) of direction (cluster / tiles), NB rows; thread u *
// 8 + l holds float4 chunks l, l + 8, ... of the column W_hh[:, unit u].
// Step s reads the rows' dgh of step s - 1 from dg_s[s & 1]; the lanes that
// run the element math send the step's dgh to every CTA's dg_s[(s + 1) & 1]
// by st.async, whose bytes complete that buffer's mbarrier there.
// SPLIT: K3's record (ClusterBwdSplitRec), each direction's h_prev and
// cotangent at its own base, h_prev bf16 at BF.
template <int C, int NB, bool BF = false, bool SPLIT = false>
__global__ void __launch_bounds__(kGruMaxH / C * kUnitLanes)
    gru_cluster_bwd_kernel(const ClusterBwdArgs<SPLIT, BF> a) {
  using TH = BwdHp<SPLIT, BF>;
  constexpr bool kHp16 = !std::is_same_v<TH, float>;
  static_assert(NB <= kUnitLanes, "one lane of a unit per batch row");
  constexpr int kJ = 3 * kGruMaxH / 4 / kUnitLanes;  // float4 chunks of the column a lane holds
  constexpr int kRow = 3 * kGruMaxH;                 // floats of a row's dgh in dg_s
  constexpr int kPitch = bwd_pitch<C>();
  extern __shared__ __align__(16) float smem[];
  float* dg_s = smem;                    // [2][NB][kRow]
  float* ring = smem + 2 * NB * kRow;    // [kRing][kBwdVals][NB][kPitch]
  __shared__ __align__(8) unsigned long long full[2];  // dg_s[q] holds the next step's dgh
  __shared__ int n_s[NB];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();
  const int T = a.T, H = a.H;
  const int tiles = (a.B + NB - 1) / NB;
  const int dir = (int)(blockIdx.x / C) / tiles;
  const int b0 = (int)(blockIdx.x / C) % tiles * NB;
  const int nb = min(NB, a.B - b0);
  const float* __restrict__ whh = dir == 0 ? a.whh[0] : a.whh[1];
  const bool up = (a.up >> dir) & 1;
  const int Hc = H / C, n4 = 3 * H / 4;
  const int tid = threadIdx.x, u = tid / kUnitLanes, lane = tid % kUnitLanes;
  const bool unit = u < Hc;
  const int col = c * Hc + u;  // the hidden unit, in [0, H)
  const unsigned step_bytes = (unsigned)(nb * 3 * H) * 4u;

  float4 w[kJ];
#pragma unroll
  for (int i = 0; i < kJ; ++i) {
    const int j = lane + kUnitLanes * i;
    w[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (unit && j < n4) {
      const float* wc = whh + (size_t)(4 * j) * H + col;
      w[i] = make_float4(wc[0], wc[H], wc[2 * H], wc[3 * H]);
      if constexpr (BF) {  // the bf16 product's operand
        w[i] = make_float4(bf16_round(w[i].x), bf16_round(w[i].y), bf16_round(w[i].z),
                           bf16_round(w[i].w));
      }
    }
  }
  for (int e = tid; e < 2 * NB * kRow; e += blockDim.x) dg_s[e] = 0.0f;
  if (tid < NB) {
    const long long n = tid < nb ? (a.lengths ? a.lengths[b0 + tid] : T) : 0;
    n_s[tid] = (int)(n < 0 ? 0 : (n > T ? T : n));
  }
  const unsigned bar0 = smem_addr(&full[0]);  // full[q] at bar0 + 8 q
  if (tid == 0) {
    mbar_init(bar0);
    mbar_init(bar0 + 8);
    mbar_init_fence();
    mbar_expect(bar0 + 8, step_bytes);  // the dgh step 1 reads
    mbar_expect(bar0, step_bytes);      // the dgh step 2 reads
  }
  // dg_s and full[0] of every CTA of the cluster, this one's too
  unsigned peer_dg[C], peer_bar[C];
#pragma unroll
  for (int r = 0; r < C; ++r) {
    peer_dg[r] = peer_addr(smem_addr(dg_s), r);
    peer_bar[r] = peer_addr(bar0, r);
  }
  cluster.sync();  // every CTA's dg_s is zero and its mbarriers armed before any CTA sends
  int nmax = 0;
#pragma unroll
  for (int b = 0; b < NB; ++b) nmax = max(nmax, n_s[b]);

  // lane b of a unit runs batch row b; its six values a step stream through
  // the ring, copied kRing - 1 steps ahead
  const bool mine = unit && lane < nb;
  const int n_mine = mine ? n_s[lane] : 0;
  const size_t row = (size_t)(b0 + (mine ? lane : 0));
  const float* gb = a.gates + (size_t)dir * a.gates_dir + row * a.gates_b + col;
  const float* yb;
  const TH* hb;
  unsigned hp_hi = 0;  // bf16 h_prev: the half of its 4-byte word that holds it
  if constexpr (SPLIT) {
    yb = (dir == 0 ? a.dys[0] : a.dys[1]) + row * a.dy_b + col;
    hb = (dir == 0 ? a.hps[0] : a.hps[1]) + row * a.hp_b + col;
    if constexpr (kHp16) {  // every frame's word lies at the same offset: 2 hp_t bytes is 4-aligned
      hp_hi = (reinterpret_cast<size_t>(hb) >> 1) & 1;
      hb -= hp_hi;
    }
  } else {
    yb = a.dy + (size_t)dir * a.dy_dir + row * a.dy_b + col;
    hb = a.hp + (size_t)dir * a.hp_dir + row * a.hp_b + col;
  }
  const size_t dg_row = (size_t)dir * a.dg_dir + row * a.dg_b + col;
  auto frame = [&](int s) { return up ? s : n_mine - 1 - s; };  // of step s < n_mine
  auto slot = [&](int s) { return ring + ((s % kRing) * kBwdVals * NB + lane) * kPitch + u; };
  auto fetch = [&](int s) {  // step s's values into its ring slot; zeros past the row's walk
    if (mine) {
      const bool ok = s < n_mine;
      const int t = ok ? frame(s) : 0;
      float* v = slot(s);
      const float* g = gb + (size_t)t * a.gates_t;
#pragma unroll
      for (int k = 0; k < 4; ++k) cp_async4(v + k * NB * kPitch, g + k * H, ok);
      cp_async4(v + 4 * NB * kPitch, yb + (size_t)t * a.dy_t, ok);
      cp_async4(v + 5 * NB * kPitch, reinterpret_cast<const float*>(hb + (size_t)t * a.hp_t), ok);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) fetch(s);
  float carry = 0.0f;   // d z of the row's step before
  unsigned parity = 0;  // of the next phase of full[1]; full[0]'s runs one step behind
  for (int s = 0; s < nmax; ++s) {
    const int p = s & 1;
    float acc[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[b] = 0.0f;
    if (s > 0) {  // the product dgh(s - 1) W_hh[:, col] of every row
      mbar_wait(bar0 + 8 * p, parity);  // step s - 1's dgh has landed
      if (p == 0) parity ^= 1u;
      if (tid == 0) mbar_expect(bar0 + 8 * p, step_bytes);  // the dgh step s + 2 reads
      if (unit) {
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const float4* g4 = reinterpret_cast<const float4*>(dg_s + (p * NB + b) * kRow);
#pragma unroll
          for (int i = 0; i < kJ; ++i) {
            const int j = lane + kUnitLanes * i;
            if (j < n4) {
              const float4 g = g4[j];
              float t = w[i].x * g.x;
              t = fmaf(w[i].y, g.y, t);
              t = fmaf(w[i].z, g.z, t);
              t = fmaf(w[i].w, g.w, t);
              acc[b] += t;
            }
          }
        }
      }
#pragma unroll
      for (int off = kUnitLanes / 2; off > 0; off /= 2)
#pragma unroll
        for (int b = 0; b < NB; ++b) acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], off);
    }
    cp_async_wait<kRing - 2>();  // step s's values have landed
    if (mine) {
      float dr = 0.0f, dz = 0.0f, dnr = 0.0f;  // past the row's walk: zeros to the cluster
      if (s < n_mine) {
        float prod = 0.0f;
#pragma unroll
        for (int b = 0; b < NB; ++b)
          if (b == lane) prod = acc[b];
        const float* v = slot(s);
        const int vs = NB * kPitch;
        const float rfac = v[0], z = v[vs], ng = v[2 * vs], r = v[3 * vs];
        const float d = carry + prod + v[4 * vs];
        float h_prev = v[5 * vs];
        if constexpr (kHp16) h_prev = bf16_half(h_prev, hp_hi);
        const float dn = d * (1.0f - z) * (1.0f - ng * ng);
        dz = d * (h_prev - ng) * z * (1.0f - z);
        dr = dn * rfac;
        dnr = dn * r;
        const size_t at = dg_row + (size_t)frame(s) * a.dg_t;
        float* o = a.dgi + at;
        o[0] = dr;
        o[H] = dz;
        o[2 * H] = dn;
        o = a.dgh + at;
        o[0] = dr;
        o[H] = dz;
        o[2 * H] = dnr;
        carry = d * z;
      }
      if (s + 1 < nmax) {  // every row sends every step, so a step's byte count is fixed
        const unsigned off = (unsigned)(((p ^ 1) * NB + lane) * kRow + col) * 4u;
        const unsigned gate = (unsigned)H * 4u;
        if constexpr (BF) {  // the next step's product reads dgh rounded to bf16
          dr = bf16_round(dr);
          dz = bf16_round(dz);
          dnr = bf16_round(dnr);
        }
#pragma unroll
        for (int r = 0; r < C; ++r) {
          const unsigned bar = peer_bar[r] + 8 * (p ^ 1);
          st_async(peer_dg[r] + off, dr, bar);
          st_async(peer_dg[r] + off + gate, dz, bar);
          st_async(peer_dg[r] + off + 2 * gate, dnr, bar);
        }
      }
    }
    fetch(s + kRing - 1);
  }
  cp_async_wait<0>();
  // frames [n_b, T) of every row of the tile, this CTA's units
  if (unit) {
    for (int b = 0; b < nb; ++b) {
      const size_t base = (size_t)dir * a.dg_dir + (size_t)(b0 + b) * a.dg_b + col;
      for (int t = n_s[b] + lane; t < T; t += kUnitLanes) {
        const size_t at = base + (size_t)t * a.dg_t;
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          a.dgi[at + g * H] = 0.0f;
          a.dgh[at + g * H] = 0.0f;
        }
      }
    }
  }
  cluster.sync();  // no CTA leaves while a peer may still address its shared memory
}

template <int C, int NB, bool BF, bool SPLIT>
cudaError_t launch_gru_cluster_bwd(const ClusterBwdArgs<SPLIT, BF>& a, int ndir, cudaStream_t st) {
  const int smem = (int)sizeof(float) * bwd_smem_floats<C, NB>();
  cudaError_t err = cudaFuncSetAttribute(gru_cluster_bwd_kernel<C, NB, BF, SPLIT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(ndir * ((a.B + NB - 1) / NB) * C));
  cfg.blockDim = dim3((unsigned)((a.H / C * kUnitLanes + 31) / 32 * 32));
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, gru_cluster_bwd_kernel<C, NB, BF, SPLIT>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The chain of `ndir` directions on clusters of the forward's size,
// gru_cluster_size(B, ndir), at the batch tile pick_batch_tile chooses for
// ndir * C CTAs a tile; that rule takes C = 4 only where the tile is one
// row. The forward's rule won at each shape of an A/B on an H100
// (tools/torch_cluster_ab.py): K5b's five layers at B = 64, C = 2 by 15%;
// K4b's layer at B = 64, C = 2 by 9%, and at B = 8 with mixed lengths,
// C = 4 by 5%; K3's five layers at B = 64, C = 2 by 26% (the ASR encoder's
// four by 21%), and at B = 16 within 4% either way. BF: the bf16
// instantiation, SPLIT: K3's record (see the top).
template <bool BF = false, bool SPLIT = false>
cudaError_t gru_cluster_bwd(const ClusterBwdArgs<SPLIT, BF>& a, int ndir, cudaStream_t st) {
  if (a.H % 4 != 0 || a.H > kGruMaxH || (ndir != 1 && ndir != 2)) return cudaErrorInvalidValue;
  int C = 2, nb = 8;
  cudaError_t err = gru_cluster_size(a.B, ndir, &C);
  if (err != cudaSuccess) return err;
  err = pick_batch_tile(a.B, &nb, ndir * C);
  if (err != cudaSuccess) return err;
  if (C == 4) return nb == 1 ? launch_gru_cluster_bwd<4, 1, BF, SPLIT>(a, ndir, st) : cudaErrorInvalidValue;
  switch (nb) {
    case 1:
      return launch_gru_cluster_bwd<2, 1, BF, SPLIT>(a, ndir, st);
    case 2:
      return launch_gru_cluster_bwd<2, 2, BF, SPLIT>(a, ndir, st);
    case 4:
      return launch_gru_cluster_bwd<2, 4, BF, SPLIT>(a, ndir, st);
    default:
      return launch_gru_cluster_bwd<2, 8, BF, SPLIT>(a, ndir, st);
  }
}

}  // namespace
