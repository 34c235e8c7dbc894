// Fused beam search of the seq2seq decoder (K7), for sm_90a.
//
// Replaces the TPU kernel `_mk_beam_kernel` in tpu_slu/ops/pallas_beam.py:152
// (`pallas_call` at :394), reached from `seq2seq_beam_infer` through
// `beam_decode_pallas` (:425). The whole width-W, U-step search runs in ONE
// launch: for every step, attention over the loop-invariant keys and values,
// the embedding of the previous token, the stacked GRUCells, a log-softmax
// over the L labels, the top W of the W x L extensions, and the reorder of
// the hypotheses. The search is that of tpu_slu/ops/beam.py: the previous
// token is all zeros at u = 0 (so the embedding is its bias alone), only beam
// 0's extensions compete at u = 0, U fixed steps with no EOS exit, and among
// equal extensions the smaller w * L + l ranks first (lax.top_k's order).
// Its plain version is `beam_search_reference` in tpu_slu_torch/ops/beam.py.
//
// What bounds it on this card: a beam row costs ~0.99 M FMAs a step at the
// decoder of experiments/all_real_seq2seq.cfg (2 cells of H = 256, keys 100,
// values 200, 102 labels), ~4 M at W = 4, and the U steps are a serial chain.
// On one SM that is >= 18 us a step however the loop runs; a one-CTA design
// (an earlier version of this file) took ~111 us a step, its weights
// (~4 MB) streamed from L2 by latency-bound reads, 16 of 132 SMs busy at
// B = 16. On the cluster the step is ~22 us at C = 8 on an H100, bound by
// latency, not by FMAs or bytes: by the kernel's trace (a build with
// TSL_TRACE defined, PERF.md section 6) ~11 us are the two layers'
// products (their L2 reads of the streamed slices), ~5 us the attention
// and embedding, ~4 us the log-softmax and top-W, ~2 us the head, and
// ~1.5 us the three exchange waits.
//
// The design: a thread-block cluster of C CTAs per utterance, the decoder
// split by hidden unit.
//   * CTA c owns units [c H/C, (c+1) H/C) of every cell, with their r, z and
//     n rows of w_ih and w_hh, and rows [c (K+L)/C, (c+1) (K+L)/C) of the
//     head [query | labels]. Its gate math needs no peer's data. It streams
//     only its slice of the weights (~0.5 MB at C = 8): 16 lanes a row, each
//     reading float4 chunks along the row (torch layout, rows padded to a
//     multiple of 4), the three gate rows of a unit read together so that
//     one load of an input chunk serves them all, and each weight load serves
//     up to G = 8 beams; the lanes' partial sums meet by shuffles (two rows a
//     warp, the item loops warp-uniform), r and z already summed over gi and
//     gh. The slices of as many cell matrices as fit beside the plan, the
//     biases and the keys and values stay in shared memory (w_hh from the
//     top layer down, then w_ih), copied once at the start.
//   * Each CTA sends its part of each layer's new h, and of the head's
//     outputs (the next step's query and the logits), to every CTA of the
//     cluster by st.async into distributed shared memory, counted on an
//     mbarrier a buffer (cluster_sync.cuh): nl + 1 exchange rounds a step
//     (3 at the flagship), double-buffered by step parity, no cluster
//     barrier. The query is the head of the top layer's new state, so it is
//     computed with the logits and reordered with the beams.
//   * Every CTA then runs the same attention over the valid frames (W n (K
//     + V) FMAs, small beside the cells), the same log-softmax and the same
//     top-W on the same bits, so every CTA picks the same extensions, and
//     the beams' states are reordered by an index (`org`), with no further
//     round. Rank 0 writes the result. The top-W: each beam's warp finds
//     the beam's best W extensions, and a candidate's rank among those W x W
//     places it.
//   * C from 8 down to 1: the largest whose clusters of the batch all fit on
//     the card at once (`cudaOccupancyMaxActiveClusters`), chosen by the
//     batch inside the library; C is not a template parameter, so any size
//     runs the same code, and C = 1 is the one-CTA case. Utterances past one
//     wave run in further waves.
//
// The plan (make_plan) holds, per CTA: the exchange buffers (each layer's new
// states and the head's outputs, by step parity), [embedding | context], a
// frame block's attention weights, the scores, the chosen extensions, the
// reorder index and a backpointer per step and beam. The beams' live states
// are the previous step's exchange buffer read through `org`, so nothing is
// copied at the reorder. After the last step each final beam walks its
// backpointers back to u = 0 and writes its tokens. At the flagship decoder
// a beam takes 1,955 + 2 W + U words (2,163 at W = 4 and U = 200). Beside
// the plan lie a CTA's bias slices, the most at C = 1 (2,252 words), so the
// plan goes into shared memory only where it fits beside those at every C
// (smem_plan_bytes): 25 beams at U = 200, not 26. The global plan (GLOBAL)
// keeps a CTA's plan in a slice of a device-memory workspace (B x C plans),
// for what does not fit (wider beams, long searches): there a send is a
// store into each peer's slice and a round ends at a cluster barrier, which
// orders those stores; the search code is the same.
//
// Attention is the TPU kernel's blocked mode (`fb`, :215-255) at every
// length: each step walks the valid frames in blocks of kFB with the
// online-softmax recurrence (a running max and sum per beam, the running
// context rescaled at each block), so the plan does not depend on T. The
// utterance's keys and values are copied into shared memory once where they
// fit beside the plan (T (K + V) floats: 30 KB at 4 s of audio), else read
// from global memory, L2-resident, at every step (30 s: 225 KB). f32
// operands and accumulation throughout.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster_sync.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 16;                   // lanes that share a row's dot product
constexpr int kGroups = kThreads / kLanes;   // rows in flight a CTA, two a warp
constexpr int kFB = 64;                      // frames per block of the attention
constexpr int kMaxC = 8;                     // CTAs a cluster, at most (the portable size)
constexpr int kMaxLayers = 15;               // 2 (nl + 1) mbarrier phase bits in a word
constexpr size_t kSmemLimit = 232448;        // dynamic shared memory a block may use (227 KB)

#ifdef TSL_TRACE
// A build with TSL_TRACE defined (a developer's copy of this file, never the
// port's library) records, at every launch, the first utterance's SM clocks
// by phase, summed over the steps, as its rank 0's thread 0 sees them: the
// prologue; a step's attention and embedding; each layer's products and
// gate math, then its exchange wait; the head's, then its wait; the
// log-softmax, top-W and reorder (2 nl + 5 counts; tsl_beam_trace reads them).
constexpr int kTracePhases = 2 * kMaxLayers + 5;
__device__ long long g_trace[kTracePhases];
#endif

__device__ __forceinline__ float sigmoid_(float x) { return 1.0f / (1.0f + expf(-x)); }

__host__ __device__ inline int up4(int n) { return (n + 3) & ~3; }

struct Dims {
  int B, T, W, nl, H, K, V, L, U;
};

// The plan, in 4-byte words; the kernel and the host share it. Hp, Xp: H and
// [embedding | context] rounded up to a multiple of 4 (rows are read by
// float4); NH = K + L, the head's rows.
struct Plan {
  long long bars, hx, x, lq, p, stat, score, newscore, sel, org, cand, hist, total;
};

__host__ __device__ inline Plan make_plan(int W, int nl, int H, int K, int V, int L, int U) {
  const long long Hp = up4(H), Xp = Hp + up4(V), NH = K + L;
  Plan p;
  long long o = 0;
  p.bars = o;     o += up4(4 * (nl + 1));     // 2 (nl + 1) mbarriers of 8 bytes
  p.hx = o;       o += 2LL * nl * W * Hp;     // each layer's new states, by step parity
  p.x = o;        o += (long long)W * Xp;     // [embedding | context]
  p.lq = o;       o += 2LL * W * NH;          // the head's outputs [query | logits], by step parity
  p.p = o;        o += (long long)W * kFB;    // a frame block's scores, then weights
  p.stat = o;     o += 3LL * W;               // running max, sum and rescale, per beam
  p.score = o;    o += W;
  p.newscore = o; o += W;
  p.sel = o;      o += W;                     // int: chosen w * L + l of this step
  p.org = o;      o += W;                     // int: the old beam each live beam continues
  p.cand = o;     o += 2LL * W * W;           // each beam's best W extensions: values, then int indices
  p.hist = o;     o += (long long)U * W;      // int: backpointers
  p.total = (o + 3) & ~3LL;
  return p;
}

// Floats of layer li's block in the packed cells: w_ih (3H, Dp), w_hh (3H,
// Hp), b_ih and b_hh (3H, each padded to a multiple of 4).
__host__ __device__ inline long long layer_floats(int li, int H, int V) {
  const long long Hp = up4(H), Dp = li == 0 ? Hp + up4(V) : Hp;
  return 3LL * H * Dp + 3LL * H * Hp + 2LL * up4(3 * H);
}

// Row width of cell matrix m (2 li: w_ih of layer li, 2 li + 1: its w_hh).
__host__ __device__ inline int mat_width(int m, int H, int V) {
  return m == 0 ? up4(H) + up4(V) : up4(H);
}

// The row of group slot w of the group starting at g0, clamped into [0, W):
// a group past the last row recomputes row W - 1 and does not send it.
__device__ __forceinline__ int row_of(int g0, int w, int W) { return min(g0 + w, W - 1); }

// acc[r][b] += <w[r], in + off[b]> over the float4 chunks c = lane, lane +
// 16, ... < n4 of the rows; weights from shared or global memory (generic
// loads: one copy of the code serves both).
template <int G, int R>
__device__ __forceinline__ void dot_rows(const float* const (&w)[R], const float* in,
                                         const int (&off)[G], int n4, int lane,
                                         float (&acc)[R][G]) {
#pragma unroll 2
  for (int c = lane; c < n4; c += kLanes) {
    float4 wv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) wv[r] = reinterpret_cast<const float4*>(w[r])[c];
#pragma unroll
    for (int b = 0; b < G; ++b) {
      const float4 x = reinterpret_cast<const float4*>(in + off[b])[c];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc[r][b] = fmaf(wv[r].x, x.x, acc[r][b]);
        acc[r][b] = fmaf(wv[r].y, x.y, acc[r][b]);
        acc[r][b] = fmaf(wv[r].z, x.z, acc[r][b]);
        acc[r][b] = fmaf(wv[r].w, x.w, acc[r][b]);
      }
    }
  }
}

// Sums each of acc over the 16 lanes of a row's group (every lane gets the
// sums); the whole warp takes part.
template <int R, int G>
__device__ __forceinline__ void reduce_lanes(float (&acc)[R][G]) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int b = 0; b < G; ++b) acc[r][b] += __shfl_xor_sync(0xffffffffu, acc[r][b], o);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (v, i) ranks before (bv, bi): larger value, then smaller index. A NaN (an
// extension already taken) ranks before nothing.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// G: beams a weight load serves (W in ceil(W / G) groups); GLOBAL: the plan
// lies in ws (B x C plans), else in shared memory. cache: bit m set when
// cell matrix m's slice lies in shared memory at word cache_off.
template <int G, bool GLOBAL>
__global__ void __launch_bounds__(kThreads, 1) beam_decode_kernel(
    const float* __restrict__ keys,      // (B, T, K)
    const float* __restrict__ values,    // (B, T, V)
    const long long* __restrict__ n_valid,  // (B,) valid frames, a prefix
    const float* __restrict__ we, const float* __restrict__ be,  // (L, H), (H)
    const float* __restrict__ cells,     // per layer: w_ih (3H, Dp), w_hh (3H, Hp), b_ih, b_hh
    const float* __restrict__ head,      // (K + L, Hp): the query's rows, then the labels'
    const float* __restrict__ head_b,    // (K + L)
    const float* __restrict__ init,      // (nl, H)
    float* __restrict__ scores,          // (W, B)
    long long* __restrict__ tokens,      // (W, B, U)
    float* ws,                           // (B x C plans), GLOBAL only
    Dims d, int kv_off, int bias_off, unsigned cache, int cache_off) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), c = (int)cluster.block_rank();
  const int b = (int)blockIdx.x / C;
  const int W = d.W, T = d.T, H = d.H, K = d.K, V = d.V, L = d.L, nl = d.nl;
  const int Hp = up4(H), Xp = Hp + up4(V), NH = K + L;
  const Plan pl = make_plan(W, nl, H, K, V, L, d.U);
  float* base = GLOBAL ? ws + (size_t)blockIdx.x * pl.total : smem;
  float* hx = base + pl.hx;
  float* x_s = base + pl.x;
  float* lq = base + pl.lq;
  float* p_s = base + pl.p;
  float* m_s = base + pl.stat;  // running max,
  float* l_s = m_s + W;         // running sum,
  float* a_s = l_s + W;         // and this block's rescale factor, per beam
  float* score_s = base + pl.score;
  float* newscore_s = base + pl.newscore;
  int* sel_s = reinterpret_cast<int*>(base + pl.sel);
  int* org_s = reinterpret_cast<int*>(base + pl.org);
  float* cand_v = base + pl.cand;
  int* cand_i = reinterpret_cast<int*>(cand_v + W * W);
  int* hist_s = reinterpret_cast<int*>(base + pl.hist);

  const int tid = threadIdx.x, lane32 = tid & 31, warp = tid >> 5;
  // a warp holds two rows' groups of 16 lanes; the item loops below step
  // whole warps, so that their lane shuffles run on converged warps
  const int half = (tid & 31) / kLanes, lane = tid % kLanes;
  const int ulo = c * H / C, Hc = (c + 1) * H / C - ulo;  // this CTA's units
  const int hlo = c * NH / C, Hh = (c + 1) * NH / C - hlo;  // ... and head rows
  const int Hcm = (H + C - 1) / C;  // the most units a CTA owns: the cache's slab rows / 3
  const long long nv = n_valid[b];
  const int n = (int)(nv < 1 ? 1 : (nv > T ? T : nv));
  const float scale = sqrtf((float)K);  // of the keys' true width
  // the utterance's keys and values: copied into shared memory at word
  // kv_off at the start where they fit, else read from global memory
  const float* kb = keys + (size_t)b * T * K;
  const float* vb = values + (size_t)b * T * V;
  if (kv_off >= 0) {
    float* ks = smem + kv_off;
    float* vs = ks + (size_t)T * K;
    for (int e = tid; e < n * K; e += kThreads) ks[e] = __ldg(kb + e);
    for (int e = tid; e < n * V; e += kThreads) vs[e] = __ldg(vb + e);
    kb = ks;
    vb = vs;
  }

  // the cell matrices: layer li's block in the packed cells, and this CTA's
  // slices of those in shared memory (bit m of cache), in the order m
  auto layer_block = [&](int li) {
    const float* cw = cells;
    for (int k = 0; k < li; ++k) cw += layer_floats(k, H, V);
    return cw;
  };
  auto slab_of = [&](int m) -> float* {  // null when matrix m streams from global memory
    if (!(cache >> m & 1u)) return nullptr;
    int so = cache_off;
    for (int k = 0; k < m; ++k)
      if (cache >> k & 1u) so += 3 * Hcm * mat_width(k, H, V);
    return smem + so;
  };

  // exchange: a send lands in every CTA's plan, this one's too; a round
  // ends when all of its values have landed
  const unsigned base_addr = GLOBAL ? 0u : smem_addr(base);
  const unsigned bar0 = GLOBAL ? 0u : smem_addr(base + pl.bars);  // mbarrier q at bar0 + 8 q
  const unsigned layer_bytes = (unsigned)(W * H) * 4u, head_bytes = (unsigned)(W * NH) * 4u;
  auto round_bytes = [&](int q) { return q / 2 < nl ? layer_bytes : head_bytes; };
  auto send = [&](long long off, float v, int q) {
    if (GLOBAL) {
      for (int r = 0; r < C; ++r) ws[(size_t)(b * C + r) * pl.total + off] = v;
    } else {
      const unsigned a = base_addr + (unsigned)off * 4u, bar = bar0 + 8u * q;
      for (int r = 0; r < C; ++r) st_async(peer_addr(a, r), v, peer_addr(bar, r));
    }
  };
  // the trace (TSL_TRACE builds only): SM clocks by phase, its own products
  // and then its waits
#ifdef TSL_TRACE
  const bool traced = blockIdx.x == 0 && tid == 0;
  long long t_last = clock64();
  long long t_acc[kTracePhases] = {};
#endif
  auto stamp = [&](int k) {
#ifdef TSL_TRACE
    if (traced) {
      const long long t = clock64();
      t_acc[k] += t - t_last;
      t_last = t;
    }
#endif
  };
  unsigned phases = 0;  // bit q: the parity of mbarrier q's next phase
  auto wait_round = [&](int q) {
    if (GLOBAL) {
      cluster_barrier();
    } else {
      mbar_wait(bar0 + 8u * q, phases >> q & 1u);
      phases ^= 1u << q;
      if (tid == 0) mbar_expect(bar0 + 8u * q, round_bytes(q));  // its use two steps on
    }
  };

  // ---- prologue: every beam holds the initial state (the exchange buffer
  // of parity 1, which step 0 reads as the previous step's), the cache
  // slices, the mbarriers armed
  for (int e = tid; e < nl * W * Hp; e += kThreads) {
    const int li = e / (W * Hp), j = e % Hp;
    hx[(size_t)nl * W * Hp + e] = j < H ? init[li * H + j] : 0.0f;
  }
  if (tid < W) {
    score_s[tid] = 0.0f;
    org_s[tid] = tid;
  }
  for (int m = 0; m < 2 * nl; ++m) {
    float* slab = slab_of(m);
    if (slab == nullptr) continue;
    const int Dp4 = mat_width(m, H, V) / 4;
    const float* mat = layer_block(m / 2) + (m % 2 ? 3LL * H * mat_width(m - 1, H, V) : 0);
    for (int e = tid; e < 3 * Hc * Dp4; e += kThreads) {
      const int r = e / Dp4, k = e % Dp4, g = r / Hc, j = r % Hc;
      reinterpret_cast<float4*>(slab + (size_t)(g * Hcm + j) * Dp4 * 4)[k] =
          __ldg(reinterpret_cast<const float4*>(mat + (size_t)(g * H + ulo + j) * Dp4 * 4) + k);
    }
  }
  // this CTA's biases at word bias_off: per layer b_ih + b_hh of the r and
  // z rows, then b_ih and b_hh of the n rows (Hcm each), then the head's
  float* bias_s = smem + bias_off;
  for (int li = 0; li < nl; ++li) {
    const float* bi = layer_block(li) + 3LL * H * (mat_width(2 * li, H, V) + Hp);
    const float* bh = bi + up4(3 * H);
    for (int jl = tid; jl < Hc; jl += kThreads) {
      const int j = ulo + jl;
      float* bs = bias_s + 4 * Hcm * li + jl;
      bs[0] = bi[j] + bh[j];
      bs[Hcm] = bi[H + j] + bh[H + j];
      bs[2 * Hcm] = bi[2 * H + j];
      bs[3 * Hcm] = bh[2 * H + j];
    }
  }
  for (int k = tid; k < Hh; k += kThreads) bias_s[4 * Hcm * nl + k] = head_b[hlo + k];
  if (!GLOBAL && tid == 0) {
    for (int q = 0; q < 2 * (nl + 1); ++q) mbar_init(bar0 + 8u * q);
    mbar_init_fence();
    for (int q = 0; q < 2 * (nl + 1); ++q) mbar_expect(bar0 + 8u * q, round_bytes(q));
  }
  __syncthreads();
  cluster.sync();  // every CTA's mbarriers armed before any CTA sends
  stamp(0);

  // step u = -1 runs the head alone: the initial state's query into exchange
  // slot 1, which step 0 reads as the previous step's
  for (int u = -1; u < d.U; ++u) {
    const int slot = u & 1, prev = slot ^ 1;
    if (u >= 0) {
      // ---- attention over the valid frames, the query the head of the top
      // layer's state; the context lands in x_s[w * Xp + Hp + c]
      for (int w = tid; w < W; w += kThreads) {
        m_s[w] = -INFINITY;
        l_s[w] = 0.0f;
      }
      for (int e = tid; e < W * (Xp - Hp); e += kThreads) x_s[(e / (Xp - Hp)) * Xp + Hp + e % (Xp - Hp)] = 0.0f;
      __syncthreads();
      for (int t0 = 0; t0 < n; t0 += kFB) {
        const int nf = min(kFB, n - t0);
        // scores of the block's frames: 4 lanes a (beam, frame)
        for (int e0 = 8 * warp; e0 < W * nf; e0 += kThreads / 4) {
          const int e = min(e0 + lane32 / 4, W * nf - 1);  // past the last pair: recompute it
          const int w = e / nf, t = e % nf;
          const float* q = lq + ((size_t)prev * W + org_s[w]) * NH;
          const float* k = kb + (size_t)(t0 + t) * K;
          float s = 0.0f;
          for (int ci = tid % 4; ci < K; ci += 4) s = fmaf(q[ci], k[ci], s);
          s += __shfl_xor_sync(0xffffffffu, s, 2);
          s += __shfl_xor_sync(0xffffffffu, s, 1);
          if (tid % 4 == 0) p_s[w * kFB + t] = s / scale;
        }
        __syncthreads();
        // online softmax: m' = max(m, block max), weights exp(s - m'), the
        // running sum and context rescaled by exp(m - m')
        for (int w = warp; w < W; w += kWarps) {
          float* p = p_s + w * kFB;
          float mb = -INFINITY;
          for (int t = lane32; t < nf; t += 32) mb = fmaxf(mb, p[t]);
          const float m_old = m_s[w];
          const float m_new = fmaxf(m_old, warp_max(mb));
          float s = 0.0f;
          for (int t = lane32; t < nf; t += 32) {
            const float e = expf(p[t] - m_new);
            p[t] = e;
            s += e;
          }
          s = warp_sum(s);
          if (lane32 == 0) {
            const float alpha = expf(m_old - m_new);  // 0 at the first block
            a_s[w] = alpha;
            l_s[w] = l_s[w] * alpha + s;
            m_s[w] = m_new;
          }
        }
        __syncthreads();
        for (int ci = tid; ci < V; ci += kThreads) {
          for (int g0 = 0; g0 < W; g0 += G) {
            float acc[G];
#pragma unroll
            for (int w = 0; w < G; ++w) {
              const int r = row_of(g0, w, W);
              acc[w] = x_s[r * Xp + Hp + ci] * a_s[r];
            }
            for (int t = 0; t < nf; ++t) {
              const float vv = vb[(size_t)(t0 + t) * V + ci];
#pragma unroll
              for (int w = 0; w < G; ++w)
                acc[w] = fmaf(p_s[row_of(g0, w, W) * kFB + t], vv, acc[w]);
            }
#pragma unroll
            for (int w = 0; w < G; ++w)
              if (g0 + w < W) x_s[(g0 + w) * Xp + Hp + ci] = acc[w];
          }
        }
        __syncthreads();
      }
      // ---- [embedding of the previous token | context]: the running context
      // over its sum; the padding columns stay 0
      for (int e = tid; e < W * Xp; e += kThreads) {
        const int w = e / Xp, j = e % Xp;
        if (j < Hp) {
          x_s[e] = j >= H ? 0.0f : u == 0 ? be[j] : we[(size_t)(sel_s[w] % L) * H + j] + be[j];
        } else if (j - Hp < V) {
          x_s[e] /= l_s[w];
        }
      }
      __syncthreads();
      stamp(1);
      // ---- stacked GRUCells: this CTA's units of every beam, the new h sent
      // to every CTA; beam w's state is the previous step's row org[w]
      for (int li = 0; li < nl; ++li) {
        const float* in = li == 0 ? x_s : hx + ((size_t)slot * nl + li - 1) * W * Hp;
        const int in4 = (li == 0 ? Xp : Hp) / 4;
        const float* hprev = hx + ((size_t)prev * nl + li) * W * Hp;
        const float* wih = layer_block(li);
        const float* whh = wih + 3LL * H * in4 * 4;
        const float* bs = bias_s + 4 * Hcm * li;
        const float* si = slab_of(2 * li);
        const float* sh = slab_of(2 * li + 1);
        const int groups = (W + G - 1) / G;
        for (int i0 = 2 * warp; i0 < Hc * groups; i0 += kGroups) {
          const bool active = i0 + half < Hc * groups;  // the warp's second row may have none
          const int item = active ? i0 + half : i0;
          const int jl = item % Hc, j = ulo + jl, g0 = item / Hc * G;
          int off_in[G], off_h[G];
#pragma unroll
          for (int w = 0; w < G; ++w) {
            const int r = row_of(g0, w, W);
            off_in[w] = r * in4 * 4;
            off_h[w] = org_s[r] * Hp;
          }
          const float b_r = bs[jl], b_z = bs[Hcm + jl], b_in = bs[2 * Hcm + jl], b_hn = bs[3 * Hcm + jl];
          float ai[3][G] = {}, ah[3][G] = {};
          const float* wi[3];
          const float* wh[3];
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            wi[g] = si ? si + (size_t)(g * Hcm + jl) * in4 * 4 : wih + (size_t)(g * H + j) * in4 * 4;
            wh[g] = sh ? sh + (size_t)(g * Hcm + jl) * Hp : whh + (size_t)(g * H + j) * Hp;
          }
          dot_rows<G, 3>(wi, in, off_in, in4, lane, ai);
          dot_rows<G, 3>(wh, hprev, off_h, Hp / 4, lane, ah);
          // r and z need only gi + gh: 4 sums a beam meet across the lanes
          float sums[4][G];
#pragma unroll
          for (int w = 0; w < G; ++w) {
            sums[0][w] = ai[0][w] + ah[0][w];
            sums[1][w] = ai[1][w] + ah[1][w];
            sums[2][w] = ai[2][w];
            sums[3][w] = ah[2][w];
          }
          reduce_lanes(sums);
          if (active && lane < G && g0 + lane < W) {
            float g4[4] = {};
            int oh = 0;
#pragma unroll
            for (int w = 0; w < G; ++w) {
              if (w == lane) {
#pragma unroll
                for (int g = 0; g < 4; ++g) g4[g] = sums[g][w];
                oh = off_h[w];
              }
            }
            const float r = sigmoid_(g4[0] + b_r);
            const float z = sigmoid_(g4[1] + b_z);
            const float ng = tanhf((g4[2] + b_in) + r * (g4[3] + b_hn));
            const float h = hprev[oh + j];
            send(pl.hx + (((long long)slot * nl + li) * W + g0 + lane) * Hp + j, ng + z * (h - ng),
                 2 * li + slot);
          }
        }
        stamp(2 + 2 * li);
        wait_round(2 * li + slot);
        stamp(3 + 2 * li);
      }
    }
    // ---- the head over the top layer's new states: this CTA's rows of
    // [query | logits] for every beam, sent into lq[slot]
    const float* in = hx + ((size_t)slot * nl + nl - 1) * W * Hp;
    const int groups = (W + G - 1) / G;
    for (int i0 = 2 * warp; i0 < Hh * groups; i0 += kGroups) {
      const bool active = i0 + half < Hh * groups;
      const int item = active ? i0 + half : i0;
      const int hr = hlo + item % Hh, g0 = item / Hh * G;
      int off[G];
#pragma unroll
      for (int w = 0; w < G; ++w) off[w] = row_of(g0, w, W) * Hp;
      const float hb = bias_s[4 * Hcm * nl + hr - hlo];
      float acc[1][G] = {};
      const float* wr[1] = {head + (size_t)hr * Hp};
      dot_rows<G, 1>(wr, in, off, Hp / 4, lane, acc);
      reduce_lanes(acc);
      if (active && lane < G && g0 + lane < W) {
        float v = 0.0f;
#pragma unroll
        for (int w = 0; w < G; ++w)
          if (w == lane) v = acc[0][w];
        send(pl.lq + ((long long)slot * W + g0 + lane) * NH + hr, v + hb, 2 * nl + slot);
      }
    }
    stamp(2 * nl + 2);
    wait_round(2 * nl + slot);
    stamp(2 * nl + 3);
    if (u < 0) {
#ifdef TSL_TRACE
      if (traced) {  // step -1 counts as prologue
        t_acc[0] += t_acc[2 * nl + 2] + t_acc[2 * nl + 3];
        t_acc[2 * nl + 2] = t_acc[2 * nl + 3] = 0;
      }
#endif
      continue;
    }
    float* logits = lq + (size_t)slot * W * NH + K;  // beam w's at logits[w * NH + l]
    // ---- log-softmax over the labels, and each live beam's best W
    // extensions (warp w for beam w: W rounds of a warp argmax, larger
    // value then smaller index w * L + l, the winner knocked out); the W
    // best of all W x L extensions are among these W x W
    for (int w = warp; w < W; w += kWarps) {
      float* x = logits + (size_t)w * NH;
      float m = -INFINITY;
      for (int l = lane32; l < L; l += 32) m = fmaxf(m, x[l]);
      m = warp_max(m);
      float s = 0.0f;
      for (int l = lane32; l < L; l += 32) s += expf(x[l] - m);
      const float lse = logf(warp_sum(s));
      const float sc = score_s[w];
      float bv = -INFINITY;  // this lane's best extension of the beam
      int bl = 0x7fffffff;
      for (int l = lane32; l < L; l += 32) {
        const float v = (u == 0 && w > 0) ? -INFINITY : sc + ((x[l] - m) - lse);
        x[l] = v;
        if (better(v, l, bv, bl)) {
          bv = v;
          bl = l;
        }
      }
      for (int r = 0; r < W; ++r) {
        float v = bv;
        int l = bl;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, v, o);
          const int ol = __shfl_xor_sync(0xffffffffu, l, o);
          if (better(ov, ol, v, l)) {
            v = ov;
            l = ol;
          }
        }
        if (lane32 == 0) {  // past the L labels (W > L): a NaN slot, never chosen
          cand_v[w * W + r] = l < L ? v : __int_as_float(0x7fc00000);
          cand_i[w * W + r] = l < L ? w * L + l : 0x7fffffff;
        }
        if (bl == l && l < L) {  // the winner's lane: knock it out, find its next best
          x[l] = __int_as_float(0x7fc00000);  // NaN: taken
          bv = -INFINITY;
          bl = 0x7fffffff;
          for (int k = lane32; k < L; k += 32)
            if (better(x[k], k, bv, bl)) {
              bv = x[k];
              bl = k;
            }
        }
      }
    }
    __syncthreads();
    // ---- top W of the extensions, best first: a candidate's rank is the
    // number of candidates that rank before it
    for (int k = tid; k < W * W; k += kThreads) {
      const float v = cand_v[k];
      const int i = cand_i[k];
      if (v != v) continue;
      int rank = 0;
      for (int j = 0; j < W * W; ++j) rank += better(cand_v[j], cand_i[j], v, i);
      if (rank < W) {
        sel_s[rank] = i;
        newscore_s[rank] = v;
        hist_s[u * W + rank] = i;
      }
    }
    __syncthreads();
    // ---- new beam j continues old beam sel_j / L
    if (tid < W) {
      score_s[tid] = newscore_s[tid];
      org_s[tid] = sel_s[tid] / L;
    }
    __syncthreads();
    stamp(2 * nl + 4);
  }
#ifdef TSL_TRACE
  if (traced)
    for (int k = 0; k < 2 * nl + 5; ++k) g_trace[k] = t_acc[k];
#endif

  if (c == 0 && tid < W) {
    const int B = d.B, U = d.U;
    scores[tid * B + b] = score_s[tid];
    long long* out = tokens + ((size_t)tid * B + b) * U;
    int w = tid;
    for (int u = U - 1; u >= 0; --u) {
      const int idx = hist_s[u * W + w];
      out[u] = idx % L;
      w = idx / L;
    }
  }
  cluster.sync();  // no CTA leaves while a peer may still address its shared memory
}

// Bytes of a CTA's bias slices on a cluster of C: 4 per layer of ceil(H /
// C) units, and ceil((K + L) / C) rows of the head. The most at C = 1.
inline size_t bias_bytes(const Dims& d, int C) {
  return sizeof(float) * up4(4 * d.nl * ((d.H + C - 1) / C) + (d.K + d.L + C - 1) / C);
}

// Bytes of shared memory the smem plan needs at any C: the plan and the
// bias slices of C = 1. The plan lies in shared memory where this fits a
// block, else in the workspace (GLOBAL).
inline size_t smem_plan_bytes(const Dims& d) {
  return sizeof(float) * make_plan(d.W, d.nl, d.H, d.K, d.V, d.L, d.U).total + bias_bytes(d, 1);
}

// The cache's choice: this CTA's slices of the cell matrices, w_hh from the
// top layer down, then w_ih, each while it fits in `avail` bytes. Returns
// the bit set and adds the slices' bytes to *bytes.
inline unsigned pick_cache(const Dims& d, int C, size_t avail, size_t* bytes) {
  const int Hcm = (d.H + C - 1) / C;
  unsigned mask = 0;
  for (int k = 1; k >= 0; --k) {
    for (int li = d.nl - 1; li >= 0; --li) {
      const int m = 2 * li + k;
      const size_t slab = sizeof(float) * 3 * Hcm * mat_width(m, d.H, d.V);
      if (slab <= avail) {
        mask |= 1u << m;
        avail -= slab;
        *bytes += slab;
      }
    }
  }
  return mask;
}

struct Config {
  int C;
  int kv_off;     // words; -1: keys and values stay in global memory
  int bias_off;   // words
  unsigned cache;
  int cache_off;  // words
  size_t smem;    // bytes of dynamic shared memory
};

template <int G, bool GLOBAL>
cudaError_t max_clusters(int C, size_t smem, int* n) {
  auto kernel = beam_decode_kernel<G, GLOBAL>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
}

// The cluster size and shared memory of a decode: C from 8 down to 2, the
// largest whose B clusters are all resident on the card at once, else 1; the
// plan in shared memory unless GLOBAL, then the bias slices, an utterance's
// keys and values where they fit, and the cache in what is left. A C whose
// plan and bias slices do not fit a block is passed over (none is, when
// dispatch chose the smem plan by smem_plan_bytes).
template <int G, bool GLOBAL>
cudaError_t configure(const Dims& d, Config* cfg) {
  const size_t plan = GLOBAL ? 0
                             : sizeof(float) *
                                   make_plan(d.W, d.nl, d.H, d.K, d.V, d.L, d.U).total;
  const size_t kv = sizeof(float) * up4(d.T * (d.K + d.V));
  for (int C = kMaxC; C >= 1; --C) {
    const size_t bias = bias_bytes(d, C);
    if (plan + bias > kSmemLimit) continue;
    const bool kv_resident = plan + bias + kv <= kSmemLimit;
    const size_t fixed = plan + bias + (kv_resident ? kv : 0);
    size_t smem = fixed;
    const unsigned cache = pick_cache(d, C, kSmemLimit - fixed, &smem);
    int n = 0;
    if (C > 1) {
      const cudaError_t err = max_clusters<G, GLOBAL>(C, smem, &n);
      if (err != cudaSuccess) return err;
    }
    if (C == 1 || d.B <= n) {
      *cfg = Config{C, kv_resident ? (int)((plan + bias) / sizeof(float)) : -1,
                    (int)(plan / sizeof(float)), cache, (int)(fixed / sizeof(float)), smem};
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidValue;
}

template <int G, bool GLOBAL>
cudaError_t launch(const float* keys, const float* values, const long long* n_valid,
                   const float* we, const float* be, const float* cells, const float* head,
                   const float* head_b, const float* init, float* scores, long long* tokens,
                   float* ws, const Dims& d, int* C_out, cudaStream_t st) {
  Config cf;
  cudaError_t err = configure<G, GLOBAL>(d, &cf);
  if (err != cudaSuccess) return err;
  if (C_out != nullptr) {
    *C_out = cf.C;
    return cudaSuccess;
  }
  auto kernel = beam_decode_kernel<G, GLOBAL>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cf.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(d.B * cf.C));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = cf.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cf.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, keys, values, n_valid, we, be, cells, head, head_b, init,
                           scores, tokens, ws, d, cf.kv_off, cf.bias_off, cf.cache,
                           cf.cache_off);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The plan's placement (GLOBAL: past a block's shared memory) and the beams
// a weight load serves: W for 1, 2; 4 for 3, 4; else groups of 8.
cudaError_t dispatch(const float* keys, const float* values, const long long* n_valid,
                     const float* we, const float* be, const float* cells, const float* head,
                     const float* head_b, const float* init, float* scores, long long* tokens,
                     float* ws, const Dims& d, int* C_out, cudaStream_t st) {
  if (d.W < 1 || d.nl < 1 || d.nl > kMaxLayers || d.H < 1 || d.K < 1 || d.V < 1 || d.L < 1 ||
      d.U < 1 || d.B < 1 || d.T < 1)
    return cudaErrorInvalidValue;
  const bool global = smem_plan_bytes(d) > kSmemLimit;
#define TSL_BEAM(GV, GLOBALV)                                                                 \
  launch<GV, GLOBALV>(keys, values, n_valid, we, be, cells, head, head_b, init, scores, tokens, \
                      ws, d, C_out, st)
  if (global) return TSL_BEAM(8, true);
  switch (d.W) {
    case 1:
      return TSL_BEAM(1, false);
    case 2:
      return TSL_BEAM(2, false);
    case 3:
    case 4:
      return TSL_BEAM(4, false);
    default:
      return TSL_BEAM(8, false);
  }
#undef TSL_BEAM
}

}  // namespace

extern "C" {

// Bytes of shared memory the smem plan needs, its bias slices included
// (before the keys and values and the weight cache; no T term): the plan
// lies in shared memory where this is at most 232448, else in a workspace of
// B x C slices of this many bytes (each holds a plan; its bias slices stay in
// shared memory).
long long tsl_beam_decode_smem_bytes(int W, int nl, int H, int K, int V, int L, int U) {
  return (long long)smem_plan_bytes(Dims{1, 1, W, nl, H, K, V, L, U});
}

// The CTAs a cluster of the decode of B utterances of T frames takes on the
// current device (1 to 8; tsl_beam_decode's workspace holds B x C plans);
// -1 on a CUDA error.
int tsl_beam_cluster_size(int B, int T, int W, int nl, int H, int K, int V, int L, int U) {
  const Dims d{B, T, W, nl, H, K, V, L, U};
  int C = 0;
  const cudaError_t err = dispatch(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                   nullptr, nullptr, nullptr, nullptr, nullptr, d, &C,
                                   nullptr);
  return err == cudaSuccess ? C : -1;
}

// The whole beam search of B utterances, a cluster of C CTAs each
// (tsl_beam_cluster_size). keys (B, T, K) and values (B, T, V) row-major
// f32; n_valid (B,) int64 valid frame counts, each in [1, T]. Weights: we
// (L, H) and be (H) the embedding, in the JAX layout; cells packs, per layer
// li, w_ih (3H, Dp) (Dp = up4(H) + up4(V) for layer 0, its columns [0, H)
// the embedding's inputs and [up4(H), up4(H) + V) the context's; up4(H)
// after it), w_hh (3H, up4(H)), b_ih and b_hh (3H, each padded to a multiple
// of 4), torch layout, zeros in the padding; head (K + L, up4(H)) the query
// projection's rows then the labels', head_b (K + L); init (nl, H). Writes
// scores (W, B) best-first and tokens (W, B, U) int64. W >= 1, nl <= 15.
// workspace null: the plan lies in shared memory and must fit a block
// (tsl_beam_decode_smem_bytes <= 232448); else in workspace, of B x C x
// tsl_beam_decode_smem_bytes bytes. Returns cudaSuccess (0) or the first
// error of the launch; does not synchronise.
int tsl_beam_decode(const float* keys, const float* values, const long long* n_valid,
                    const float* we, const float* be, const float* cells, const float* head,
                    const float* head_b, const float* init, float* scores, long long* tokens,
                    float* workspace, int B, int T, int W, int nl, int H, int K, int V, int L,
                    int U, void* stream) {
  const Dims d{B, T, W, nl, H, K, V, L, U};
  const bool global = smem_plan_bytes(d) > kSmemLimit;
  if (global != (workspace != nullptr)) return (int)cudaErrorInvalidValue;
  return (int)dispatch(keys, values, n_valid, we, be, cells, head, head_b, init, scores, tokens,
                       workspace, d, nullptr, (cudaStream_t)stream);
}

#ifdef TSL_TRACE
// The traced build's clocks of its last launch (see kTracePhases): n <=
// 2 nl + 5 int64 into host memory out, after the launch has finished.
int tsl_beam_trace(long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, g_trace, sizeof(long long) * n);
}
#endif

}  // extern "C"
