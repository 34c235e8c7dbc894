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
// Layout: one CTA per utterance, its W beams as W rows. The plan (make_plan)
// holds the beams' states before and after the step, the step's scratch
// (query, a frame block's attention weights, [embedding | context], gate
// pre-activations, extensions), the scores, and a backpointer per step and
// beam (w * L + l of the chosen extension). After the last step each final
// beam walks its backpointers back to u = 0 and writes its tokens: the same
// tokens as gathering the history at every step, without copying W x U ints
// per step.
//
// Where the plan lies is fixed at compile time (GLOBAL). The smem plan keeps
// it in shared memory; it is taken whenever it fits a block (227 KB). The
// global plan keeps it in a per-CTA slice of a workspace in device memory
// that the caller allocates (B x plan words), and only the warp reduction
// slots in shared memory: wide beams (past 19 at the flagship decoder, ~3k
// words a beam) and long searches (U x W backpointers) run there, on any
// width and any max_len. A CTA's slice is read and written by that CTA
// alone and stays in the 50 MB L2 (~12 MB at W = 64, B = 16), and
// __syncthreads() orders its global writes as it does the shared ones: the
// search code is the same for both plans. The global plan runs the wide
// instantiation (groups of 8 rows) at every width. It is correct first and
// not fast: measured on an H100 SXM (700 W), its step costs ~4.8x the smem
// plan's at W = 20 against W = 16 (PERF.md), the scratch reread from L2.
//
// Attention is the TPU kernel's blocked mode (`fb`, :215-255) at every
// length: keys and values stay in global memory, where they are L2-resident
// (~3.6 MB at 30 s, B = 16), and each step streams the valid frames in
// blocks of kFB with the online-softmax recurrence: per beam a running max
// and sum in shared memory, and the running W x V context in the context
// half of [embedding | context], rescaled at each block. So the plan does
// not depend on T and any length fits. The TPU kernel also has a mode that
// keeps K/V resident for short inputs (`_fused_mode`, :105); on this card a
// shared-memory-resident mode was no faster at 4 s (PERF.md), so it is not
// kept. The beams' score threads of one frame read the same key row, served
// by L1.
// Beams are held in registers in groups of G rows: widths 1-8 each have an
// instantiation with G = W; wider beams run the G = 8 instantiation over
// ceil(W / 8) groups, each weight read serving the group's rows.
//
// The weights come in the JAX layout, (in, out) row-major, so that thread j
// reads column j and neighbouring threads read neighbouring addresses; each
// thread keeps W accumulators, so a weight read serves all W rows. They are
// read from global memory at every step: ~1.0 M floats (4 MB) at the width of
// experiments/all_real_seq2seq.cfg, resident in the 50 MB L2.
//
// What bounds it on this card: one SM per utterance streams the decoder's
// weights from L2 at every step (~4 MB; ~40 us at the ~100 GB/s one SM can
// draw) and runs ~4 M FMAs there; the U steps are a serial chain. A decode
// is flat in B up to the 132 SMs and far above the bound of the arithmetic
// spread over the whole card. Measured on an H100 SXM (700 W), a step takes
// ~115 us: the 3H = 768 gate columns fall on 512 threads, so half the warps
// walk two columns, and each warp waits out an L2 round trip for every 8
// weight rows it unrolls, so latency, not L2 bandwidth, binds it (PERF.md).
// What would change that (an even column split or split-K, deeper unrolling,
// the gate columns split over a thread-block cluster with the weights
// resident in distributed shared memory, or all B x W rows in one CTA group)
// is left for a later change. f32 operands and accumulation throughout.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kFB = 64;    // frames per block of the blocked mode
constexpr int kGroup = 8;  // rows per register group of the wide instantiation

__device__ __forceinline__ float sigmoid_(float x) { return 1.0f / (1.0f + expf(-x)); }

struct Dims {
  int B, T, W, nl, H, K, V, L, U;
};

// Shared-memory plan, in 4-byte words; the kernel and the host share it.
struct Plan {
  long long h, hn, x, q, p, stat, rz, gin, ghn, ext, score, newscore, red_v, red_i, sel, hist,
      total;
};

__host__ __device__ inline Plan make_plan(int W, int nl, int H, int K, int V, int L, int U) {
  Plan p;
  long long o = 0;
  p.h = o;        o += (long long)nl * W * H;   // live beams' states
  p.hn = o;       o += (long long)nl * W * H;   // states after this step, before the reorder
  p.x = o;        o += (long long)W * (H + V);  // [embedding | context]
  p.q = o;        o += (long long)W * K;        // query
  p.p = o;        o += (long long)W * kFB;      // a frame block's scores, then weights
  p.stat = o;     o += 3LL * W;                 // running max, sum and rescale, per beam
  p.rz = o;       o += (long long)W * 2 * H;    // gi + gh of the r and z gates
  p.gin = o;      o += (long long)W * H;        // gi of the n gate
  p.ghn = o;      o += (long long)W * H;        // gh of the n gate
  p.ext = o;      o += (long long)W * L;        // logits, then extensions
  p.score = o;    o += W;
  p.newscore = o; o += W;
  p.red_v = o;    o += kWarps;
  p.red_i = o;    o += kWarps;                  // int
  p.sel = o;      o += W;                       // int: chosen w * L + l of this step
  p.hist = o;     o += (long long)U * W;        // int: backpointers
  p.total = o;
  return p;
}

// The row of group slot w of the group starting at g0, clamped into [0, W):
// a group past the last row recomputes row W - 1 and does not write it.
__device__ __forceinline__ int row_of(int g0, int w, int W) { return min(g0 + w, W - 1); }

// out[w * out_pitch + j] = bias[j] + sum_d in[w * in_pitch + d] * wt[d * N + j],
// for j < N and the W rows, G rows at a time; thread j owns column j
// (strided over the block). in lies in shared memory; wt (D, N) row-major
// and bias in global memory.
template <int G>
__device__ __forceinline__ void matvec(const float* __restrict__ wt, const float* __restrict__ bias,
                                       const float* in, int in_pitch, int D, int N, float* out,
                                       int out_pitch, int W) {
  for (int j = threadIdx.x; j < N; j += kThreads) {
    const float b = bias[j];
    for (int g0 = 0; g0 < W; g0 += G) {
      float acc[G];
#pragma unroll
      for (int w = 0; w < G; ++w) acc[w] = b;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float wv = __ldg(wt + (size_t)d * N + j);
#pragma unroll
        for (int w = 0; w < G; ++w)
          acc[w] = fmaf(in[row_of(g0, w, W) * in_pitch + d], wv, acc[w]);
      }
#pragma unroll
      for (int w = 0; w < G; ++w)
        if (g0 + w < W) out[(g0 + w) * out_pitch + j] = acc[w];
    }
  }
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

// G: rows per register group; WIDE: W = d.W rows in ceil(W / G) groups
// (else W = G); GLOBAL: the plan lies in ws (B x plan words), else in shared
// memory.
template <int G, bool WIDE, bool GLOBAL>
__global__ void __launch_bounds__(kThreads, 1) beam_decode_kernel(
    const float* __restrict__ keys,      // (B, T, K)
    const float* __restrict__ values,    // (B, T, V)
    const long long* __restrict__ n_valid,  // (B,) valid frames, a prefix
    const float* __restrict__ wq, const float* __restrict__ bq,  // (H, K), (K)
    const float* __restrict__ we, const float* __restrict__ be,  // (L, H), (H)
    const float* __restrict__ cells,     // per layer: w_ih (in, 3H), w_hh (H, 3H), b_ih, b_hh
    const float* __restrict__ wl, const float* __restrict__ bl,  // (H, L), (L)
    const float* __restrict__ init,      // (nl, H)
    float* __restrict__ scores,          // (W, B)
    long long* __restrict__ tokens,      // (W, B, U)
    float* ws,                           // (B, plan words), GLOBAL only
    Dims d) {
  extern __shared__ __align__(16) float smem[];
  const int W = WIDE ? d.W : G;
  const Plan pl = make_plan(W, d.nl, d.H, d.K, d.V, d.L, d.U);
  float* base = GLOBAL ? ws + (size_t)blockIdx.x * pl.total : smem;
  float* h_s = base + pl.h;
  float* hn_s = base + pl.hn;
  float* x_s = base + pl.x;
  float* q_s = base + pl.q;
  float* p_s = base + pl.p;
  float* m_s = base + pl.stat;  // running max,
  float* l_s = m_s + W;         // running sum,
  float* a_s = l_s + W;         // and this block's rescale factor, per beam
  float* rz_s = base + pl.rz;
  float* gin_s = base + pl.gin;
  float* ghn_s = base + pl.ghn;
  float* ext_s = base + pl.ext;
  float* score_s = base + pl.score;
  float* newscore_s = base + pl.newscore;
  float* red_v = GLOBAL ? smem : base + pl.red_v;
  int* red_i = reinterpret_cast<int*>(GLOBAL ? smem + kWarps : base + pl.red_i);
  int* sel_s = reinterpret_cast<int*>(base + pl.sel);
  int* hist_s = reinterpret_cast<int*>(base + pl.hist);

  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = d.T, H = d.H, K = d.K, V = d.V, L = d.L, nl = d.nl;
  const int H3 = 3 * H, X = H + V, WL = W * L;
  const long long nv = n_valid[b];
  const int n = (int)(nv < 1 ? 1 : (nv > T ? T : nv));
  const float scale = sqrtf((float)K);  // of the keys' true width

  const float* __restrict__ kb = keys + (size_t)b * T * K;
  const float* __restrict__ vb = values + (size_t)b * T * V;
  for (int e = tid; e < nl * W * H; e += kThreads) h_s[e] = init[(e / (W * H)) * H + e % H];
  if (tid < W) score_s[tid] = 0.0f;
  __syncthreads();

  for (int u = 0; u < d.U; ++u) {
    // ---- attention over the valid frames, query from the top layer's state;
    // the context lands in x_s[w * X + H + c]
    matvec<G>(wq, bq, h_s + (size_t)(nl - 1) * W * H, H, H, K, q_s, K, W);
    __syncthreads();
    for (int w = tid; w < W; w += kThreads) {
      m_s[w] = -INFINITY;
      l_s[w] = 0.0f;
    }
    for (int e = tid; e < W * V; e += kThreads) x_s[(e / V) * X + H + e % V] = 0.0f;
    __syncthreads();
    for (int t0 = 0; t0 < n; t0 += kFB) {
      const int nf = min(kFB, n - t0);
      // scores of the block's frames; neighbouring threads take neighbouring frames
      for (int e = tid; e < W * nf; e += kThreads) {
        const int w = e / nf, t = e % nf;
        const float* q = q_s + w * K;
        const float* __restrict__ k = kb + (size_t)(t0 + t) * K;
        float s = 0.0f;
        for (int c = 0; c < K; ++c) s = fmaf(q[c], __ldg(k + c), s);
        p_s[w * kFB + t] = s / scale;
      }
      __syncthreads();
      // online softmax: m' = max(m, block max), weights exp(s - m'), the
      // running sum and context rescaled by exp(m - m')
      for (int w = warp; w < W; w += kWarps) {
        float* p = p_s + w * kFB;
        float mb = -INFINITY;
        for (int t = lane; t < nf; t += 32) mb = fmaxf(mb, p[t]);
        const float m_old = m_s[w];
        const float m_new = fmaxf(m_old, warp_max(mb));
        float s = 0.0f;
        for (int t = lane; t < nf; t += 32) {
          const float e = expf(p[t] - m_new);
          p[t] = e;
          s += e;
        }
        s = warp_sum(s);
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);  // 0 at the first block
          a_s[w] = alpha;
          l_s[w] = l_s[w] * alpha + s;
          m_s[w] = m_new;
        }
      }
      __syncthreads();
      for (int c = tid; c < V; c += kThreads) {
        for (int g0 = 0; g0 < W; g0 += G) {
          float acc[G];
#pragma unroll
          for (int w = 0; w < G; ++w) {
            const int r = row_of(g0, w, W);
            acc[w] = x_s[r * X + H + c] * a_s[r];
          }
          for (int t = 0; t < nf; ++t) {
            const float vv = __ldg(vb + (size_t)(t0 + t) * V + c);
#pragma unroll
            for (int w = 0; w < G; ++w)
              acc[w] = fmaf(p_s[row_of(g0, w, W) * kFB + t], vv, acc[w]);
          }
#pragma unroll
          for (int w = 0; w < G; ++w)
            if (g0 + w < W) x_s[(g0 + w) * X + H + c] = acc[w];
        }
      }
      __syncthreads();
    }
    // ---- [embedding of the previous token | context]: the running context
    // over its sum
    for (int j = tid; j < X; j += kThreads) {
      if (j < H) {
        for (int w = 0; w < W; ++w)
          x_s[w * X + j] = u == 0 ? be[j] : we[(size_t)(sel_s[w] % L) * H + j] + be[j];
      } else {
        for (int w = 0; w < W; ++w) x_s[w * X + j] /= l_s[w];
      }
    }
    __syncthreads();
    // ---- stacked GRUCells
    const float* cw = cells;
    for (int li = 0; li < nl; ++li) {
      const int D = li == 0 ? X : H;
      const float* in = li == 0 ? x_s : hn_s + (size_t)(li - 1) * W * H;
      const int in_pitch = li == 0 ? X : H;
      const float* w_ih = cw;
      const float* w_hh = w_ih + (size_t)D * H3;
      const float* b_ih = w_hh + (size_t)H * H3;
      const float* b_hh = b_ih + H3;
      cw = b_hh + H3;
      const float* h = h_s + (size_t)li * W * H;
      for (int j = tid; j < H3; j += kThreads) {
        const float bi = b_ih[j], bh = b_hh[j];
        for (int g0 = 0; g0 < W; g0 += G) {
          float gi[G], gh[G];
#pragma unroll
          for (int w = 0; w < G; ++w) {
            gi[w] = bi;
            gh[w] = bh;
          }
#pragma unroll 8
          for (int k = 0; k < D; ++k) {
            const float wv = __ldg(w_ih + (size_t)k * H3 + j);
#pragma unroll
            for (int w = 0; w < G; ++w)
              gi[w] = fmaf(in[row_of(g0, w, W) * in_pitch + k], wv, gi[w]);
          }
#pragma unroll 8
          for (int k = 0; k < H; ++k) {
            const float wv = __ldg(w_hh + (size_t)k * H3 + j);
#pragma unroll
            for (int w = 0; w < G; ++w)
              gh[w] = fmaf(h[row_of(g0, w, W) * H + k], wv, gh[w]);
          }
#pragma unroll
          for (int w = 0; w < G; ++w) {
            const int r = g0 + w;
            if (r >= W) continue;
            if (j < 2 * H) {
              rz_s[r * 2 * H + j] = gi[w] + gh[w];
            } else {
              gin_s[r * H + j - 2 * H] = gi[w];
              ghn_s[r * H + j - 2 * H] = gh[w];
            }
          }
        }
      }
      __syncthreads();
      float* hn = hn_s + (size_t)li * W * H;
      for (int e = tid; e < W * H; e += kThreads) {
        const int w = e / H, i = e % H;
        const float r = sigmoid_(rz_s[w * 2 * H + i]);
        const float z = sigmoid_(rz_s[w * 2 * H + H + i]);
        const float ng = tanhf(gin_s[e] + r * ghn_s[e]);
        hn[e] = ng + z * (h[e] - ng);
      }
      __syncthreads();
    }
    // ---- log-softmax over the labels, extensions of the live beams
    matvec<G>(wl, bl, hn_s + (size_t)(nl - 1) * W * H, H, H, L, ext_s, L, W);
    __syncthreads();
    for (int w = warp; w < W; w += kWarps) {
      float* x = ext_s + w * L;
      float m = -INFINITY;
      for (int l = lane; l < L; l += 32) m = fmaxf(m, x[l]);
      m = warp_max(m);
      float s = 0.0f;
      for (int l = lane; l < L; l += 32) s += expf(x[l] - m);
      const float lse = logf(warp_sum(s));
      const float sc = score_s[w];
      for (int l = lane; l < L; l += 32)
        x[l] = (u == 0 && w > 0) ? -INFINITY : sc + ((x[l] - m) - lse);
    }
    __syncthreads();
    // ---- top W of the W x L extensions, best first: W rounds of a block
    // argmax (larger value, then smaller index); the winner is knocked out
    for (int r = 0; r < W; ++r) {
      float bv = -INFINITY;
      int bi = 0x7fffffff;
      for (int e = tid; e < WL; e += kThreads) {
        const float v = ext_s[e];
        if (better(v, e, bv, bi)) {
          bv = v;
          bi = e;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (better(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (lane == 0) {
        red_v[warp] = bv;
        red_i[warp] = bi;
      }
      __syncthreads();
      if (tid == 0) {
        for (int k = 1; k < kWarps; ++k) {
          if (better(red_v[k], red_i[k], bv, bi)) {
            bv = red_v[k];
            bi = red_i[k];
          }
        }
        sel_s[r] = bi;
        newscore_s[r] = bv;
        hist_s[u * W + r] = bi;
        ext_s[bi] = __int_as_float(0x7fc00000);  // NaN: taken
      }
      __syncthreads();
    }
    // ---- new beam j continues old beam sel_j / L
    if (tid < W) score_s[tid] = newscore_s[tid];
    for (int e = tid; e < nl * W * H; e += kThreads) {
      const int li = e / (W * H), j = (e / H) % W, i = e % H;
      h_s[e] = hn_s[((size_t)li * W + sel_s[j] / L) * H + i];
    }
    __syncthreads();
  }

  if (tid < W) {
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
}

template <int G, bool WIDE, bool GLOBAL>
cudaError_t launch(const float* keys, const float* values, const long long* n_valid,
                   const float* wq, const float* bq, const float* we, const float* be,
                   const float* cells, const float* wl, const float* bl, const float* init,
                   float* scores, long long* tokens, float* ws, Dims d, cudaStream_t st) {
  const size_t smem = GLOBAL ? sizeof(float) * 2 * kWarps
                             : sizeof(float) * make_plan(d.W, d.nl, d.H, d.K, d.V, d.L, d.U).total;
  auto kernel = beam_decode_kernel<G, WIDE, GLOBAL>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<d.B, kThreads, smem, st>>>(keys, values, n_valid, wq, bq, we, be, cells, wl, bl, init,
                                      scores, tokens, ws, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of one CTA's plan: its dynamic shared memory under the smem plan,
// its slice of the workspace under the global plan; no T term.
long long tsl_beam_decode_smem_bytes(int W, int nl, int H, int K, int V, int L, int U) {
  return (long long)sizeof(float) * make_plan(W, nl, H, K, V, L, U).total;
}

// The whole beam search of B utterances, one CTA each. keys (B, T, K) and
// values (B, T, V) row-major f32; n_valid (B,) int64 valid frame counts, each
// in [1, T]. Weights in the JAX layout, (in, out) row-major: wq (H, K), bq
// (K), we (L, H), be (H), wl (H, L), bl (L), init (nl, H); cells packs, per
// layer, w_ih (in, 3H) (in = H + V for layer 0, H after it), w_hh (H, 3H),
// b_ih (3H) and b_hh (3H). Writes scores (W, B) best-first and tokens (W, B,
// U) int64. W >= 1. workspace null: the smem plan, which must fit a block;
// else the global plan, in workspace of B x tsl_beam_decode_smem_bytes bytes.
// Returns cudaSuccess (0) or the first error of the launch; does not
// synchronise.
int tsl_beam_decode(const float* keys, const float* values, const long long* n_valid,
                    const float* wq, const float* bq, const float* we, const float* be,
                    const float* cells, const float* wl, const float* bl, const float* init,
                    float* scores, long long* tokens, float* workspace, int B, int T, int W,
                    int nl, int H, int K, int V, int L, int U, void* stream) {
  const Dims d{B, T, W, nl, H, K, V, L, U};
  cudaStream_t st = (cudaStream_t)stream;
#define TSL_BEAM(GV, WIDEV, GLOBALV)                                                          \
  (int)launch<GV, WIDEV, GLOBALV>(keys, values, n_valid, wq, bq, we, be, cells, wl, bl, init, \
                                  scores, tokens, workspace, d, st)
  if (W < 1) return (int)cudaErrorInvalidValue;
  if (workspace != nullptr) return TSL_BEAM(kGroup, true, true);
  switch (W) {
    case 1:
      return TSL_BEAM(1, false, false);
    case 2:
      return TSL_BEAM(2, false, false);
    case 3:
      return TSL_BEAM(3, false, false);
    case 4:
      return TSL_BEAM(4, false, false);
    case 5:
      return TSL_BEAM(5, false, false);
    case 6:
      return TSL_BEAM(6, false, false);
    case 7:
      return TSL_BEAM(7, false, false);
    case 8:
      return TSL_BEAM(8, false, false);
    default:
      return TSL_BEAM(kGroup, true, false);
  }
#undef TSL_BEAM
}

}  // extern "C"
