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
// Layout: one CTA per utterance, its W beams as W rows. Shared memory holds
// the utterance's keys and values (its valid frames only), the beams' states
// before and after the step, the step's scratch (query, attention weights,
// [embedding | context], gate pre-activations, extensions), the scores, and
// a backpointer per step and beam (w * L + l of the chosen extension). After
// the last step each final beam walks its backpointers back to u = 0 and
// writes its tokens: the same tokens as gathering the history at every step,
// without copying W x U ints per step. The TPU kernel's two attention modes
// (unrolled, blocked online softmax) and its routing by VMEM budget are not
// carried over: they are TPU measurements.
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

__device__ __forceinline__ float sigmoid_(float x) { return 1.0f / (1.0f + expf(-x)); }

struct Dims {
  int B, T, nl, H, K, V, L, U;
};

// Shared-memory plan, in 4-byte words; the kernel and the host share it.
struct Plan {
  long long k, v, h, hn, x, q, p, rz, gin, ghn, ext, score, newscore, red_v, red_i, sel, hist,
      total;
};

__host__ __device__ inline Plan make_plan(int T, int W, int nl, int H, int K, int V, int L,
                                          int U) {
  Plan p;
  long long o = 0;
  p.k = o;        o += (long long)T * K;        // keys of the valid frames
  p.v = o;        o += (long long)T * V;        // values of the valid frames
  p.h = o;        o += (long long)nl * W * H;   // live beams' states
  p.hn = o;       o += (long long)nl * W * H;   // states after this step, before the reorder
  p.x = o;        o += (long long)W * (H + V);  // [embedding | context]
  p.q = o;        o += (long long)W * K;        // query
  p.p = o;        o += (long long)W * T;        // attention scores, then weights
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

// out[w * out_pitch + j] = bias[j] + sum_d in[w * in_pitch + d] * wt[d * N + j],
// for j < N and the W rows; thread j owns column j (strided over the block).
// in lies in shared memory; wt (D, N) row-major and bias in global memory.
template <int W>
__device__ __forceinline__ void matvec(const float* __restrict__ wt, const float* __restrict__ bias,
                                       const float* in, int in_pitch, int D, int N, float* out,
                                       int out_pitch) {
  for (int j = threadIdx.x; j < N; j += kThreads) {
    float acc[W];
    const float b = bias[j];
#pragma unroll
    for (int w = 0; w < W; ++w) acc[w] = b;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float wv = __ldg(wt + (size_t)d * N + j);
#pragma unroll
      for (int w = 0; w < W; ++w) acc[w] = fmaf(in[w * in_pitch + d], wv, acc[w]);
    }
#pragma unroll
    for (int w = 0; w < W; ++w) out[w * out_pitch + j] = acc[w];
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

template <int W>
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
    Dims d) {
  extern __shared__ __align__(16) float smem[];
  const Plan pl = make_plan(d.T, W, d.nl, d.H, d.K, d.V, d.L, d.U);
  float* k_s = smem + pl.k;
  float* v_s = smem + pl.v;
  float* h_s = smem + pl.h;
  float* hn_s = smem + pl.hn;
  float* x_s = smem + pl.x;
  float* q_s = smem + pl.q;
  float* p_s = smem + pl.p;
  float* rz_s = smem + pl.rz;
  float* gin_s = smem + pl.gin;
  float* ghn_s = smem + pl.ghn;
  float* ext_s = smem + pl.ext;
  float* score_s = smem + pl.score;
  float* newscore_s = smem + pl.newscore;
  float* red_v = smem + pl.red_v;
  int* red_i = reinterpret_cast<int*>(smem + pl.red_i);
  int* sel_s = reinterpret_cast<int*>(smem + pl.sel);
  int* hist_s = reinterpret_cast<int*>(smem + pl.hist);

  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = d.T, H = d.H, K = d.K, V = d.V, L = d.L, nl = d.nl;
  const int H3 = 3 * H, X = H + V, WL = W * L;
  const long long nv = n_valid[b];
  const int n = (int)(nv < 1 ? 1 : (nv > T ? T : nv));
  const float scale = sqrtf((float)K);  // of the keys' true width

  for (int e = tid; e < n * K; e += kThreads) k_s[e] = keys[(size_t)b * T * K + e];
  for (int e = tid; e < n * V; e += kThreads) v_s[e] = values[(size_t)b * T * V + e];
  for (int e = tid; e < nl * W * H; e += kThreads) h_s[e] = init[(e / (W * H)) * H + e % H];
  if (tid < W) score_s[tid] = 0.0f;
  __syncthreads();

  for (int u = 0; u < d.U; ++u) {
    // ---- attention over the valid frames, query from the top layer's state
    matvec<W>(wq, bq, h_s + (size_t)(nl - 1) * W * H, H, H, K, q_s, K);
    __syncthreads();
    for (int e = tid; e < W * n; e += kThreads) {
      const int w = e / n, t = e % n;
      const float* q = q_s + w * K;
      const float* k = k_s + t * K;
      float s = 0.0f;
      for (int c = 0; c < K; ++c) s = fmaf(q[c], k[c], s);
      p_s[w * T + t] = s / scale;
    }
    __syncthreads();
    for (int w = warp; w < W; w += kWarps) {
      float* p = p_s + w * T;
      float m = -INFINITY;
      for (int t = lane; t < n; t += 32) m = fmaxf(m, p[t]);
      m = warp_max(m);
      float s = 0.0f;
      for (int t = lane; t < n; t += 32) {
        const float e = expf(p[t] - m);
        p[t] = e;
        s += e;
      }
      s = warp_sum(s);
      for (int t = lane; t < n; t += 32) p[t] /= s;
    }
    __syncthreads();
    // ---- [embedding of the previous token | context]
    for (int j = tid; j < X; j += kThreads) {
      if (j < H) {
#pragma unroll
        for (int w = 0; w < W; ++w)
          x_s[w * X + j] = u == 0 ? be[j] : we[(size_t)(sel_s[w] % L) * H + j] + be[j];
      } else {
        float acc[W];
#pragma unroll
        for (int w = 0; w < W; ++w) acc[w] = 0.0f;
        for (int t = 0; t < n; ++t) {
          const float vv = v_s[t * V + j - H];
#pragma unroll
          for (int w = 0; w < W; ++w) acc[w] = fmaf(p_s[w * T + t], vv, acc[w]);
        }
#pragma unroll
        for (int w = 0; w < W; ++w) x_s[w * X + j] = acc[w];
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
        float gi[W], gh[W];
        const float bi = b_ih[j], bh = b_hh[j];
#pragma unroll
        for (int w = 0; w < W; ++w) {
          gi[w] = bi;
          gh[w] = bh;
        }
#pragma unroll 8
        for (int k = 0; k < D; ++k) {
          const float wv = __ldg(w_ih + (size_t)k * H3 + j);
#pragma unroll
          for (int w = 0; w < W; ++w) gi[w] = fmaf(in[w * in_pitch + k], wv, gi[w]);
        }
#pragma unroll 8
        for (int k = 0; k < H; ++k) {
          const float wv = __ldg(w_hh + (size_t)k * H3 + j);
#pragma unroll
          for (int w = 0; w < W; ++w) gh[w] = fmaf(h[w * H + k], wv, gh[w]);
        }
#pragma unroll
        for (int w = 0; w < W; ++w) {
          if (j < 2 * H) {
            rz_s[w * 2 * H + j] = gi[w] + gh[w];
          } else {
            gin_s[w * H + j - 2 * H] = gi[w];
            ghn_s[w * H + j - 2 * H] = gh[w];
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
    matvec<W>(wl, bl, hn_s + (size_t)(nl - 1) * W * H, H, H, L, ext_s, L);
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

template <int W>
cudaError_t launch(const float* keys, const float* values, const long long* n_valid,
                   const float* wq, const float* bq, const float* we, const float* be,
                   const float* cells, const float* wl, const float* bl, const float* init,
                   float* scores, long long* tokens, Dims d, cudaStream_t st) {
  const size_t smem = sizeof(float) * make_plan(d.T, W, d.nl, d.H, d.K, d.V, d.L, d.U).total;
  cudaError_t err = cudaFuncSetAttribute(beam_decode_kernel<W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  beam_decode_kernel<W><<<d.B, kThreads, smem, st>>>(keys, values, n_valid, wq, bq, we, be, cells,
                                                     wl, bl, init, scores, tokens, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA of the search takes.
long long tsl_beam_decode_smem_bytes(int T, int W, int nl, int H, int K, int V, int L, int U) {
  return (long long)sizeof(float) * make_plan(T, W, nl, H, K, V, L, U).total;
}

// The whole beam search of B utterances, one CTA each. keys (B, T, K) and
// values (B, T, V) row-major f32; n_valid (B,) int64 valid frame counts, each
// in [1, T]. Weights in the JAX layout, (in, out) row-major: wq (H, K), bq
// (K), we (L, H), be (H), wl (H, L), bl (L), init (nl, H); cells packs, per
// layer, w_ih (in, 3H) (in = H + V for layer 0, H after it), w_hh (H, 3H),
// b_ih (3H) and b_hh (3H). Writes scores (W, B) best-first and tokens (W, B,
// U) int64. 1 <= W <= 8. Returns cudaSuccess (0) or the first error of the
// launch; does not synchronise.
int tsl_beam_decode(const float* keys, const float* values, const long long* n_valid,
                    const float* wq, const float* bq, const float* we, const float* be,
                    const float* cells, const float* wl, const float* bl, const float* init,
                    float* scores, long long* tokens, int B, int T, int W, int nl, int H, int K,
                    int V, int L, int U, void* stream) {
  const Dims d{B, T, nl, H, K, V, L, U};
  cudaStream_t st = (cudaStream_t)stream;
#define TSL_BEAM(WV)                                                                           \
  case WV:                                                                                     \
    return (int)launch<WV>(keys, values, n_valid, wq, bq, we, be, cells, wl, bl, init, scores, \
                           tokens, d, st)
  switch (W) {
    TSL_BEAM(1);
    TSL_BEAM(2);
    TSL_BEAM(3);
    TSL_BEAM(4);
    TSL_BEAM(5);
    TSL_BEAM(6);
    TSL_BEAM(7);
    TSL_BEAM(8);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TSL_BEAM
}

}  // extern "C"
