// Shared-stream bidirectional GRU layer, forward (eval), for sm_90a: K1 and
// its row-stacked layout K6.
//
// Replaces the TPU kernel `_mk_shared_fwd_kernel` in
// tpu_slu/ops/pallas_gru.py (reached through `_shared_fwd_call` and
// `bigru_apply_shared`). Same function: both directions read ONE
// natural-order time-major stream of 1 or 2 parts (T, B, D_p); the forward
// direction walks t = 0..T-1, the backward direction walks t = T-1..0 over
// the same stream (no flipped copy); gi = [x1 | x2] @ W_ih^T + b_ih reads
// each part at its column offset into W_ih (no concatenated copy); an
// optional ceil-mode avg/max pool (torch's partial-window divisor) runs in
// the epilogue, so outputs are written at the pooled rate only. Any T is
// taken as it is: the TPU kernel's padding to its time block, and the
// zero-hold of the backward carry through the pad rows, have no
// counterpart here.
//
// What bounds it on this card: the serial T-step chain of (B, H) x (H, 3H)
// products and the gate math between them. At small B a step is a few
// hundred thousand FLOPs, far too little to fill the card, so the layer is
// latency-bound: what counts is the time of one step, not throughput.
//
// What the design does about it:
//   * The input projection, which has no serial dependence, leaves the
//     chain: the GEMM core (bigru_gemm.cuh) computes it for all T at once
//     as one product over (T*B) x 3H for both directions, into a (2, T, B,
//     3H) scratch.
//   * The recurrence is the cluster recurrence of gru_cluster.cuh, which
//     K2, K4f and K5f instantiate too, here with two directions, time-major
//     strides and the pool (`bigru_cluster_forward<false>`, which K2 shares
//     with its TRAIN flag set): a thread-block cluster of C CTAs a (batch tile,
//     direction), CTA c owning the r, z and n rows of W_hh for hidden units
//     [c H/C, (c+1) H/C) in registers; each step's h goes to every CTA of
//     the cluster by st.async into distributed shared memory, counted on a
//     per-buffer mbarrier (no cluster barrier a step); gi arrives through a
//     cp.async ring. Both directions' clusters share the grid and run side
//     by side.
//   * The ceil pool runs in the epilogue: the lane that runs the gate math
//     of (row, unit) keeps the window's sum or max in a register and writes
//     only at the pooled rate.
//   * The cluster size follows the batch (`gru_cluster_size(B, 2)`): 4 while
//     the 2 x 4 x B CTAs fill at most three quarters of the SMs (B <= 12 on
//     132), else 2, with the smallest batch tile that fits one wave. The
//     one-CTA design it replaces (`bigru_rec_kernel`, now K6's alone) read
//     all of W_hh (192 KB at H = 128) from shared memory every step behind
//     two CTA barriers, a ~2.6 us step at B = 16 on 32 of 132 SMs.
//   * f32 operands and f32 accumulation throughout (no tensor cores).
// H <= 128 (the W_hh slice's registers), H % 4 == 0.
//
// K6, the row-stacked layout (`tsl_bigru_shared_fwd_rs`), replaces the TPU
// kernel `_mk_shared_fwd_kernel_rs` (tpu_slu/ops/pallas_gru.py:887,
// `pallas_call` at :1047). Same function as K1, laid out differently: the
// projection writes both directions' gi into ONE (T, 2B, 3H) array, forward
// rows 0:B at t = s and backward rows B:2B pre-reversed (row s holds t = T -
// 1 - s), so that step s of either direction reads row s; b_hh's r and z
// columns are folded into b_ih there, and only b_hh's n column stays in the
// recurrence, inside r * (W_hn h + b_hn). On the TPU the layout let one
// (2B, 3H) elementwise chain serve both directions. Here both directions'
// W_hh cannot share one SM in f32 (2 x 3H x (H + 4) x 4 B = 405 KB at H =
// 128, against 227 KB), so K6 keeps a CTA per (batch tile, direction),
// each reading its half of row s, on the one-CTA recurrence
// `bigru_rec_kernel<NB>` (below). What K6 changes on
// this card is the scratch layout (both directions' rows of a step adjacent)
// and two fewer bias adds a gate column a step; its bound is K1's.

#include "bigru_common.cuh"
#include "gru_cluster.cuh"

namespace {

// Pitch in floats of a W_hh row in K6's shared memory:
// 32k + 4, so that the 128-bit row loads of a step are free of bank conflicts.
__host__ __device__ inline int whh_pitch(int H) { return (H + 31) / 32 * 32 + 4; }

// K6's recurrence, row-stacked: gi is the (T, 2B, 3H) array, step s reading
// row s of both directions (the backward rows pre-reversed); the r and z
// columns of the recurrent product take no bias (folded into gi), the n
// column takes b_hh's after the product. One CTA per (batch tile of NB
// rows, direction); blockDim.x >= 3H. Thread j < 3H owns gate column j of
// the recurrent product and reads its W_hh row and h with 128-bit loads; h
// and the pool accumulator live in shared memory. The ceil pool (avg or
// max) runs in the epilogue of each step, so outputs are written at the
// pooled rate only.
template <int NB>
__global__ void bigru_rec_kernel(
    const float* __restrict__ gi,  // (T, 2B, 3H)
    const float* __restrict__ whh_f, const float* __restrict__ bhh_f,
    const float* __restrict__ whh_b, const float* __restrict__ bhh_b,
    float* __restrict__ out_f, float* __restrict__ out_b,  // (ceil(T/pool), B, H)
    int T, int B, int H, int pool, int pool_max) {
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
  const float* __restrict__ gid = gi + (size_t)dir * B * H3;
  float* __restrict__ out = dir == 0 ? out_f : out_b;
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int e = tid; e < H3 * H; e += nt) w_s[(e / H) * HP + e % H] = whh[e];
  for (int e = tid; e < NB * H; e += nt) h_s[e] = 0.0f;
  const float bj = tid < H3 && tid >= 2 * H ? bhh[tid] : 0.0f;
  __syncthreads();

  // gate-phase elements per thread: NB*H <= kIt * nt because nt >= 3H
  constexpr int kIt = (NB + 2) / 3;
  const int H4 = H / 4;
  for (int s = 0; s < T; ++s) {
    const int t = dir == 0 ? s : T - 1 - s;
    const float* __restrict__ git = gid + ((size_t)s * 2 * B + b0) * H3;
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
      for (int b = 0; b < NB; ++b) acc[b] = 0.0f;
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
        if (b < nb) gh_s[b * H3 + tid] = acc[b] + bj;
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
        float a = hn;
        if (!first) a = pool_max ? fmaxf(pacc_s[e], hn) : pacc_s[e] + hn;
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

template <int NB>
cudaError_t launch_rec(const float* gi, const float* whh_f, const float* bhh_f,
                       const float* whh_b, const float* bhh_b, float* out_f, float* out_b, int T,
                       int B, int H, int pool, int pool_max, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * ((size_t)3 * H * whh_pitch(H) + (size_t)NB * H * 5);
  cudaError_t err = cudaFuncSetAttribute(
      bigru_rec_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int threads = (3 * H + 31) / 32 * 32;
  dim3 grid((B + NB - 1) / NB, 2);
  bigru_rec_kernel<NB><<<grid, threads, smem, st>>>(gi, whh_f, bhh_f, whh_b, bhh_b, out_f, out_b,
                                                    T, B, H, pool, pool_max);
  return cudaGetLastError();
}

// K6: the row-stacked input projection, then its recurrence at the batch
// tile pick_batch_tile chooses.
inline cudaError_t bigru_forward_rs(const float* x1, int d1, const float* x2, int d2,
                                    const float* wih_f, const float* bih_f, const float* whh_f,
                                    const float* bhh_f, const float* wih_b, const float* bih_b,
                                    const float* whh_b, const float* bhh_b, float* gi_scratch,
                                    float* out_f, float* out_b, int T, int B, int H, int pool,
                                    int pool_max, cudaStream_t st) {
  cudaError_t err = launch_gi_proj_rs(x1, d1, x2, d2, wih_f, bih_f, bhh_f, wih_b, bih_b, bhh_b,
                                      gi_scratch, T, B, 3 * H, st);
  if (err != cudaSuccess) return err;
  int nb = 8;
  err = pick_batch_tile(B, &nb);
  if (err != cudaSuccess) return err;
#define TSL_REC(NBV) \
  launch_rec<NBV>(gi_scratch, whh_f, bhh_f, whh_b, bhh_b, out_f, out_b, T, B, H, pool, pool_max, st)
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

extern "C" {

const char* tsl_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Forward of one bidirectional GRU layer over natural-order time-major
// parts. x2 may be null with d2 == 0. Weights are in torch layout: W_ih
// (3H, d1 + d2), W_hh (3H, H), biases (3H). gi_scratch holds 2*T*B*3H
// floats; out_f and out_b hold ceil(T/pool)*B*H floats each. H must be a
// multiple of 4 and at most 128. The recurrence runs on clusters of the
// size gru_cluster_size(B, 2) picks. Returns cudaSuccess (0) or the first
// error of a launch; does not synchronise.
int tsl_bigru_shared_fwd(
    const float* x1, int d1, const float* x2, int d2,
    const float* wih_f, const float* bih_f, const float* whh_f, const float* bhh_f,
    const float* wih_b, const float* bih_b, const float* whh_b, const float* bhh_b,
    float* gi_scratch, float* out_f, float* out_b,
    int T, int B, int H, int pool, int pool_max, void* stream) {
  return (int)bigru_cluster_forward<false>(x1, d1, x2, d2, wih_f, bih_f, whh_f, bhh_f, wih_b,
                                           bih_b, whh_b, bhh_b, gi_scratch, out_f, out_b, nullptr,
                                           nullptr, T, B, H, pool, pool_max, 0u, kKeepAll, 1.0f,
                                           (cudaStream_t)stream);
}

// The cluster size tsl_bigru_shared_fwd takes at batch B on the current
// device (2 or 4); -1 on a CUDA error.
int tsl_bigru_shared_cluster_size(int B) {
  int C = 0;
  return gru_cluster_size(B, 2, &C) == cudaSuccess ? C : -1;
}

// K6: as tsl_bigru_shared_fwd, with gi_scratch (2*T*B*3H floats) holding
// the row-stacked (T, 2B, 3H) projection, b_hh's r and z columns folded in.
int tsl_bigru_shared_fwd_rs(
    const float* x1, int d1, const float* x2, int d2,
    const float* wih_f, const float* bih_f, const float* whh_f, const float* bhh_f,
    const float* wih_b, const float* bih_b, const float* whh_b, const float* bhh_b,
    float* gi_scratch, float* out_f, float* out_b,
    int T, int B, int H, int pool, int pool_max, void* stream) {
  return (int)bigru_forward_rs(x1, d1, x2, d2, wih_f, bih_f, whh_f, bhh_f, wih_b, bih_b, whh_b,
                               bhh_b, gi_scratch, out_f, out_b, T, B, H, pool, pool_max,
                               (cudaStream_t)stream);
}

}  // extern "C"
