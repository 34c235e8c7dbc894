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
//     K2, K4f, K5f and K6 instantiate too, here with two directions, time-major
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
//     one-CTA design it replaced read all of W_hh (192 KB at H = 128) from
//     shared memory every step behind two CTA barriers, a ~2.6 us step at
//     B = 16 on 32 of 132 SMs.
//   * f32 arithmetic and accumulation throughout (no tensor cores).
// H <= 128 (the W_hh slice's registers), H % 4 == 0.
//
// At compute_dtype=bfloat16 (`tsl_bigru_shared_fwd_bf16`, the test pass and
// the intent layer's train forward of a bf16 trainer) the parts and the
// outputs are bf16, the weights, the biases and the gi scratch f32: the
// projection reads the bf16 parts and W_ih rounded to bf16 into the GEMM
// core's f32 tiles (its mixed kernel), and the
// recurrence is the template's bf16 instantiation, which rounds h to bf16
// for the recurrent product only and rounds each output once, after the
// pool (the TPU kernel's points, pallas_gru.py:796-860). The bound is the
// same serial chain; half the stream bytes.
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
// W_hh cannot share one SM in f32, so K6 runs K1's cluster recurrence with
// the template's ROWS flag (step s reads row s in both directions, no b_hh
// on the r and z columns), on the same clusters, with strides gi_dir = B 3H,
// gi_b = 3H, gi_t = 2B 3H. What K6 changes on this card is the scratch
// layout (both directions' rows of a step adjacent) and two fewer bias adds
// a gate column a step; its bound and its step are K1's. At bf16
// (`tsl_bigru_shared_fwd_rs_bf16`, a bf16 trainer's intent layer and test
// pass on this layout) it rounds where the TPU kernel does
// (pallas_gru.py:924-995): the projection of bf16 parts against W_ih
// rounded to bf16 (the mixed GEMM), the fold in f32, h rounded for the
// recurrent products only, outputs rounded once, after the pool.

#include "bigru_common.cuh"
#include "gru_cluster.cuh"

namespace {

// K6: the row-stacked input projection, then the cluster recurrence on it at
// the cluster size gru_cluster_size(B, 2) picks; TS the parts' and the
// outputs' type (f32, or bf16 as K1's bf16 entry takes them).
template <typename TS = float>
inline cudaError_t bigru_forward_rs(const TS* x1, int d1, const TS* x2, int d2,
                                    const float* wih_f, const float* bih_f, const float* whh_f,
                                    const float* bhh_f, const float* wih_b, const float* bih_b,
                                    const float* whh_b, const float* bhh_b, float* gi_scratch,
                                    TS* out_f, TS* out_b, int T, int B, int H, int pool,
                                    int pool_max, cudaStream_t st) {
  if (H % 4 != 0 || H > kGruMaxH) return cudaErrorInvalidValue;
  int C = 4;
  cudaError_t err = gru_cluster_size(B, 2, &C);
  if (err != cudaSuccess) return err;
  err = launch_gi_proj_rs(x1, d1, x2, d2, wih_f, bih_f, bhh_f, wih_b, bih_b, bhh_b, gi_scratch, T,
                          B, 3 * H, st);
  if (err != cudaSuccess) return err;
  ClusterRecT<TS> a = {};
  a.gi = gi_scratch;
  a.gi_dir = (long long)B * 3 * H;
  a.gi_b = 3 * H;
  a.gi_t = 2LL * B * 3 * H;
  a.whh[0] = whh_f;
  a.whh[1] = whh_b;
  a.bhh[0] = bhh_f;
  a.bhh[1] = bhh_b;
  a.out[0] = out_f;
  a.out[1] = out_b;
  a.out_b = H;
  a.out_t = (long long)B * H;
  a.T = T;
  a.B = B;
  a.H = H;
  a.pool = pool;
  a.pool_max = pool_max;
  return pool > 1 ? gru_cluster_rec<true, false, true, TS>(a, 2, C, st)
                  : gru_cluster_rec<false, false, true, TS>(a, 2, C, st);
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
// the row-stacked (T, 2B, 3H) projection, b_hh's r and z columns folded in;
// the recurrence runs on the same clusters as K1's.
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

// tsl_bigru_shared_fwd on bf16 storage: x1, x2, out_f and out_b are bf16;
// the weights (rounded to bf16 as they are read), the biases and gi_scratch
// f32, as there. The outputs are h rounded to bf16 once, after the pool of
// the f32 h.
int tsl_bigru_shared_fwd_bf16(
    const __nv_bfloat16* x1, int d1, const __nv_bfloat16* x2, int d2,
    const float* wih_f, const float* bih_f, const float* whh_f, const float* bhh_f,
    const float* wih_b, const float* bih_b, const float* whh_b, const float* bhh_b,
    float* gi_scratch, __nv_bfloat16* out_f, __nv_bfloat16* out_b,
    int T, int B, int H, int pool, int pool_max, void* stream) {
  return (int)bigru_cluster_forward<false, __nv_bfloat16>(
      x1, d1, x2, d2, wih_f, bih_f, whh_f, bhh_f, wih_b, bih_b, whh_b, bhh_b, gi_scratch, out_f,
      out_b, nullptr, nullptr, T, B, H, pool, pool_max, 0u, kKeepAll, 1.0f, (cudaStream_t)stream);
}

// K6 on bf16 storage (tsl_bigru_shared_fwd_rs as tsl_bigru_shared_fwd_bf16
// takes K1's): x1, x2, out_f and out_b bf16; the weights (rounded to bf16 as
// they are read), the biases (b_hh's r and z columns folded into b_ih in
// f32) and gi_scratch f32. The outputs are h rounded to bf16 once, after the
// pool of the f32 h.
int tsl_bigru_shared_fwd_rs_bf16(
    const __nv_bfloat16* x1, int d1, const __nv_bfloat16* x2, int d2,
    const float* wih_f, const float* bih_f, const float* whh_f, const float* bhh_f,
    const float* wih_b, const float* bih_b, const float* whh_b, const float* bhh_b,
    float* gi_scratch, __nv_bfloat16* out_f, __nv_bfloat16* out_b,
    int T, int B, int H, int pool, int pool_max, void* stream) {
  return (int)bigru_forward_rs<__nv_bfloat16>(x1, d1, x2, d2, wih_f, bih_f, whh_f, bhh_f, wih_b,
                                              bih_b, whh_b, bhh_b, gi_scratch, out_f, out_b, T, B,
                                              H, pool, pool_max, (cudaStream_t)stream);
}

}  // extern "C"
