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
//   * `bigru_rec_kernel` runs one CTA per (batch tile, direction). W_hh
//     (3H x H, torch layout) is copied once into shared memory and stays
//     there for all T steps; h and the pool accumulator live in shared
//     memory too. Thread j < 3H owns gate column j of the recurrent product
//     and reads its W_hh row and h with 128-bit loads; the row pitch is
//     32k + 4 floats so that those loads are free of bank conflicts.
//   * The batch tile is as small as the card allows (1, 2, 4 or 8 rows, the
//     least that keeps the CTAs within one wave of the SMs): a step's time
//     grows with the rows a CTA carries, and the CTAs run side by side.
//   * A step issues its gi loads before the recurrent product, which does
//     not depend on them, so their latency overlaps the product.
//   * f32 operands and f32 accumulation throughout (no tensor cores yet).
// The projection and the recurrence live in bigru_common.cuh, where K2
// (bigru_trainpool_fwd.cu) takes the same recurrence with its train flag set.
// Which resource sets the time of one step is not measured yet (no hardware
// counters have been read for this kernel). Candidates: the shared-memory
// reads of all of W_hh (192 KiB at H = 128) per step, each thread's serial
// H-long FMA chain, the two barriers per step, and too few warps per SM to
// hide latency. Splitting W_hh over a cluster of SMs, keeping it in
// registers, wgmma and bf16 operands are later work.
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
// 128, against 227 KB), so K6 keeps K1's CTA per (batch tile, direction),
// each reading its half of row s. A 2-CTA cluster sharing the step through
// distributed shared memory was not taken: the two directions' chains share
// no data, so a cluster would add a cluster barrier a step and exchange
// nothing. What K6 changes on this card is the scratch layout (both
// directions' rows of a step adjacent) and two fewer bias adds a gate
// column a step; its bound is K1's.

#include "bigru_common.cuh"

extern "C" {

const char* tsl_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Forward of one bidirectional GRU layer over natural-order time-major
// parts. x2 may be null with d2 == 0. Weights are in torch layout: W_ih
// (3H, d1 + d2), W_hh (3H, H), biases (3H). gi_scratch holds 2*T*B*3H
// floats; out_f and out_b hold ceil(T/pool)*B*H floats each. H must be a
// multiple of 4. Returns cudaSuccess (0) or the first error of a launch;
// does not synchronise.
int tsl_bigru_shared_fwd(
    const float* x1, int d1, const float* x2, int d2,
    const float* wih_f, const float* bih_f, const float* whh_f, const float* bhh_f,
    const float* wih_b, const float* bih_b, const float* whh_b, const float* bhh_b,
    float* gi_scratch, float* out_f, float* out_b,
    int T, int B, int H, int pool, int pool_max, void* stream) {
  return (int)bigru_forward<false>(x1, d1, x2, d2, wih_f, bih_f, whh_f, bhh_f, wih_b, bih_b,
                                   whh_b, bhh_b, gi_scratch, out_f, out_b, nullptr, nullptr, T,
                                   B, H, pool, pool_max, 0u, kKeepAll, 1.0f,
                                   (cudaStream_t)stream);
}

// K6: as tsl_bigru_shared_fwd, with gi_scratch (2*T*B*3H floats) holding
// the row-stacked (T, 2B, 3H) projection, b_hh's r and z columns folded in.
int tsl_bigru_shared_fwd_rs(
    const float* x1, int d1, const float* x2, int d2,
    const float* wih_f, const float* bih_f, const float* whh_f, const float* bhh_f,
    const float* wih_b, const float* bih_b, const float* whh_b, const float* bhh_b,
    float* gi_scratch, float* out_f, float* out_b,
    int T, int B, int H, int pool, int pool_max, void* stream) {
  return (int)bigru_forward<false, true>(x1, d1, x2, d2, wih_f, bih_f, whh_f, bhh_f, wih_b, bih_b,
                                         whh_b, bhh_b, gi_scratch, out_f, out_b, nullptr, nullptr,
                                         T, B, H, pool, pool_max, 0u, kKeepAll, 1.0f,
                                         (cudaStream_t)stream);
}

}  // extern "C"
