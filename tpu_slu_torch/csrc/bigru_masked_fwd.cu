// Length-masked GRU layer, forward: K4f (bidirectional) and K5f
// (unidirectional), for sm_90a.
//
// K4f replaces the TPU kernel `_fused_fwd_kernel` in tpu_slu/ops/pallas_gru.py:323
// (`pallas_call` at :378), reached on the length-exact path through
// `gru_apply_masked` -> `bigru_apply_pallas_streams` -> `_bigru_streams` ->
// `_bigru_seq_for` -> `_fused_fwd_call`. Same function as the TPU kernel
// serves there: a bidirectional GRU over a batch-major (B, T, D) input whose
// row b holds n_b valid frames; the forward direction walks t = 0..n_b-1,
// the backward direction t = n_b-1..0, each from h0 = 0, and both write
// exact zeros at t >= n_b. Row b's outputs equal the layer run on that
// example alone at T = n_b (the `reverse_padded` construction of
// tpu_slu/ops/gru.py `gru_apply_masked`).
//
// K5f replaces the TPU kernel `_fused1_fwd_kernel` (pallas_gru.py:138,
// `pallas_call` at :174), every unidirectional GRU layer's forward, reached
// through `gru_apply` -> `gru_apply_pallas` -> `_run_direction` ->
// `_gru1_seq_for` (exact shape and training) and through `gru_apply_masked`
// on `{"fwd"}` (length-exact). It is the same masked recurrence with one
// direction: row b walks t = 0..n_b-1 and writes zeros at t >= n_b; with
// every n_b = T (no lengths) it is the TPU kernel's function exactly. The
// TPU kernel pads T to its time block and projects the input block by block
// inside the kernel; here the projection runs first, over all rows, and the
// recurrence steps over the valid frames only.
//
// The TPU's K4f takes the backward direction's input already reversed per
// example (`reverse_padded(x, n)`, a copy in HBM) because its BlockSpecs cut
// contiguous time blocks. A CUDA block computes its own addresses, so here
// nothing is reversed or copied: the backward direction reads gi and writes
// h at t = n_b - 1 - s at step s.
//
// What bounds both on this card: as K1, the serial chain of (B, H) x (H,
// 3H) products, latency-bound at the small batches they serve (a served
// batch is 8 rows, 775 steps over the flagship's five layers); what counts
// is the time of one step. The length masking costs a few integer
// operations per element.
//
// What the design does about it:
//   * the GEMM core (bigru_gemm.cuh) computes every direction's gi for all
//     (b, t) at once over the natural-order input, off the chain;
//   * the recurrence is the cluster recurrence of gru_cluster.cuh
//     (`gru_cluster_kernel`, which K1 and K2 instantiate too), batch-major,
//     with the rows' lengths: a thread-block cluster of C CTAs a (batch
//     tile, direction), W_hh split by hidden unit and held in registers,
//     each step's h sent to every CTA by st.async and awaited on a
//     per-buffer mbarrier, gi through a cp.async ring; K4f runs both
//     directions' clusters side by side in one grid, K5f one direction;
//   * a tile steps only while a row of it still has valid frames (the
//     largest n_b of the tile) and writes exact zeros at frame s >= n_b of
//     each row during the walk, then on [max n_b, T) after it: a padded row
//     with n_b = 0 costs no step;
//   * K4f's directions write into one (B, T, 2H) output at column offsets
//     0 and H, so the layer's output needs no concat;
//   * no pool is fused: the pools run after the layer in PyTorch.
// The cluster size follows the batch: K4f takes K1's two-direction rule
// (`gru_cluster_size(B, 2)`: 4 while its 8 B CTAs fill at most three
// quarters of the SMs, B <= 12 on 132, else 2), K5f the one-direction rule
// (4 while every batch row gets a cluster of its own within one wave, else
// 2); gru_cluster.cuh gives the A/Bs behind both. f32 operands and
// accumulation throughout; H <= 128, H % 4 == 0.
//
// At compute_dtype=bfloat16 (`tsl_bigru_masked_fwd_bf16`, the seq2seq
// encoder layer of a bf16 trainer; `tsl_gru1_fwd_bf16`, its unidirectional
// layers) x and the output are bf16 and the TPU kernels' rounding points
// are kept (pallas_gru.py:349-362, :154-161): the projection reads the bf16
// x and W_ih rounded to bf16 (the GEMM core's mixed kernel), gi and the
// carry stay f32, h is rounded for the recurrent product only (the
// template's bf16 instantiation) and once for the output.

#include "bigru_common.cuh"
#include "gru_cluster.cuh"

namespace {

// K4f (ndir 2) and K5f (ndir 1): the GEMM core's projection of each
// direction into the (ndir, B, T, 3H) scratch gi, then the batch-major
// masked recurrence on clusters of the size gru_cluster_size(B, ndir)
// picks, direction d writing columns [d H, (d + 1) H) of the (B, T, ndir H)
// output. TS: x's and the output's type (f32, or bf16: the f32 weights
// rounded to bf16 as they are read); the weights, the biases and gi f32.
template <typename TS = float>
cudaError_t masked_forward(int ndir, const TS* x, int D, const long long* lengths,
                           const float* wih_f, const float* bih_f, const float* whh_f,
                           const float* bhh_f, const float* wih_b, const float* bih_b,
                           const float* whh_b, const float* bhh_b, float* gi, TS* out, int T,
                           int B, int H, cudaStream_t st) {
  if (H % 4 != 0 || H > kGruMaxH) return cudaErrorInvalidValue;
  int C = 4;
  cudaError_t err = gru_cluster_size(B, ndir, &C);
  if (err != cudaSuccess) return err;
  err = launch_gi_proj(x, D, nullptr, 0, wih_f, bih_f, wih_b, bih_b, gi, B * T, 3 * H, ndir, st);
  if (err != cudaSuccess) return err;
  ClusterRecT<TS> a = {};
  a.gi = gi;
  a.gi_dir = (long long)B * T * 3 * H;
  a.gi_b = (long long)T * 3 * H;
  a.gi_t = 3 * H;
  a.lengths = lengths;
  a.whh[0] = whh_f;
  a.whh[1] = whh_b;
  a.bhh[0] = bhh_f;
  a.bhh[1] = bhh_b;
  a.out[0] = out;
  a.out[1] = out + H;
  a.out_b = (long long)T * ndir * H;
  a.out_t = ndir * H;
  a.T = T;
  a.B = B;
  a.H = H;
  a.pool = 1;
  return gru_cluster_rec<false, false, false, TS>(a, ndir, C, st);
}

}  // namespace

extern "C" {

// Forward of one length-masked bidirectional GRU layer (K4f). x is (B, T,
// D) row-major, lengths (B,) int64 valid frame counts (clamped to [0, T]).
// Weights are in torch layout: W_ih (3H, D), W_hh (3H, H), biases (3H).
// gi_scratch holds 2*B*T*3H floats; out holds B*T*2H floats (h_f in
// columns [0, H), h_b in [H, 2H)). H must be a multiple of 4 and at most
// 128. Returns cudaSuccess (0) or the first error of a launch; does not
// synchronise.
int tsl_bigru_masked_fwd(
    const float* x, int D, const long long* lengths,
    const float* wih_f, const float* bih_f, const float* whh_f, const float* bhh_f,
    const float* wih_b, const float* bih_b, const float* whh_b, const float* bhh_b,
    float* gi_scratch, float* out, int T, int B, int H, void* stream) {
  return (int)masked_forward(2, x, D, lengths, wih_f, bih_f, whh_f, bhh_f, wih_b, bih_b, whh_b,
                             bhh_b, gi_scratch, out, T, B, H, (cudaStream_t)stream);
}

// Forward of one unidirectional GRU layer (K5f): x (B, T, D) row-major,
// lengths (B,) int64 valid frame counts (clamped to [0, T]) or nullptr for
// T frames in every row; weights in torch layout as tsl_bigru_masked_fwd.
// gi_scratch holds B*T*3H floats; out holds B*T*H floats. H must be a
// multiple of 4 and at most 128. Returns cudaSuccess (0) or the first error
// of a launch; does not synchronise.
int tsl_gru1_fwd(const float* x, int D, const long long* lengths, const float* wih,
                 const float* bih, const float* whh, const float* bhh, float* gi_scratch,
                 float* out, int T, int B, int H, void* stream) {
  return (int)masked_forward(1, x, D, lengths, wih, bih, whh, bhh, nullptr, nullptr, nullptr,
                             nullptr, gi_scratch, out, T, B, H, (cudaStream_t)stream);
}

// tsl_bigru_masked_fwd and tsl_gru1_fwd on bf16 storage (compute_dtype=
// bfloat16): x and out bf16; the weights (rounded to bf16 as they are
// read), the biases and gi_scratch f32, as there. h is rounded to bf16 for
// the recurrent product only and once for its output; a row still writes
// exact zeros past its length.
int tsl_bigru_masked_fwd_bf16(
    const __nv_bfloat16* x, int D, const long long* lengths,
    const float* wih_f, const float* bih_f, const float* whh_f, const float* bhh_f,
    const float* wih_b, const float* bih_b, const float* whh_b, const float* bhh_b,
    float* gi_scratch, __nv_bfloat16* out, int T, int B, int H, void* stream) {
  return (int)masked_forward(2, x, D, lengths, wih_f, bih_f, whh_f, bhh_f, wih_b, bih_b, whh_b,
                             bhh_b, gi_scratch, out, T, B, H, (cudaStream_t)stream);
}

int tsl_gru1_fwd_bf16(const __nv_bfloat16* x, int D, const long long* lengths, const float* wih,
                      const float* bih, const float* whh, const float* bhh, float* gi_scratch,
                      __nv_bfloat16* out, int T, int B, int H, void* stream) {
  return (int)masked_forward(1, x, D, lengths, wih, bih, whh, bhh, nullptr, nullptr, nullptr,
                             nullptr, gi_scratch, out, T, B, H, (cudaStream_t)stream);
}

// The cluster size tsl_gru1_fwd takes at batch B on the current device (2 or
// 4); -1 on a CUDA error.
int tsl_gru1_cluster_size(int B) {
  int C = 0;
  return gru_cluster_size(B, 1, &C) == cudaSuccess ? C : -1;
}

}  // extern "C"
