// Shared-stream bidirectional GRU layer, TRAIN forward with fused dropout
// and ceil avg-pool (K2), for sm_90a.
//
// Replaces the TPU kernel `_mk_trainpool_fwd_kernel` in
// tpu_slu/ops/pallas_gru.py:1146 (reached through `_trainpool_fwd_call` and
// `_shared_trainpool_core_for`). Same function: K1's forward over one
// natural-order stream of 1 or 2 parts, plus, in the epilogue of each step,
//   * the previous-step h of each direction stored at natural t (hp_f[t] =
//     h_f[t-1], hp_b[t] = h_b[t+1], zero where the walk starts): the
//     residuals K3 (bigru_shared_bwd.cu) recomputes the gates from;
//   * dropout at the full frame rate (kept: h / (1 - p)), with the keep
//     mask of `_keep_mask` computed in device code from a per-layer uint32
//     seed on the natural (t, b, h) coordinates, b the global batch row, so
//     that K3 regenerates it bit for bit and nothing is stored;
//   * the ceil-mode avg pool of the dropped h, dividing a trailing partial
//     window by its in-range count (torch semantics), so the layer's outputs
//     are written at the pooled rate only.
// Any T is taken as it is: the TPU kernel's padding to its time block has
// no counterpart here.
//
// What bounds it on this card: as K1, the serial T-step chain of (B, H) x
// (H, 3H) products, latency-bound at the small batch tiles it runs (B = 64,
// the train batch: 750 steps over the four encoder layers); a step's time
// is what counts. The extra work per step (one store of h_prev, the hash)
// is a few integer and memory operations per element, off the recurrent
// product, but it sits in the lane that also sends h to the cluster.
//
// What the design does about it: it is K1 (bigru_shared_fwd.cu) with the
// template's TRAIN flag set (`bigru_cluster_forward<true>` in
// gru_cluster.cuh): the GEMM core computes the input projection
// of both directions for all T at once, off the chain; the recurrence is
// the cluster recurrence of gru_cluster.cuh, a cluster of C CTAs a (batch
// tile, direction) with the W_hh slice of its hidden units in registers,
// each step's undropped h sent to every CTA by st.async, both directions
// side by side in one grid. The lane that runs the gate math of (row,
// unit) stores h_prev, drops and pools in registers, and writes the
// output at the pooled rate. C and the batch tile follow the batch as
// K1's (`gru_cluster_size(B, 2)`). f32 throughout; H <= 128, H % 4 == 0.
//
// At compute_dtype=bfloat16 (`tsl_bigru_trainpool_fwd_bf16`) the parts,
// h_prev and the pooled outputs are bf16, as the TPU kernel stores them
// (pallas_gru.py:1196-1230), and the f32 weights are rounded to bf16 as
// they are read: the template's bf16 instantiation keeps
// the f32 carry, rounds h for the recurrent product, stores h_prev rounded,
// and drops and pools the f32 h before it rounds the pooled value once.

#include "bigru_common.cuh"
#include "gru_cluster.cuh"

extern "C" {

// Train forward of one bidirectional GRU layer. Arguments as
// tsl_bigru_shared_fwd, plus hp_f and hp_b (T*B*H floats each), the uint32
// dropout seed, thresh = round((1 - p) * 2^24) (2^24 keeps every element)
// and inv_keep = 1 / (1 - p). The pool is always avg; pool = 1 leaves the
// outputs at full rate. H must be a multiple of 4 and at most 128. Returns
// cudaSuccess (0) or the first launch error; does not synchronise.
int tsl_bigru_trainpool_fwd(
    const float* x1, int d1, const float* x2, int d2,
    const float* wih_f, const float* bih_f, const float* whh_f, const float* bhh_f,
    const float* wih_b, const float* bih_b, const float* whh_b, const float* bhh_b,
    float* gi_scratch, float* hp_f, float* hp_b, float* out_f, float* out_b,
    int T, int B, int H, int pool, unsigned int seed, unsigned int thresh, float inv_keep,
    void* stream) {
  return (int)bigru_cluster_forward<true>(x1, d1, x2, d2, wih_f, bih_f, whh_f, bhh_f, wih_b,
                                          bih_b, whh_b, bhh_b, gi_scratch, out_f, out_b, hp_f,
                                          hp_b, T, B, H, pool, 0, seed, thresh, inv_keep,
                                          (cudaStream_t)stream);
}

// tsl_bigru_trainpool_fwd on bf16 storage: x1, x2, hp_f, hp_b, out_f and
// out_b are bf16; the weights (rounded to bf16 as they are read), the
// biases and gi_scratch f32.
int tsl_bigru_trainpool_fwd_bf16(
    const __nv_bfloat16* x1, int d1, const __nv_bfloat16* x2, int d2,
    const float* wih_f, const float* bih_f, const float* whh_f, const float* bhh_f,
    const float* wih_b, const float* bih_b, const float* whh_b, const float* bhh_b,
    float* gi_scratch, __nv_bfloat16* hp_f,
    __nv_bfloat16* hp_b, __nv_bfloat16* out_f, __nv_bfloat16* out_b, int T, int B, int H,
    int pool, unsigned int seed, unsigned int thresh, float inv_keep, void* stream) {
  return (int)bigru_cluster_forward<true, __nv_bfloat16>(
      x1, d1, x2, d2, wih_f, bih_f, whh_f, bhh_f, wih_b, bih_b, whh_b, bhh_b, gi_scratch, out_f,
      out_b, hp_f, hp_b, T, B, H, pool, 0, seed, thresh, inv_keep, (cudaStream_t)stream);
}

}  // extern "C"
