// The GEMM core of bigru_gemm.cuh in its three layouts, f32 and bf16, as C
// entry points, so that the card tests and chip_smoke.py hold each layout
// and mode against an f64 product of the same operands
// (tpu_slu_torch/ops/bigru_gemm.py). The kernels' own products reach the
// core through bigru_common.cuh and bigru_bwd_common.cuh; these entry
// points are not on any model's path.

#include "bigru_gemm.cuh"

extern "C" {

// out (M, N) = [x1 | x2] w^T + b: x1 (M, d1), x2 (M, d2; null with d2 = 0),
// w (N, d1 + d2), b (N) or null. Both operands contiguous along k.
int tsl_gemm_proj(const float* x1, int d1, const float* x2, int d2, const float* w,
                  const float* b, float* out, int M, int N, void* stream) {
  GemmArgs args = {};
  args.nprob = 1;
  args.p[0] = proj_problem(x1, d1, x2, d2, w, b, out, M, N);
  return (int)launch_proj(args, (cudaStream_t)stream);
}

// [dx1 | dx2] (M, d1 + d2) = sum_dir a[dir] w_dir: a (ndir, M, K), w_f and
// w_b (K, d1 + d2). A contiguous along k, B along n.
int tsl_gemm_dx(const float* a, int ndir, const float* w_f, const float* w_b, float* dx1, int d1,
                float* dx2, int d2, int M, int K, void* stream) {
  return (int)launch_dx(a, w_f, w_b, dx1, d1, dx2, d2, M, K, ndir, (cudaStream_t)stream);
}

// dw (K, d1 + d2) = a^T [x1 | x2] and db (K) = the column sums of a, over
// the M rows of a (M, K), x1 (M, d1) and x2 (M, d2; null with d2 = 0): both
// operands contiguous along their output index, the row-chunk split and its
// fixed-order reduce pass. K = 3H; `partial` holds
// tsl_bigru_shared_bwd_partial_floats(d1, d2, H, M, 1) floats.
int tsl_gemm_dw(const float* a, int K, const float* x1, int d1, const float* x2, int d2,
                float* partial, float* dw, float* db, int M, void* stream) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  return (int)weight_grads(a, K, x1, x2, nullptr, nullptr, d1, d2, partial, dw, db, nullptr,
                           nullptr, M, sms, (cudaStream_t)stream, 1);
}

// out (M, N, f32) = [x1 | x2] bf16(w)^T + b on the tensor cores: x1 (M, d1)
// and x2 (M, d2; null with d2 = 0) bf16 at any 2-byte offset, w (N, d1 + d2)
// f32 rounded to bf16 as it is read, b (N, f32) or null; f32 accumulation.
int tsl_gemm_proj_bf16(const __nv_bfloat16* x1, int d1, const __nv_bfloat16* x2, int d2,
                       const float* w, const float* b, float* out, int M, int N, void* stream) {
  GemmArgs args = {};
  args.nprob = 1;
  args.p[0] = proj_problem(x1, d1, x2, d2, w, b, out, M, N);
  return (int)launch_proj<__nv_bfloat16>(args, (cudaStream_t)stream);
}

// K6's row-stacked projection at bf16 (launch_gi_proj_rs): out (T, 2B, N,
// f32), row (t, B dir + b) = [x1 | x2] row (s, b) of direction dir, s = t
// forward and T - 1 - t backward, times bf16(w_dir)^T plus b_dir, and bhh_dir
// on the first 2N/3 columns; x1 (T B, d1) and x2 (T B, d2) bf16.
int tsl_gemm_proj_rs_bf16(const __nv_bfloat16* x1, int d1, const __nv_bfloat16* x2, int d2,
                          const float* w_f, const float* b_f, const float* bhh_f, const float* w_b,
                          const float* b_b, const float* bhh_b, float* out, int T, int B, int N,
                          void* stream) {
  return (int)launch_gi_proj_rs(x1, d1, x2, d2, w_f, b_f, bhh_f, w_b, b_b, bhh_b, out, T, B, N,
                                (cudaStream_t)stream);
}

// dX at bf16 (launch_dx_bf16): [dx1 | dx2] (M, d1 + d2, bf16) = the sum over
// dir < ndir of bf16(bf16(a[dir]) bf16(w_dir)), rounded again when ndir = 2;
// a (ndir, M, K) and w_f, w_b (K, d1 + d2) f32; `pair` (2, M, d1 + d2) bf16
// scratch, read with ndir = 2 only.
int tsl_gemm_dx_bf16(const float* a, int ndir, const float* w_f, const float* w_b,
                     __nv_bfloat16* dx1, int d1, __nv_bfloat16* dx2, int d2, __nv_bfloat16* pair,
                     int M, int K, void* stream) {
  return (int)launch_dx_bf16(a, w_f, w_b, dx1, d1, dx2, d2, pair, M, K, (cudaStream_t)stream, ndir);
}

}  // extern "C"
