// The GEMM core of bigru_gemm.cuh in its three layouts as C entry points, so
// that the card tests and chip_smoke.py hold each layout against an f64
// product of the same operands (tpu_slu_torch/ops/bigru_gemm.py). The
// kernels' own products reach the core through bigru_common.cuh and
// bigru_bwd_common.cuh; these entry points are not on any model's path.

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

}  // extern "C"
