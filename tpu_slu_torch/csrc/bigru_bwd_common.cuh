// Pieces shared by the GRU backward kernels (K3 bigru_shared_bwd.cu, K4b and
// K5b bigru_masked_bwd.cu): the gate tensor of phase 1. Their products (gi
// and gh of phase 1, dX and dW/db of phase 3) are the GEMM core's
// (bigru_gemm.cuh: `launch_proj`, `launch_dx`, `weight_grads`). None of them
// depends on the order of the M = T*B rows, so the time-major (K3) and the
// batch-major (K4b, K5b) layouts share them; `ndir` is the number of
// directions, 2 (K3, K4b) or 1 (K5b). K3 at bf16 instantiates them on bf16
// streams (x, h_prev, the cotangents); K4b and K5b take the f32 ones. The
// anonymous namespace gives each source its own copy.

#pragma once

#include "bigru_common.cuh"

namespace {

// Phase 1b: gates[dir][m] = [gh_n r (1-r), z, n, r] from gi and gh; in
// fused mode also dyx[dir][m] = keep * dY_pool[dir][t / pool] / cnt / (1-p).
// TD = bf16 (the cotangents of K3 at bf16): in plain mode too, dyx[dir][m]
// = dY[dir][m] widened to f32, so that the chain reads f32 cotangents.
template <typename TD>
__global__ void bwd_gates_kernel(const float* __restrict__ gi, const float* __restrict__ gh,
                                 float* __restrict__ gates, const TD* __restrict__ dyp_f,
                                 const TD* __restrict__ dyp_b, float* __restrict__ dyx,
                                 int T, int B, int H, int pool, int fused, uint32_t seed,
                                 uint32_t thresh, float inv_keep, int ndir) {
  const size_t M = (size_t)T * B;
  const size_t total = (size_t)ndir * M * H;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int i = (int)(e % H);
    const size_t row = e / H;  // dir * M + m
    const int dir = (int)(row / M);
    const int m = (int)(row % M);
    const float* gir = gi + row * 3 * H;
    const float* ghr = gh + row * 3 * H;
    const float r = sigmoid_(gir[i] + ghr[i]);
    const float z = sigmoid_(gir[H + i] + ghr[H + i]);
    const float ghn = ghr[2 * H + i];
    const float n = tanhf(gir[2 * H + i] + r * ghn);
    float* g = gates + row * 4 * H;
    g[i] = ghn * r * (1.0f - r);
    g[H + i] = z;
    g[2 * H + i] = n;
    g[3 * H + i] = r;
    if (fused) {
      const int t = m / B, b = m % B;
      const int wi = t / pool;
      const int cnt = min(pool, T - wi * pool);
      const TD* dyp = dir == 0 ? dyp_f : dyp_b;
      float d = to_f32(dyp[((size_t)wi * B + b) * H + i]) / (float)cnt;
      if (thresh < kKeepAll)
        d = keep_hash(seed, dir == 0 ? kSaltF : kSaltB, t, b, i, thresh) ? d * inv_keep : 0.0f;
      dyx[e] = d;
    } else if constexpr (!std::is_same_v<TD, float>) {
      dyx[e] = to_f32((dir == 0 ? dyp_f : dyp_b)[(size_t)m * H + i]);
    }
  }
}

// Phase 1a: gi = [x1 | x2] W_ih^T + b_ih into buf_a and gh = h_prev W_hh^T +
// b_hh into buf_b (each (ndir, M, 3H), f32) of ndir directions, in one launch
// of the GEMM core; x and h_prev f32 or bf16 (T; at bf16 the f32 weights are
// rounded to bf16 as the core reads them), the weights and biases f32.
template <typename T>
inline cudaError_t launch_gi_gh(const T* x1, int d1, const same_t<T>* x2, int d2,
                                const same_t<T>* hp_f, const same_t<T>* hp_b, const float* wih_f,
                                const float* bih_f, const float* whh_f, const float* bhh_f,
                                const float* wih_b, const float* bih_b, const float* whh_b,
                                const float* bhh_b, float* buf_a, float* buf_b, int M, int H,
                                int ndir, cudaStream_t st) {
  const int H3 = 3 * H;
  GemmArgs args = {};
  for (int d = 0; d < ndir; ++d) {
    const size_t off = (size_t)d * M * H3;
    args.p[args.nprob++] = proj_problem(x1, d1, x2, d2, d ? wih_b : wih_f, d ? bih_b : bih_f,
                                        buf_a + off, M, H3);
    args.p[args.nprob++] = proj_problem<T>(d ? hp_b : hp_f, H, nullptr, 0, d ? whh_b : whh_f,
                                           d ? bhh_b : bhh_f, buf_b + off, M, H3);
  }
  return launch_proj<T>(args, st);
}

inline int grid_for(size_t total, int sms) {
  const size_t blocks = (total + 255) / 256;
  return (int)(blocks < (size_t)sms * 8 ? blocks : (size_t)sms * 8);
}

}  // namespace
