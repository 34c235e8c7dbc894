// Pieces shared by the GRU backward kernels (K3 bigru_shared_bwd.cu, K4b and
// K5b bigru_masked_bwd.cu): the gate tensor of phase 1, and phase 3's
// products (dX, and dW/db as a split row-chunk GEMM with a fixed-order
// reduction, so that repeated runs agree bit for bit). None of them depends
// on the order of the M = T*B rows, so the time-major (K3) and the
// batch-major (K4b, K5b) layouts share them; `ndir` is the number of
// directions, 2 (K3, K4b) or 1 (K5b). Included after bigru_common.cuh; the
// anonymous namespace gives each source its own copy.

#pragma once

#include <algorithm>

#include "bigru_common.cuh"

namespace {

constexpr int kMaxSplit = 8;  // row chunks of the dW reduction, at most

// Phase 1b: gates[dir][m] = [gh_n r (1-r), z, n, r] from gi and gh; in
// fused mode also dyx[dir][m] = keep * dY_pool[dir][t / pool] / cnt / (1-p).
__global__ void bwd_gates_kernel(const float* __restrict__ gi, const float* __restrict__ gh,
                                 float* __restrict__ gates, const float* __restrict__ dyp_f,
                                 const float* __restrict__ dyp_b, float* __restrict__ dyx,
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
      const float* dyp = dir == 0 ? dyp_f : dyp_b;
      float d = dyp[((size_t)wi * B + b) * H + i] / (float)cnt;
      if (thresh < kKeepAll)
        d = keep_hash(seed, dir == 0 ? kSaltF : kSaltB, t, b, i, thresh) ? d * inv_keep : 0.0f;
      dyx[e] = d;
    }
  }
}

// Phase 3a: dx[m][n] = sum_dir sum_k dgi[dir][m][k] * W_ih_dir[k][n] over
// k < 3H, for n < D = d1 + d2; column n goes to dx1 (n < d1) or dx2.
__global__ void __launch_bounds__(256) bwd_dx_kernel(
    const float* __restrict__ dgi, const float* __restrict__ wih_f,
    const float* __restrict__ wih_b, float* __restrict__ dx1, int d1, float* __restrict__ dx2,
    int d2, int M, int H3, int ndir) {
  __shared__ float as[kTK][kTile + 1];
  __shared__ float ws[kTK][kTile + 1];
  const int D = d1 + d2;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float acc[4][4] = {};
  for (int dir = 0; dir < ndir; ++dir) {
    const float* __restrict__ A = dgi + (size_t)dir * M * H3;
    const float* __restrict__ W = dir == 0 ? wih_f : wih_b;
    for (int k0 = 0; k0 < H3; k0 += kTK) {
      for (int e = tid; e < kTile * kTK; e += 256) {
        const int r = e / kTK, kk = e % kTK;
        const int m = m0 + r, k = k0 + kk;
        as[kk][r] = (m < M && k < H3) ? A[(size_t)m * H3 + k] : 0.0f;
        const int kw = k0 + e / kTile, c = e % kTile, n = n0 + c;
        ws[e / kTile][c] = (kw < H3 && n < D) ? W[(size_t)kw * D + n] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kTK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = as[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < d1) {
        dx1[(size_t)m * d1 + n] = acc[i][j];
      } else if (n < D) {
        dx2[(size_t)m * d2 + n - d1] = acc[i][j];
      }
    }
  }
}

// Phase 3b: partial[split][dir][i][n] = sum over the split's rows m of
// A[dir][m][i] * X_dir[m][n], for i < 3H and n <= Dx = d1 + d2, where
// X_dir = [x1 | x2 | 1] (x*_f for dir 0, x*_b for dir 1): the last column
// gives the bias gradient. Rows are summed in order inside a CTA.
__global__ void __launch_bounds__(256) bwd_dw_kernel(
    const float* __restrict__ A, int H3, const float* __restrict__ x1_f,
    const float* __restrict__ x2_f, const float* __restrict__ x1_b,
    const float* __restrict__ x2_b, int d1, int d2, float* __restrict__ partial, int M,
    int chunk, int ndir) {
  __shared__ float as[kTK][kTile + 1];
  __shared__ float xs[kTK][kTile + 1];
  const int dir = blockIdx.z % ndir, split = blockIdx.z / ndir;
  const int Dx = d1 + d2, NC = Dx + 1;
  const int i0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int mb = split * chunk, me = min(M, mb + chunk);
  const float* __restrict__ Ad = A + (size_t)dir * M * H3;
  const float* __restrict__ x1 = dir == 0 ? x1_f : x1_b;
  const float* __restrict__ x2 = dir == 0 ? x2_f : x2_b;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float acc[4][4] = {};
  for (int m0 = mb; m0 < me; m0 += kTK) {
    for (int e = tid; e < kTile * kTK; e += 256) {
      const int kk = e / kTile, c = e % kTile, m = m0 + kk;
      const int i = i0 + c, n = n0 + c;
      as[kk][c] = (m < me && i < H3) ? Ad[(size_t)m * H3 + i] : 0.0f;
      float xv = 0.0f;
      if (m < me) {
        if (n < d1) {
          xv = x1[(size_t)m * d1 + n];
        } else if (n < Dx) {
          xv = x2[(size_t)m * d2 + n - d1];
        } else if (n == Dx) {
          xv = 1.0f;
        }
      }
      xs[kk][c] = xv;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = xs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* __restrict__ out = partial + (size_t)(split * ndir + dir) * H3 * NC;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = i0 + ty + 16 * i;
    if (r >= H3) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < NC) out[(size_t)r * NC + n] = acc[i][j];
    }
  }
}

// Phase 3c: sums the splits' partials in split order into dW (3H, Dx) and
// db (3H) of each direction.
__global__ void bwd_dw_reduce_kernel(const float* __restrict__ partial, int S, int H3, int Dx,
                                     float* __restrict__ dw_f, float* __restrict__ db_f,
                                     float* __restrict__ dw_b, float* __restrict__ db_b,
                                     int ndir) {
  const int NC = Dx + 1;
  const size_t per_dir = (size_t)H3 * NC;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < ndir * per_dir;
       e += (size_t)gridDim.x * blockDim.x) {
    const int dir = (int)(e / per_dir);
    const size_t rem = e % per_dir;
    const int i = (int)(rem / NC), n = (int)(rem % NC);
    float s = 0.0f;
    for (int sp = 0; sp < S; ++sp) s += partial[(size_t)(sp * ndir + dir) * per_dir + rem];
    if (n < Dx) {
      (dir == 0 ? dw_f : dw_b)[(size_t)i * Dx + n] = s;
    } else {
      (dir == 0 ? db_f : db_b)[i] = s;
    }
  }
}

inline int grid_for(size_t total, int sms) {
  const size_t blocks = (total + 255) / 256;
  return (int)(blocks < (size_t)sms * 8 ? blocks : (size_t)sms * 8);
}

// dW and db of each direction: the split row-chunk GEMM, then the reduction.
cudaError_t weight_grads(const float* A, int H3, const float* x1_f, const float* x2_f,
                         const float* x1_b, const float* x2_b, int d1, int d2, float* partial,
                         float* dw_f, float* db_f, float* dw_b, float* db_b, int M, int sms,
                         cudaStream_t st, int ndir = 2) {
  const int Dx = d1 + d2;
  const int tiles = ndir * ((H3 + kTile - 1) / kTile) * ((Dx + 1 + kTile - 1) / kTile);
  // enough row chunks to give every SM a CTA, each of at least 256 rows
  int S = (sms + tiles - 1) / tiles;
  S = std::max(1, std::min(S, std::min(kMaxSplit, (M + 255) / 256)));
  const int chunk = ((M + S - 1) / S + kTK - 1) / kTK * kTK;
  S = (M + chunk - 1) / chunk;
  dim3 grid((Dx + 1 + kTile - 1) / kTile, (H3 + kTile - 1) / kTile, ndir * S);
  bwd_dw_kernel<<<grid, 256, 0, st>>>(A, H3, x1_f, x2_f, x1_b, x2_b, d1, d2, partial, M, chunk,
                                      ndir);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dw_reduce_kernel<<<grid_for((size_t)ndir * H3 * (Dx + 1), sms), 256, 0, st>>>(
      partial, S, H3, Dx, dw_f, db_f, dw_b, db_b, ndir);
  return cudaGetLastError();
}

}  // namespace
