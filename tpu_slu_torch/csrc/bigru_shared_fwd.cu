// Shared-stream bidirectional GRU layer, forward (eval), for sm_90a.
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
//     chain: `gi_proj_kernel` computes it for all T at once as one tiled
//     product over (T*B) x 3H for both directions, into a (2, T, B, 3H)
//     scratch.
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
// Which resource sets the time of one step is not measured yet (no hardware
// counters have been read for this kernel). Candidates: the shared-memory
// reads of all of W_hh (192 KiB at H = 128) per step, each thread's serial
// H-long FMA chain, the two barriers per step, and too few warps per SM to
// hide latency. Splitting W_hh over a cluster of SMs, keeping it in
// registers, wgmma and bf16 operands are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;  // projection output tile (rows and columns)
constexpr int kTK = 16;    // projection depth tile

__device__ __forceinline__ float sigmoid_(float x) { return 1.0f / (1.0f + expf(-x)); }

// Pitch in floats of a W_hh row in shared memory (see the note above).
__host__ __device__ inline int whh_pitch(int H) { return (H + 31) / 32 * 32 + 4; }

// gi[dir][m][n] = sum_p sum_k x_p[m][k] * W_ih[dir][n][off_p + k] + b_ih[dir][n]
// over m = t*B + b < M = T*B and n < N = 3H. W_ih is (3H, d1 + d2) row-major
// (torch layout), so both operands are contiguous along k.
__global__ void __launch_bounds__(256) gi_proj_kernel(
    const float* __restrict__ x1, int d1, const float* __restrict__ x2, int d2,
    const float* __restrict__ wih_f, const float* __restrict__ bih_f,
    const float* __restrict__ wih_b, const float* __restrict__ bih_b,
    float* __restrict__ gi, int M, int N) {
  __shared__ float xs[kTK][kTile + 1];
  __shared__ float ws[kTK][kTile + 1];
  const int dir = blockIdx.z;
  const float* __restrict__ w = dir == 0 ? wih_f : wih_b;
  const float* __restrict__ bias = dir == 0 ? bih_f : bih_b;
  const int K = d1 + d2;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float acc[4][4] = {};
  for (int p = 0; p < 2; ++p) {
    const float* __restrict__ x = p == 0 ? x1 : x2;
    const int dp = p == 0 ? d1 : d2;
    const int off = p == 0 ? 0 : d1;
    for (int k0 = 0; k0 < dp; k0 += kTK) {
      for (int e = tid; e < kTile * kTK; e += 256) {
        const int r = e / kTK, kk = e % kTK, k = k0 + kk;
        const int m = m0 + r, n = n0 + r;
        xs[kk][r] = (m < M && k < dp) ? x[(size_t)m * dp + k] : 0.0f;
        ws[kk][r] = (n < N && k < dp) ? w[(size_t)n * K + off + k] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kTK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
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
  float* __restrict__ out = gi + (size_t)dir * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) out[(size_t)m * N + n] = acc[i][j] + bias[n];
    }
  }
}

// One CTA per (batch tile of NB rows, direction); blockDim.x >= 3H.
template <int NB>
__global__ void bigru_rec_kernel(
    const float* __restrict__ gi,  // (2, T, B, 3H)
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
  const float* __restrict__ gid = gi + (size_t)dir * T * B * H3;
  float* __restrict__ out = dir == 0 ? out_f : out_b;
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int e = tid; e < H3 * H; e += nt) w_s[(e / H) * HP + e % H] = whh[e];
  for (int e = tid; e < NB * H; e += nt) h_s[e] = 0.0f;
  const float bj = tid < H3 ? bhh[tid] : 0.0f;
  __syncthreads();

  // gate-phase elements per thread: NB*H <= kIt * nt because nt >= 3H
  constexpr int kIt = (NB + 2) / 3;
  const int H4 = H / 4;
  for (int s = 0; s < T; ++s) {
    const int t = dir == 0 ? s : T - 1 - s;
    const float* __restrict__ git = gid + ((size_t)t * B + b0) * H3;
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
      for (int b = 0; b < NB; ++b) acc[b] = bj;
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
        if (b < nb) gh_s[b * H3 + tid] = acc[b];
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
        const float hn = ng + zg * (h_s[e] - ng);
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
                       const float* whh_b, const float* bhh_b, float* out_f, float* out_b,
                       int T, int B, int H, int pool, int pool_max, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * ((size_t)3 * H * whh_pitch(H) + (size_t)NB * H * 5);
  cudaError_t err = cudaFuncSetAttribute(
      bigru_rec_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int threads = (3 * H + 31) / 32 * 32;
  dim3 grid((B + NB - 1) / NB, 2);
  bigru_rec_kernel<NB><<<grid, threads, smem, st>>>(gi, whh_f, bhh_f, whh_b, bhh_b, out_f,
                                                    out_b, T, B, H, pool, pool_max);
  return cudaGetLastError();
}

}  // namespace

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
  cudaStream_t st = (cudaStream_t)stream;
  const int M = T * B, N = 3 * H;
  dim3 pgrid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile, 2);
  gi_proj_kernel<<<pgrid, 256, 0, st>>>(x1, d1, x2, d2, wih_f, bih_f, wih_b, bih_b,
                                        gi_scratch, M, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // the smallest batch tile whose 2 * ceil(B / tile) CTAs fit in one wave
  int nb = 8;
  for (int cand = 1; cand < 8; cand *= 2) {
    if (2 * ((B + cand - 1) / cand) <= sms) {
      nb = cand;
      break;
    }
  }
  switch (nb) {
    case 1:
      return (int)launch_rec<1>(gi_scratch, whh_f, bhh_f, whh_b, bhh_b, out_f, out_b, T, B,
                                H, pool, pool_max, st);
    case 2:
      return (int)launch_rec<2>(gi_scratch, whh_f, bhh_f, whh_b, bhh_b, out_f, out_b, T, B,
                                H, pool, pool_max, st);
    case 4:
      return (int)launch_rec<4>(gi_scratch, whh_f, bhh_f, whh_b, bhh_b, out_f, out_b, T, B,
                                H, pool, pool_max, st);
    default:
      return (int)launch_rec<8>(gi_scratch, whh_f, bhh_f, whh_b, bhh_b, out_f, out_b, T, B,
                                H, pool, pool_max, st);
  }
}

}  // extern "C"
