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
// recurrence steps over the valid frames only. K5f's recurrence is its own
// kernel, the cluster recurrence of gru_cluster.cuh (below).
//
// The TPU's K4f takes the backward direction's input already reversed per
// example (`reverse_padded(x, n)`, a copy in HBM) because its BlockSpecs cut
// contiguous time blocks. A CUDA block computes its own addresses, so here
// nothing is reversed or copied: the backward direction reads gi and writes
// h at t = n_b - 1 - s at step s.
//
// What bounds it on this card: as K1, the serial chain of (B, H) x (H, 3H)
// products, latency-bound at the small batches it serves (a served batch is
// 8 rows); the length masking costs a few integer operations per element.
//
// What the design does about it:
//   * the GEMM core (bigru_gemm.cuh) computes every direction's gi for all
//     (b, t) at once over the natural-order input, off the chain;
//   * one CTA per (batch tile, direction) walks the steps with W_hh resident
//     in shared memory (row pitch 32k + 4 against bank conflicts), thread
//     j < 3H owning gate column j, as K1's `bigru_rec_kernel`; the batch
//     tile is the smallest of 1, 2, 4, 8 rows that keeps the CTAs in one
//     wave (`pick_batch_tile`);
//   * a CTA steps only while a row of its tile still has valid frames (the
//     largest n_b of the tile), then zero-fills the rest: a padded row with
//     n_b = 0 costs no step;
//   * the directions write into one (B, T, 2H) output at column offsets
//     0 and H, so the layer's output needs no concat;
//   * no pool is fused: the pools run after the layer in PyTorch.
// f32 operands and accumulation throughout.
//
// K5f's recurrence is the cluster recurrence of gru_cluster.cuh
// (`gru_cluster_kernel<C, NB>`, which K1 instantiates too), at one
// direction, batch-major, with the rows' lengths: a thread-block cluster of
// C CTAs a batch tile, W_hh split by hidden unit and held in registers, each
// step's h sent to every CTA by st.async and awaited on a per-buffer
// mbarrier, gi through a cp.async ring. C = 4 while every batch row gets a
// cluster of its own within one wave of the card's SMs, else C = 2
// (`gru_cluster_size(B, 1)`): on an H100, C = 4 beat C = 2 by 13% at B = 16
// and 10% at B = 8, and C = 2 (one row a CTA) beat C = 4 (two rows a CTA) by
// 19% at B = 64 (PERF.md section 6); H <= 128, H % 4 == 0.

#include "bigru_common.cuh"
#include "gru_cluster.cuh"

namespace {

// K4f's recurrence: grid.y holds the two directions.
template <int NB>
__global__ void bigru_masked_rec_kernel(
    const float* __restrict__ gi,            // (2, B, T, 3H)
    const long long* __restrict__ lengths,   // (B,)
    const float* __restrict__ whh_f, const float* __restrict__ bhh_f,
    const float* __restrict__ whh_b, const float* __restrict__ bhh_b,
    float* __restrict__ out,                 // (B, T, 2H)
    int T, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int n_s[NB];
  const int H3 = 3 * H, HP = whh_pitch(H);
  float* w_s = smem;               // [3H][HP]
  float* h_s = w_s + H3 * HP;      // [NB][H]
  float* gh_s = h_s + NB * H;      // [NB][3H]

  const int dir = blockIdx.y;
  const int b0 = blockIdx.x * NB;
  const int nb = min(NB, B - b0);
  const float* __restrict__ whh = dir == 0 ? whh_f : whh_b;
  const float* __restrict__ bhh = dir == 0 ? bhh_f : bhh_b;
  const float* __restrict__ gid = gi + (size_t)dir * B * T * H3;
  float* __restrict__ outd = out + dir * H;
  const size_t ostride = 2 * (size_t)H;
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int e = tid; e < H3 * H; e += nt) w_s[(e / H) * HP + e % H] = whh[e];
  for (int e = tid; e < NB * H; e += nt) h_s[e] = 0.0f;
  if (tid < NB) {
    const long long n = tid < nb ? lengths[b0 + tid] : 0;
    n_s[tid] = (int)(n < 0 ? 0 : (n > T ? T : n));
  }
  const float bj = tid < H3 ? bhh[tid] : 0.0f;
  __syncthreads();
  int nmax = 0;
#pragma unroll
  for (int b = 0; b < NB; ++b) nmax = max(nmax, n_s[b]);

  // gate-phase elements per thread: NB*H <= kIt * nt because nt >= 3H
  constexpr int kIt = (NB + 2) / 3;
  const int H4 = H / 4;
  for (int s = 0; s < nmax; ++s) {
    float gr[kIt] = {}, gz[kIt] = {}, gn[kIt] = {};
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int e = tid + it * nt;
      if (e < nb * H) {
        const int b = e / H, n = n_s[b];
        if (s < n) {
          const int t = dir == 0 ? s : n - 1 - s;
          const float* g = gid + ((size_t)(b0 + b) * T + t) * H3 + e % H;
          gr[it] = g[0];
          gz[it] = g[H];
          gn[it] = g[2 * H];
        }
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
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int e = tid + it * nt;
      if (e < nb * H) {
        const int b = e / H, i = e % H, n = n_s[b];
        float* orow = outd + (size_t)(b0 + b) * T * ostride + i;
        if (s < n) {
          const float* gh = gh_s + b * H3;
          const float rg = sigmoid_(gr[it] + gh[i]);
          const float zg = sigmoid_(gz[it] + gh[H + i]);
          const float ng = tanhf(gn[it] + rg * gh[2 * H + i]);
          const float hprev = h_s[e];
          const float hn = ng + zg * (hprev - ng);
          h_s[e] = hn;
          orow[(size_t)(dir == 0 ? s : n - 1 - s) * ostride] = hn;
        } else {
          orow[(size_t)s * ostride] = 0.0f;  // the row's frames t = s >= n_b
        }
      }
    }
    __syncthreads();
  }
  // frames [nmax, T) of every row of the tile
  const int tail = (T - nmax) * H;
  for (int e = tid; e < nb * tail; e += nt) {
    const int b = e / tail, r = e % tail;
    outd[((size_t)(b0 + b) * T + nmax + r / H) * ostride + r % H] = 0.0f;
  }
}

template <int NB>
cudaError_t launch_masked_rec(const float* gi, const long long* lengths, const float* whh_f,
                              const float* bhh_f, const float* whh_b, const float* bhh_b,
                              float* out, int T, int B, int H, cudaStream_t st) {
  const size_t smem = sizeof(float) * ((size_t)3 * H * whh_pitch(H) + (size_t)NB * H * 4);
  cudaError_t err = cudaFuncSetAttribute(
      bigru_masked_rec_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int threads = (3 * H + 31) / 32 * 32;
  dim3 grid((B + NB - 1) / NB, 2);
  bigru_masked_rec_kernel<NB><<<grid, threads, smem, st>>>(gi, lengths, whh_f, bhh_f, whh_b,
                                                           bhh_b, out, T, B, H);
  return cudaGetLastError();
}

// K4f's recurrence at the batch tile pick_batch_tile chooses.
inline cudaError_t masked_rec(const float* gi, const long long* lengths, const float* whh_f,
                       const float* bhh_f, const float* whh_b, const float* bhh_b, float* out,
                       int T, int B, int H, cudaStream_t st) {
  int nb = 8;
  cudaError_t err = pick_batch_tile(B, &nb);
  if (err != cudaSuccess) return err;
#define TSL_REC(NBV) \
  launch_masked_rec<NBV>(gi, lengths, whh_f, bhh_f, whh_b, bhh_b, out, T, B, H, st)
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

// Forward of one length-masked bidirectional GRU layer. x is (B, T, D)
// row-major, lengths (B,) int64 valid frame counts (clamped to [0, T]).
// Weights are in torch layout: W_ih (3H, D), W_hh (3H, H), biases (3H).
// gi_scratch holds 2*B*T*3H floats; out holds B*T*2H floats (h_f in
// columns [0, H), h_b in [H, 2H)). H must be a multiple of 4. Returns
// cudaSuccess (0) or the first error of a launch; does not synchronise.
int tsl_bigru_masked_fwd(
    const float* x, int D, const long long* lengths,
    const float* wih_f, const float* bih_f, const float* whh_f, const float* bhh_f,
    const float* wih_b, const float* bih_b, const float* whh_b, const float* bhh_b,
    float* gi_scratch, float* out, int T, int B, int H, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = launch_gi_proj(x, D, nullptr, 0, wih_f, bih_f, wih_b, bih_b, gi_scratch,
                                   B * T, 3 * H, 2, st);
  if (err != cudaSuccess) return (int)err;
  return (int)masked_rec(gi_scratch, lengths, whh_f, bhh_f, whh_b, bhh_b, out, T, B, H, st);
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
  cudaStream_t st = (cudaStream_t)stream;
  if (H % 4 != 0 || H > kGruMaxH) return (int)cudaErrorInvalidValue;
  int C = 4;
  cudaError_t err = gru_cluster_size(B, 1, &C);
  if (err != cudaSuccess) return (int)err;
  err = launch_gi_proj(x, D, nullptr, 0, wih, bih, nullptr, nullptr, gi_scratch, B * T, 3 * H,
                       1, st);
  if (err != cudaSuccess) return (int)err;
  ClusterRec a = {};
  a.gi = gi_scratch;
  a.gi_b = (long long)T * 3 * H;
  a.gi_t = 3 * H;
  a.lengths = lengths;
  a.whh[0] = whh;
  a.bhh[0] = bhh;
  a.out[0] = out;
  a.out_b = (long long)T * H;
  a.out_t = H;
  a.T = T;
  a.B = B;
  a.H = H;
  a.pool = 1;
  return (int)gru_cluster_rec<false>(a, 1, C, st);
}

// The cluster size tsl_gru1_fwd takes at batch B on the current device (2 or
// 4); -1 on a CUDA error.
int tsl_gru1_cluster_size(int B) {
  int C = 0;
  return gru_cluster_size(B, 1, &C) == cudaSuccess ? C : -1;
}

}  // extern "C"
