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
// kernel, `gru1_cluster_kernel` (below).
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
// K5f's recurrence, `gru1_cluster_kernel`. What bounds a step of the one-CTA
// design above at B = 16 (one row a CTA, 16 of 132 SMs busy): each CTA reads
// all of W_hh (192 KB at H = 128) from shared memory every step, ~1,900
// shared-memory cycles, ~1.0 us of the measured ~2.36 us step; two CTA
// barriers and the gate math make the rest. The design:
//   * a thread-block cluster of C CTAs per batch tile (C = 2 or 4, a
//     template parameter chosen from the batch by `gru1_cluster_size`):
//     CTA c owns hidden units [c H/C, (c+1) H/C) and the r, z and n rows of
//     W_hh for them, so a tile's step runs on C SMs;
//   * the slice lives in registers, read from device memory once: 8 lanes a
//     unit, each holding the three rows' float4 chunks j = lane, lane + 8, ...
//     (48 floats a thread at H = 128), so the matvec reads only h from
//     shared memory, by broadcast, and a warp's 8 distinct chunks are one
//     wavefront; the 8 lanes' partial sums meet by warp shuffles, so every
//     lane holds the unit's three gate sums and no CTA barrier is needed;
//   * lane b of a unit then runs the gate math of batch row b and sends the
//     new h to every CTA of the cluster by `st.async` into distributed
//     shared memory, double-buffered by step parity; each store's bytes
//     complete that buffer's mbarrier in the receiving CTA, which starts the
//     next step once all H x nb values have landed. The design first took
//     one cluster barrier a step (barrier.cluster.arrive.release /
//     wait.acquire): ~1.5 us a step on an H100, most of it the release,
//     which also waits for the step's global stores (a trial with a relaxed
//     arrive ran far faster; PERF.md section 6). The mbarriers need no fence
//     and no round trip through every CTA;
//   * gi streams through a 4-step ring in shared memory by cp.async, issued
//     three steps ahead, off the chain;
//   * C = 4 while every batch row gets a cluster of its own within one wave
//     of the card's SMs, else C = 2: on an H100, C = 4 beat C = 2 by 13% at
//     B = 16 and 10% at B = 8, and C = 2 (one row a CTA) beat C = 4 (two
//     rows a CTA) by 19% at B = 64 (PERF.md section 6);
//   * the batch tile is the smallest of 1, 2, 4, 8 rows that keeps C CTAs a
//     tile within one wave (`pick_batch_tile`); H <= 128 (the slice's
//     registers are sized for it), H % 4 == 0.

#include <cooperative_groups.h>

#include "bigru_common.cuh"

namespace cg = cooperative_groups;

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


constexpr int kGru1MaxH = 128;   // the W_hh slice's registers are sized for H <= 128
constexpr int kUnitLanes = 8;    // lanes that share a hidden unit's matvec
constexpr int kRing = 4;         // steps of gi in flight a lane (K5f)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The shared::cluster address of shared::cta address `a` in the CTA of rank r.
__device__ __forceinline__ unsigned peer_addr(unsigned a, unsigned r) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(a), "r"(r));
  return out;
}

// v into a peer's shared memory; its 4 bytes count on the peer's mbarrier.
__device__ __forceinline__ void st_async(unsigned a, float v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(a),
               "r"(__float_as_uint(v)), "r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Waits for the phase of parity `parity` of the mbarrier to complete; traps
// rather than hang if it never does.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  for (unsigned spins = 0;; ++spins) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1u << 22)) __trap();
  }
}

// K5f's recurrence: CTA c = rank in its cluster of C owns units [c H/C, (c+1)
// H/C) of batch tile blockIdx.x / C (NB rows); thread u * 8 + l holds the r, z
// and n rows of W_hh for unit u, float4 chunks l, l + 8, ... of each, in
// registers. Step s reads h from h_s[s & 1]; the lanes that run the gate math
// send the new h to every CTA's h_s[(s + 1) & 1] by st.async, whose bytes
// complete that buffer's mbarrier there: a CTA starts step s + 1 when all H x
// nb values of it have landed. Rows of length n_b step to the tile's largest
// n_b; zeros at t >= n_b. gi (B, T, 3H) holds x W_ih^T + b_ih; out is (B, T, H).
template <int C, int NB>
__global__ void __launch_bounds__(kGru1MaxH / C * kUnitLanes)
    gru1_cluster_kernel(const float* __restrict__ gi, const long long* __restrict__ lengths,
                        const float* __restrict__ whh, const float* __restrict__ bhh,
                        float* __restrict__ out, int T, int B, int H) {
  static_assert(NB <= kUnitLanes, "one lane of a unit per batch row");
  constexpr int kJ = kGru1MaxH / 4 / kUnitLanes;  // float4 chunks of a row a lane holds
  __shared__ __align__(16) float h_s[2][NB][kGru1MaxH];
  __shared__ float gi_s[kRing][3][NB][kGru1MaxH / C];
  __shared__ __align__(8) unsigned long long full[2];  // h_s[q] holds the next step's h
  __shared__ int n_s[NB];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();
  const int b0 = blockIdx.x / C * NB;
  const int nb = min(NB, B - b0);
  const int Hc = H / C, H3 = 3 * H, H4 = H / 4;
  const int tid = threadIdx.x, u = tid / kUnitLanes, lane = tid % kUnitLanes;
  const bool unit = u < Hc;
  const int col = c * Hc + u;  // the hidden unit, in [0, H)
  const unsigned step_bytes = (unsigned)(nb * H) * 4u;

  float4 w[3][kJ];
  float bias[3];
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    bias[g] = unit ? bhh[g * H + col] : 0.0f;
#pragma unroll
    for (int i = 0; i < kJ; ++i) {
      const int j = lane + kUnitLanes * i;
      w[g][i] = unit && j < H4
                    ? reinterpret_cast<const float4*>(whh + (size_t)(g * H + col) * H)[j]
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
  for (int e = tid; e < 2 * NB * kGru1MaxH; e += blockDim.x) (&h_s[0][0][0])[e] = 0.0f;
  if (tid < NB) {
    const long long n = tid < nb ? (lengths ? lengths[b0 + tid] : T) : 0;
    n_s[tid] = (int)(n < 0 ? 0 : (n > T ? T : n));
  }
  const unsigned bar0 = smem_addr(&full[0]);  // full[q] at bar0 + 8 q
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar0) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar0 + 8) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(bar0 + 8, step_bytes);  // step 1's h
    mbar_expect(bar0, step_bytes);      // step 2's h
  }
  // h_s and full[0] of every CTA of the cluster, this one's too
  unsigned peer_h[C], peer_bar[C];
#pragma unroll
  for (int r = 0; r < C; ++r) {
    peer_h[r] = peer_addr(smem_addr(&h_s[0][0][0]), r);
    peer_bar[r] = peer_addr(bar0, r);
  }
  cluster.sync();  // every CTA's h_s is zero and its mbarriers armed before any CTA sends
  int nmax = 0;
#pragma unroll
  for (int b = 0; b < NB; ++b) nmax = max(nmax, n_s[b]);

  // lane b of a unit runs batch row b's gate math; its gi streams through a
  // ring of kRing steps in shared memory, copied kRing - 1 steps ahead
  const bool mine = unit && lane < nb;
  const int n_mine = mine ? n_s[lane] : 0;
  const float* gib = gi + (size_t)(b0 + (mine ? lane : 0)) * T * H3 + col;
  float* ob = out + (size_t)(b0 + (mine ? lane : 0)) * T * H + col;
  auto fetch = [&](int t) {  // step t's gi into its ring slot; zeros past the row's length
    if (mine) {
      const bool ok = t < n_mine;
      const float* g = ok ? gib + (size_t)t * H3 : gib;
#pragma unroll
      for (int k = 0; k < 3; ++k) cp_async4(&gi_s[t % kRing][k][lane][u], g + k * H, ok);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < kRing - 1; ++t) fetch(t);
  float hprev = 0.0f;
  unsigned parity = 0;  // of the next phase of full[1]; full[0]'s runs one step behind
  for (int s = 0; s < nmax; ++s) {
    const int p = s & 1;
    if (s > 0) {
      mbar_wait(bar0 + 8 * p, parity);  // step s's h has landed
      if (p == 0) parity ^= 1u;
      if (tid == 0) mbar_expect(bar0 + 8 * p, step_bytes);  // step s + 2's h
    }
    float acc[3][NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
#pragma unroll
      for (int g = 0; g < 3; ++g) acc[g][b] = 0.0f;
      if (unit) {
#pragma unroll
        for (int i = 0; i < kJ; ++i) {
          const int j = lane + kUnitLanes * i;
          if (j < H4) {
            const float4 h = reinterpret_cast<const float4*>(&h_s[p][b][0])[j];
#pragma unroll
            for (int g = 0; g < 3; ++g) {
              float t = w[g][i].x * h.x;
              t = fmaf(w[g][i].y, h.y, t);
              t = fmaf(w[g][i].z, h.z, t);
              t = fmaf(w[g][i].w, h.w, t);
              acc[g][b] += t;
            }
          }
        }
      }
    }
#pragma unroll
    for (int off = kUnitLanes / 2; off > 0; off /= 2)
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int g = 0; g < 3; ++g) acc[g][b] += __shfl_xor_sync(0xffffffffu, acc[g][b], off);
    cp_async_wait<kRing - 2>();  // step s's gi has landed
    if (mine) {
      float v = 0.0f;
      if (s < n_mine) {
        float gh[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int b = 0; b < NB; ++b)
          if (b == lane) {
#pragma unroll
            for (int g = 0; g < 3; ++g) gh[g] = acc[g][b] + bias[g];
          }
        const float* gs = &gi_s[s % kRing][0][lane][u];
        const int gstride = NB * (kGru1MaxH / C);
        const float rg = sigmoid_(gs[0] + gh[0]);
        const float zg = sigmoid_(gs[gstride] + gh[1]);
        const float ng = tanhf(gs[2 * gstride] + rg * gh[2]);
        v = ng + zg * (hprev - ng);
        hprev = v;
      }
      if (s + 1 < nmax) {  // every row sends every step, so a step's byte count is fixed
        const unsigned off = (unsigned)(((p ^ 1) * NB + lane) * kGru1MaxH + col) * 4u;
#pragma unroll
        for (int r = 0; r < C; ++r) st_async(peer_h[r] + off, hprev, peer_bar[r] + 8 * (p ^ 1));
      }
      ob[(size_t)s * H] = v;  // zeros past the row's length
    }
    fetch(s + kRing - 1);
  }
  cp_async_wait<0>();
  // frames [nmax, T) of every row of the tile, this CTA's units
  if (unit) {
    for (int e = lane; e < nb * (T - nmax); e += kUnitLanes) {
      const int b = e / (T - nmax), t = nmax + e % (T - nmax);
      out[((size_t)(b0 + b) * T + t) * H + col] = 0.0f;
    }
  }
  cluster.sync();  // no CTA leaves while a peer may still address its shared memory
}

template <int C, int NB>
cudaError_t launch_gru1_cluster(const float* gi, const long long* lengths, const float* whh,
                                const float* bhh, float* out, int T, int B, int H,
                                cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((B + NB - 1) / NB * C));
  cfg.blockDim = dim3((unsigned)((H / C * kUnitLanes + 31) / 32 * 32));
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, gru1_cluster_kernel<C, NB>, gi, lengths, whh, bhh,
                                       out, T, B, H);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// K5f's recurrence on clusters of C CTAs, at the batch tile pick_batch_tile
// chooses for C CTAs a tile.
template <int C>
cudaError_t gru1_rec(const float* gi, const long long* lengths, const float* whh,
                     const float* bhh, float* out, int T, int B, int H, cudaStream_t st) {
  int nb = 8;
  cudaError_t err = pick_batch_tile(B, &nb, C);
  if (err != cudaSuccess) return err;
  switch (nb) {
    case 1:
      return launch_gru1_cluster<C, 1>(gi, lengths, whh, bhh, out, T, B, H, st);
    case 2:
      return launch_gru1_cluster<C, 2>(gi, lengths, whh, bhh, out, T, B, H, st);
    case 4:
      return launch_gru1_cluster<C, 4>(gi, lengths, whh, bhh, out, T, B, H, st);
    default:
      return launch_gru1_cluster<C, 8>(gi, lengths, whh, bhh, out, T, B, H, st);
  }
}

// K5f's cluster size at batch B: 4 while 4 B CTAs fit in one wave of the
// card's SMs (one row a CTA), else 2.
inline cudaError_t gru1_cluster_size(int B, int* C) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  *C = 4 * B <= sms ? 4 : 2;
  return cudaSuccess;
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
  if (H % 4 != 0 || H > kGru1MaxH) return (int)cudaErrorInvalidValue;
  int C = 4;
  cudaError_t err = gru1_cluster_size(B, &C);
  if (err != cudaSuccess) return (int)err;
  err = launch_gi_proj(x, D, nullptr, 0, wih, bih, nullptr, nullptr, gi_scratch, B * T, 3 * H,
                       1, st);
  if (err != cudaSuccess) return (int)err;
  return (int)(C == 2 ? gru1_rec<2>(gi_scratch, lengths, whh, bhh, out, T, B, H, st)
                      : gru1_rec<4>(gi_scratch, lengths, whh, bhh, out, T, B, H, st));
}

// The cluster size tsl_gru1_fwd takes at batch B on the current device (2 or
// 4); -1 on a CUDA error.
int tsl_gru1_cluster_size(int B) {
  int C = 0;
  return gru1_cluster_size(B, &C) == cudaSuccess ? C : -1;
}

}  // extern "C"
