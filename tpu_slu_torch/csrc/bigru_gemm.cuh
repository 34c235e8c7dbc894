// The GEMM core of the bi-GRU kernels (K1-K6), for sm_90a: every product
// off the recurrent chain goes through it, `gemm_kernel` at f32 (below) and
// `gemm_kernel_tc` or `gemm_kernel_mixed` at bf16 (further below).
//
//   * gi = [x1 | x2] W_ih^T + b_ih (K1, K2, K4f, K5f, K6 and phase 1 of K3,
//     K4b, K5b; K6's row-stacked rows and bias fold in the epilogue), and
//     gh = h_prev W_hh^T + b_hh (phase 1 of the backward kernels): both
//     operands contiguous along k, the parts x1 | x2 two k segments;
//   * dX = sum_dir dgi_dir W_ih_dir (phase 3): A contiguous along k, B
//     (W_ih, 3H x D) contiguous along n; the directions are two k segments,
//     the output is split at the parts' column offset;
//   * dW = dgi^T [x1 | x2] and dgh^T h_prev (phase 3): both operands
//     contiguous along their output index, the reduction over the M = T*B
//     rows, cut into row chunks that each write their own slot; a second
//     pass sums the slots in chunk order. db, the column sum of dgi (dgh),
//     is taken from the shared-memory tiles by the CTAs of the first column
//     tile. No float atomics: repeated runs agree bit for bit.
//
// What bounds the f32 products on this card: FMAs. K3 at the flagship's five
// layers and B = 64 runs ~55 GFLOP of them (dW 21.7, dX 11.8, the recomputed
// gi 11.8 and gh 9.75), 0.82 ms at the 67 TFLOP/s f32 peak; the bytes are a
// small fraction of that at 3.35 TB/s. What the design does about it:
//   * a 128 x 128 output tile over 256 threads, 8 x 8 accumulators a
//     thread, so that a k step is four 128-bit shared-memory loads for 64
//     FMAs; where the output is narrow, 128 x 64 over 256 threads of 8 x 4
//     (three loads for 32 FMAs), so that the SMs keep 16 warps;
//   * both operands k-major in shared memory ([k][row], rows padded by 4
//     floats), filled by 4-byte cp.async copies that transpose on the way
//     when the operand is contiguous along k, coalesced in device memory in
//     either layout, zero-filled past every edge, so any shape is taken;
//   * a 3-stage cp.async ring of 8-deep k slices: the copies of the next two
//     slices are in flight while the current one is multiplied, one barrier a
//     slice;
//   * one launch serves several problems (both directions, gi and gh of
//     phase 1, the parts of dW), so small layers still fill the SMs; dW's row
//     chunks are as many as give every SM two CTAs.
// f32 FMAs throughout, no TF32.
//
// bf16 storage (compute_dtype=bfloat16: K1-K6 on bf16 streams): an operand
// may be read as bf16 (the parts, h_prev), or as f32 rounded to bf16 on the
// way (the f32 master weights W_ih and W_hh, and dX's dgi, as the TPU
// kernel rounds them before its products), and dX may be written as bf16.
// The products whose operands are both bf16 (gi, gh and dX at bf16: the TPU
// kernel's `jnp.dot(bf16, bf16, preferred_element_type=f32)`, pallas_gru.py
// `_mxu`) run on the tensor cores, `gemm_kernel_tc`: bf16 `mma.sync`
// m16n8k16 with f32 accumulators. What bounds them is bytes, not
// operations: K3's at the flagship's five layers and B = 64 are 33 GFLOP
// (0.034 ms at 989 TFLOP/s) but move ~0.5 GB (the f32 gi, gh and dgi of M =
// 49,600 rows by 768 columns), ~0.15 ms at 3.35 TB/s. What the design does:
//   * both operands stored in shared memory as bf16, never widened: A
//     [row][k], B [n][k] (gi, gh) or [k][n] (dX, read by `ldmatrix.trans`),
//     rows padded by 8 values so that each `ldmatrix` phase reads 8 rows
//     without a bank conflict; 32-deep k slices (two mma k steps), zeros
//     past every edge, so any K (60, two segments) is taken;
//   * the operands reach the tile through registers, 4 values a load (8
//     bytes bf16, 16 bytes f32) where the segment's base and row pitch
//     allow it, else value by value (parts and h_prev at any 2-byte
//     offset): slice q + 2 is loaded while slice q is multiplied, and
//     stored (an f32 operand rounded to bf16 on the way) after the next
//     barrier into a 2-stage ring, one barrier a slice;
//   * 256 threads, 8 warps of 16-32 x 16-32 outputs each; the tile, 128 x
//     64, 64 x 64 or 64 x 32, the largest that gives every SM two CTAs
//     (`tc_tile`), so that the flagship's smallest layers still fill the
//     card;
//   * the epilogue of the FMA kernels (bias, K6's fold and row map,
//     n_split/out2, bf16 dX), on 4-column blocks gathered from the mma
//     fragments by one shuffle; no split of k, no atomics, so repeated runs
//     agree bit for bit.
// dW stays on the FMA path, `gemm_kernel_mixed`: the TPU kernel takes it in
// f32 from the unrounded f32 dgi and dgh (pallas_gru.py:1441-1443), which a
// bf16 mma would round. Its bf16 operand goes through registers two slices
// ahead and is widened to f32 (exact) into the ring's f32 tile. The f32
// products keep their own kernel, `gemm_kernel`, the code it was (one
// template for both moved the f32 instantiations' registers on an H100:
// gi/gh and dW spilled, and K4b's and K5b's core phases ran 4-7% slower).
//
// Included by bigru_common.cuh; the anonymous namespace gives each source
// its own copy.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <cuda_bf16.h>

#include <algorithm>
#include <type_traits>

#include "cp_async.cuh"

// Launches of gemm_kernel_tc since the library was loaded or the count was
// last zeroed (ops/bigru_gemm.py `tc_launches`): every source that includes
// this header adds to the one count of the library, the linker merging the
// weak definitions.
extern "C" {
__attribute__((weak)) unsigned long long tsl_gemm_tc_launches = 0;
}

namespace {

constexpr int kBK = 8;          // depth of a k slice
constexpr int kStages = 3;      // slices in the cp.async ring
constexpr int kPad = 4;         // floats of padding after each k row of a tile
constexpr int kMaxProblems = 4;
constexpr int kLayK = 0;        // element (r, k) at p[r * ld + k]
constexpr int kLayR = 1;        // element (r, k) at p[k * ld + r]
// how the core reads an operand
constexpr int kOpF32 = 0;       // f32, by cp.async (the FMA kernels)
constexpr int kOpBF16 = 1;      // bf16 (gemm_kernel_tc; gemm_kernel_mixed widens it to f32)
constexpr int kOpRound = 2;     // f32 rounded to bf16, round to nearest even

template <int MODE>
struct OpElem {
  using T = float;
};
template <>
struct OpElem<kOpBF16> {
  using T = __nv_bfloat16;
};

// T in a parameter that takes no part in deducing T (a null pointer may be passed there).
template <typename T>
struct Same {
  using type = T;
};
template <typename T>
using same_t = typename Same<T>::type;

// The mode that reads an operand stored as T as it is.
template <typename T>
constexpr int kOpOf = std::is_same_v<T, __nv_bfloat16> ? kOpBF16 : kOpF32;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}


// One product C (M x N) = sum over up to two k segments of A_s (M x K_s)
// times B_s (K_s x N), A's element (m, k) and B's (n, k) read in the layouts
// of the kernel's template, and its epilogue:
//   out[row(m) * ldo + n] = C + bias[n] (+ fold[n] for n < fold_n), n < n_split;
//   out2[row(m) * ldo2 + n - n_split] = C, n >= n_split;
//   row(m) = m, or K6's row-stacked row when rs_B > 0: m = t * rs_B + b ->
//   (rs_dir ? T - 1 - t : t) * 2 rs_B + rs_dir * rs_B + b;
//   db (non-null): db[m] = the sum of A(m, k) over the reduction.
// With the launch's kchunk > 0 the (single) segment is cut into row chunks of
// kchunk along k; chunk c writes out, out2 and db shifted by c * chunk_stride.
// An operand or output stored as bf16 (gemm_kernel_mixed's modes) is passed
// as its address in the float* field; bias, fold and db are f32.
struct GemmProblem {
  const float* a0;
  const float* b0;
  const float* a1;
  const float* b1;
  int lda0, ldb0, K0, lda1, ldb1, K1;  // K1 = 0: one segment
  int M, N;
  float* out;
  float* out2;
  int ldo, ldo2, n_split;
  const float* bias;
  const float* fold;
  int fold_n, rs_B, rs_dir;
  float* db;
  long long chunk_stride;
};

struct GemmArgs {
  GemmProblem p[kMaxProblems];
  int nprob;
  int kchunk;  // 0: no split of the reduction
};

// Copies the R x kBK slice (rows r0.., k0..) of an operand into s[kk][r]
// (row pitch R + kPad), zeros past rmax and kmax. Consecutive threads take
// consecutive addresses of the operand's contiguous index.
template <int L, int R, int NT>
__device__ __forceinline__ void load_slice(float* s, const float* p, int ld, int r0, int rmax,
                                           int k0, int kmax, int tid) {
  constexpr int kPer = R * kBK / NT;
  static_assert(kPer * NT == R * kBK, "tile and thread count do not divide");
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int e = tid + q * NT;
    const int r = L == kLayK ? e / kBK : e % R;
    const int kk = L == kLayK ? e % kBK : e / R;
    const int gr = r0 + r, gk = k0 + kk;
    const bool ok = gr < rmax && gk < kmax;
    const float* src = !ok ? p : L == kLayK ? p + (size_t)gr * ld + gk : p + (size_t)gk * ld + gr;
    cp_async4(s + kk * (R + kPad) + r, src, ok);
  }
}

// A column block [n, n + 4) of one output row, v[j] at column n + j.
__device__ __forceinline__ void store4(const GemmProblem& P, size_t row, size_t shift, int n,
                                       const float (&v)[4]) {
  const int N = P.N, ns = P.n_split;
  float* q;
  int end;
  if (n >= ns) {
    q = P.out2 + shift + row * P.ldo2 + (n - ns);
    end = N - n;
  } else {
    q = P.out + shift + row * P.ldo + n;
    end = min(N, ns) - n;
  }
  if (end >= 4 && (reinterpret_cast<uintptr_t>(q) & 15) == 0) {
    *reinterpret_cast<float4*>(q) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = n + j;
    if (c >= N) break;
    if (c < ns) {
      P.out[shift + row * P.ldo + c] = v[j];
    } else {
      P.out2[shift + row * P.ldo2 + (c - ns)] = v[j];
    }
  }
}

// The R x kBK slice of an operand read in mode MODE (kOpBF16 or kOpRound)
// into registers as f32, in load_slice's order of elements; zeros past rmax
// and kmax.
template <int L, int R, int NT, int MODE>
__device__ __forceinline__ void fetch_slice(float (&v)[R * kBK / NT],
                                            const typename OpElem<MODE>::T* p, int ld, int r0,
                                            int rmax, int k0, int kmax, int tid) {
  constexpr int kPer = R * kBK / NT;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int e = tid + q * NT;
    const int r = L == kLayK ? e / kBK : e % R;
    const int kk = L == kLayK ? e % kBK : e / R;
    const int gr = r0 + r, gk = k0 + kk;
    float x = 0.0f;
    if (gr < rmax && gk < kmax) {
      const size_t i = L == kLayK ? (size_t)gr * ld + gk : (size_t)gk * ld + gr;
      if constexpr (MODE == kOpBF16) {
        x = __bfloat162float(p[i]);
      } else {
        x = bf16_round(p[i]);
      }
    }
    v[q] = x;
  }
}

// fetch_slice's registers into the slice's stage, laid out as load_slice lays it.
template <int L, int R, int NT>
__device__ __forceinline__ void put_slice(float* s, const float (&v)[R * kBK / NT], int tid) {
  constexpr int kPer = R * kBK / NT;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int e = tid + q * NT;
    const int r = L == kLayK ? e / kBK : e % R;
    const int kk = L == kLayK ? e % kBK : e / R;
    s[kk * (R + kPad) + r] = v[q];
  }
}

// store4 for bf16 outputs (OBF): v rounded to the
// nearest even bf16, out and out2 holding bf16 addresses.
__device__ __forceinline__ void store4_bf16(const GemmProblem& P, size_t row, size_t shift, int n,
                                            const float (&v)[4]) {
  const int N = P.N, ns = P.n_split;
  __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(P.out);
  __nv_bfloat16* out2 = reinterpret_cast<__nv_bfloat16*>(P.out2);
  __nv_bfloat16* q;
  int end;
  if (n >= ns) {
    q = out2 + shift + row * P.ldo2 + (n - ns);
    end = N - n;
  } else {
    q = out + shift + row * P.ldo + n;
    end = min(N, ns) - n;
  }
  if (end >= 4 && (reinterpret_cast<uintptr_t>(q) & 7) == 0) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 w;
    w.x = *reinterpret_cast<const unsigned*>(&lo);
    w.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(q) = w;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = n + j;
    if (c >= N) break;
    if (c < ns) {
      out[shift + row * P.ldo + c] = __float2bfloat16_rn(v[j]);
    } else {
      out2[shift + row * P.ldo2 + (c - ns)] = __float2bfloat16_rn(v[j]);
    }
  }
}

// The core. Grid: x column tiles, y row tiles (of the largest problem), z
// chunk * nprob + problem; 256 threads a CTA, two CTAs an SM (128 registers a
// thread at most). Thread (ty, tx) owns 8 x TN outputs: rows ty*4 + i and
// BM/2 + ty*4 + i, columns tx*4 + j (TN = 4) or tx*4 + j and BN/2 + tx*4 + j
// (TN = 8), i, j < 4; a warp covers 4 ty by 8 tx, so each of its 128-bit
// loads of a k step reads one wavefront. The narrow tile (BN = 64) takes TN
// = 4, so that it still runs 8 warps.
template <int LA, int LB, int BM, int BN, int TN>
__global__ void __launch_bounds__((BM / 8) * (BN / TN), 2)
    gemm_kernel(const __grid_constant__ GemmArgs args) {
  constexpr int NT = (BM / 8) * (BN / TN);
  constexpr int WX = BN / TN / 8;       // warps across a row of the tile
  constexpr int HW = BN / (TN / 4);     // columns between a thread's float4 blocks
  constexpr int LDA = BM + kPad, LDB = BN + kPad;
  constexpr int kGroups = NT / BM;  // db: threads per row of A
  __shared__ __align__(16) float As[kStages][kBK * LDA];
  __shared__ __align__(16) float Bs[kStages][kBK * LDB];
  __shared__ float db_s[kGroups][BM];

  const GemmProblem& P = args.p[blockIdx.z % args.nprob];
  const int chunk = blockIdx.z / args.nprob;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (m0 >= P.M || n0 >= P.N) return;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ty = (warp / WX) * 4 + lane / 8;
  const int tx = (warp % WX) * 8 + lane % 8;

  // the segments, cut to this CTA's chunk of the reduction
  const float* a0 = P.a0;
  const float* b0 = P.b0;
  int K0 = P.K0;
  const int K1 = args.kchunk ? 0 : P.K1;
  size_t shift = 0;
  if (args.kchunk) {
    const int kb = chunk * args.kchunk;
    K0 = min(args.kchunk, P.K0 - kb);
    a0 += LA == kLayK ? (size_t)kb : (size_t)kb * P.lda0;
    b0 += LB == kLayK ? (size_t)kb : (size_t)kb * P.ldb0;
    shift = (size_t)chunk * P.chunk_stride;
  }
  const int nt0 = (K0 + kBK - 1) / kBK;
  const int ntiles = nt0 + (K1 + kBK - 1) / kBK;
  const bool take_db = P.db != nullptr && blockIdx.x == 0;

  auto issue = [&](int q) {
    const bool s1 = q >= nt0;
    const int k0 = (s1 ? q - nt0 : q) * kBK;
    const int st = q % kStages;
    load_slice<LA, BM, NT>(As[st], s1 ? P.a1 : a0, s1 ? P.lda1 : P.lda0, m0, P.M, k0,
                           s1 ? K1 : K0, tid);
    load_slice<LB, BN, NT>(Bs[st], s1 ? P.b1 : b0, s1 ? P.ldb1 : P.ldb0, n0, P.N, k0,
                           s1 ? K1 : K0, tid);
  };

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  float dbacc = 0.0f;

#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) {
    if (q < ntiles) issue(q);
    cp_async_commit();
  }
  for (int q = 0; q < ntiles; ++q) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slice q has landed; slice q - 1's stage is free
    if (q + kStages - 1 < ntiles) issue(q + kStages - 1);
    cp_async_commit();
    const float* as = As[q % kStages];
    const float* bs = Bs[q % kStages];
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 x0 = *reinterpret_cast<const float4*>(as + kk * LDA + ty * 4);
      const float4 x1 = *reinterpret_cast<const float4*>(as + kk * LDA + BM / 2 + ty * 4);
      const float a[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      float b[TN];
#pragma unroll
      for (int h = 0; h < TN / 4; ++h) {
        const float4 y = *reinterpret_cast<const float4*>(bs + kk * LDB + h * HW + tx * 4);
        b[4 * h] = y.x;
        b[4 * h + 1] = y.y;
        b[4 * h + 2] = y.z;
        b[4 * h + 3] = y.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (take_db) {  // thread (g, r) sums rows kk = g, g + kGroups, ... of A's column r
#pragma unroll
      for (int kk = tid / BM; kk < kBK; kk += kGroups) dbacc += as[kk * LDA + tid % BM];
    }
  }
  cp_async_wait<0>();

  if (take_db) {
    db_s[tid / BM][tid % BM] = dbacc;
    __syncthreads();
    if (tid < BM && m0 + tid < P.M) {
      float s = 0.0f;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) s += db_s[g][tid];
      P.db[shift + m0 + tid] = s;
    }
  }

  const int T = P.rs_B > 0 ? P.M / P.rs_B : 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + i - 4);
    if (m >= P.M) continue;
    size_t row = m;
    if (P.rs_B > 0) {
      const int t = m / P.rs_B, b = m % P.rs_B;
      row = (size_t)(P.rs_dir ? T - 1 - t : t) * 2 * P.rs_B + (size_t)P.rs_dir * P.rs_B + b;
    }
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const int n = n0 + h * HW + tx * 4;
      if (n >= P.N) continue;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n + j;
        v[j] = acc[i][h * 4 + j];
        if (P.bias != nullptr && c < P.N) {
          v[j] += P.bias[c];
          if (c < P.fold_n) v[j] += P.fold[c];
        }
      }
      store4(P, row, shift, n, v);
    }
  }
}

// gemm_kernel with the operands read in modes MA and MB (kOpF32 by
// cp.async; kOpBF16 and kOpRound through registers, fetch_slice two slices
// ahead, put_slice after the current slice's products) and bf16 outputs
// with OBF; the tiles, the ring and the epilogue are gemm_kernel's.
template <int LA, int LB, int BM, int BN, int TN, int MA, int MB, bool OBF>
__global__ void __launch_bounds__((BM / 8) * (BN / TN), 2)
    gemm_kernel_mixed(const __grid_constant__ GemmArgs args) {
  using TA = typename OpElem<MA>::T;
  using TB = typename OpElem<MB>::T;
  constexpr bool kRegA = MA != kOpF32, kRegB = MB != kOpF32;
  constexpr int NT = (BM / 8) * (BN / TN);
  constexpr int WX = BN / TN / 8;       // warps across a row of the tile
  constexpr int HW = BN / (TN / 4);     // columns between a thread's float4 blocks
  constexpr int LDA = BM + kPad, LDB = BN + kPad;
  constexpr int kGroups = NT / BM;  // db: threads per row of A
  __shared__ __align__(16) float As[kStages][kBK * LDA];
  __shared__ __align__(16) float Bs[kStages][kBK * LDB];
  __shared__ float db_s[kGroups][BM];

  const GemmProblem& P = args.p[blockIdx.z % args.nprob];
  const int chunk = blockIdx.z / args.nprob;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (m0 >= P.M || n0 >= P.N) return;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ty = (warp / WX) * 4 + lane / 8;
  const int tx = (warp % WX) * 8 + lane % 8;

  // the segments, cut to this CTA's chunk of the reduction
  const TA* a0 = reinterpret_cast<const TA*>(P.a0);
  const TB* b0 = reinterpret_cast<const TB*>(P.b0);
  int K0 = P.K0;
  const int K1 = args.kchunk ? 0 : P.K1;
  size_t shift = 0;
  if (args.kchunk) {
    const int kb = chunk * args.kchunk;
    K0 = min(args.kchunk, P.K0 - kb);
    a0 += LA == kLayK ? (size_t)kb : (size_t)kb * P.lda0;
    b0 += LB == kLayK ? (size_t)kb : (size_t)kb * P.ldb0;
    shift = (size_t)chunk * P.chunk_stride;
  }
  const int nt0 = (K0 + kBK - 1) / kBK;
  const int ntiles = nt0 + (K1 + kBK - 1) / kBK;
  const bool take_db = P.db != nullptr && blockIdx.x == 0;

  // slice q: an f32 operand by cp.async into its stage; a register operand
  // into ra or rb, stored into the stage by land(q) once the current slice's
  // products are done
  float ra[kRegA ? BM * kBK / NT : 1], rb[kRegB ? BN * kBK / NT : 1];
  auto issue = [&](int q) {
    const bool s1 = q >= nt0;
    const int k0 = (s1 ? q - nt0 : q) * kBK;
    const int st = q % kStages;
    const TA* a = s1 ? reinterpret_cast<const TA*>(P.a1) : a0;
    const TB* b = s1 ? reinterpret_cast<const TB*>(P.b1) : b0;
    if constexpr (kRegA) {
      fetch_slice<LA, BM, NT, MA>(ra, a, s1 ? P.lda1 : P.lda0, m0, P.M, k0, s1 ? K1 : K0, tid);
    } else {
      load_slice<LA, BM, NT>(As[st], a, s1 ? P.lda1 : P.lda0, m0, P.M, k0, s1 ? K1 : K0, tid);
    }
    if constexpr (kRegB) {
      fetch_slice<LB, BN, NT, MB>(rb, b, s1 ? P.ldb1 : P.ldb0, n0, P.N, k0, s1 ? K1 : K0, tid);
    } else {
      load_slice<LB, BN, NT>(Bs[st], b, s1 ? P.ldb1 : P.ldb0, n0, P.N, k0, s1 ? K1 : K0, tid);
    }
  };
  auto land = [&](int q) {
    if constexpr (kRegA) put_slice<LA, BM, NT>(As[q % kStages], ra, tid);
    if constexpr (kRegB) put_slice<LB, BN, NT>(Bs[q % kStages], rb, tid);
  };

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  float dbacc = 0.0f;

#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) {
    if (q < ntiles) {
      issue(q);
      land(q);
    }
    cp_async_commit();
  }
  for (int q = 0; q < ntiles; ++q) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slice q has landed; slice q - 1's stage is free
    if (q + kStages - 1 < ntiles) issue(q + kStages - 1);
    cp_async_commit();
    const float* as = As[q % kStages];
    const float* bs = Bs[q % kStages];
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 x0 = *reinterpret_cast<const float4*>(as + kk * LDA + ty * 4);
      const float4 x1 = *reinterpret_cast<const float4*>(as + kk * LDA + BM / 2 + ty * 4);
      const float a[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      float b[TN];
#pragma unroll
      for (int h = 0; h < TN / 4; ++h) {
        const float4 y = *reinterpret_cast<const float4*>(bs + kk * LDB + h * HW + tx * 4);
        b[4 * h] = y.x;
        b[4 * h + 1] = y.y;
        b[4 * h + 2] = y.z;
        b[4 * h + 3] = y.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (take_db) {  // thread (g, r) sums rows kk = g, g + kGroups, ... of A's column r
#pragma unroll
      for (int kk = tid / BM; kk < kBK; kk += kGroups) dbacc += as[kk * LDA + tid % BM];
    }
    // slice q + 2's stage was last read in iteration q - 1, before this
    // iteration's barrier
    if constexpr (kRegA || kRegB) {
      if (q + kStages - 1 < ntiles) land(q + kStages - 1);
    }
  }
  cp_async_wait<0>();

  if (take_db) {
    db_s[tid / BM][tid % BM] = dbacc;
    __syncthreads();
    if (tid < BM && m0 + tid < P.M) {
      float s = 0.0f;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) s += db_s[g][tid];
      P.db[shift + m0 + tid] = s;
    }
  }

  const int T = P.rs_B > 0 ? P.M / P.rs_B : 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + i - 4);
    if (m >= P.M) continue;
    size_t row = m;
    if (P.rs_B > 0) {
      const int t = m / P.rs_B, b = m % P.rs_B;
      row = (size_t)(P.rs_dir ? T - 1 - t : t) * 2 * P.rs_B + (size_t)P.rs_dir * P.rs_B + b;
    }
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const int n = n0 + h * HW + tx * 4;
      if (n >= P.N) continue;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n + j;
        v[j] = acc[i][h * 4 + j];
        if (P.bias != nullptr && c < P.N) {
          v[j] += P.bias[c];
          if (c < P.fold_n) v[j] += P.fold[c];
        }
      }
      if constexpr (OBF) {
        store4_bf16(P, row, shift, n, v);
      } else {
        store4(P, row, shift, n, v);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 tensor-core core: gemm_kernel_tc
// ---------------------------------------------------------------------------

constexpr int kTcBK = 32;       // depth of a k slice: two m16n8k16 steps
constexpr int kTcPad = 8;       // bf16 values of padding after each row of a tile
constexpr int kTcThreads = 256;

// Four consecutive values of an operand in mode MODE as loaded: 4 bf16 in
// 8 bytes (kOpBF16) or 4 f32 in 16 bytes (kOpRound).
template <int MODE>
using TcRaw = std::conditional_t<MODE == kOpBF16, uint2, float4>;

// The values src[0..n) of an operand, zeros from n on (n <= 0: nothing is
// read); one load where `vec` (src aligned to the four values) and n = 4.
template <int MODE>
__device__ __forceinline__ TcRaw<MODE> tc_load4(const typename OpElem<MODE>::T* src, int n,
                                                 bool vec) {
  if (vec && n >= 4) return *reinterpret_cast<const TcRaw<MODE>*>(src);
  if constexpr (MODE == kOpBF16) {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
    unsigned e[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) e[j] = j < n ? s[j] : 0u;
    return make_uint2(e[0] | (e[1] << 16), e[2] | (e[3] << 16));
  } else {
    float e[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) e[j] = j < n ? src[j] : 0.0f;
    return make_float4(e[0], e[1], e[2], e[3]);
  }
}

// tc_load4's values as 4 bf16 (f32 rounded to the nearest even bf16).
template <int MODE>
__device__ __forceinline__ uint2 tc_pack(const TcRaw<MODE>& v) {
  if constexpr (MODE == kOpBF16) {
    return v;
  } else {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    return make_uint2(*reinterpret_cast<const unsigned*>(&lo), *reinterpret_cast<const unsigned*>(&hi));
  }
}

// A segment may be read 4 values a load: its base aligned to them, its row
// pitch a multiple of 4.
template <typename T>
__device__ __forceinline__ bool tc_vec(const T* p, int ld) {
  return (reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T))) == 0 && ld % 4 == 0;
}

// One operand's R x kTcBK slice (rows r0.., k0..) in the registers of this
// thread: R * kTcBK / 4 chunks of 4 values along the operand's contiguous
// index, chunk tid + j * kTcThreads for j < kChunks, consecutive threads on
// consecutive addresses. Stored into a stage as [r][k] (pitch kTcBK + kTcPad)
// for kLayK, [k][r] (pitch R + kTcPad) for kLayR.
template <int L, int R, int MODE>
struct TcSlice {
  static constexpr int kChunks = R * kTcBK / 4 / kTcThreads;
  static constexpr int kPitch = L == kLayK ? kTcBK + kTcPad : R + kTcPad;
  static constexpr int kStage = L == kLayK ? R * kPitch : kTcBK * kPitch;  // bf16 values
  static_assert(kChunks >= 1 && kChunks * 4 * kTcThreads == R * kTcBK, "tile and threads do not divide");
  TcRaw<MODE> v[kChunks];

  // (row, k) offsets in the tile of chunk j, for kLayK / kLayR
  __device__ __forceinline__ static void at(int j, int tid, int* r, int* k) {
    const int c = tid + j * kTcThreads;
    if constexpr (L == kLayK) {
      *r = c / (kTcBK / 4);
      *k = c % (kTcBK / 4) * 4;
    } else {
      *k = c / (R / 4);
      *r = c % (R / 4) * 4;
    }
  }

  __device__ __forceinline__ void fetch(const typename OpElem<MODE>::T* p, int ld, bool vec, int r0,
                                        int rmax, int k0, int kmax, int tid) {
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      int r, k;
      at(j, tid, &r, &k);
      const int gr = r0 + r, gk = k0 + k;
      int n;
      size_t off = 0;
      if constexpr (L == kLayK) {
        n = gr < rmax ? kmax - gk : 0;
        if (n > 0) off = (size_t)gr * ld + gk;
      } else {
        n = gk < kmax ? rmax - gr : 0;
        if (n > 0) off = (size_t)gk * ld + gr;
      }
      v[j] = tc_load4<MODE>(p + off, n, vec);
    }
  }

  __device__ __forceinline__ void store(__nv_bfloat16* s, int tid) const {
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      int r, k;
      at(j, tid, &r, &k);
      *reinterpret_cast<uint2*>(s + (L == kLayK ? r * kPitch + k : k * kPitch + r)) = tc_pack<MODE>(v[j]);
    }
  }
};

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += a b: a 16 x 16 bf16 tile of A (row-major fragments), b a 16 x 8 tile
// of B (column-major), d 16 x 8 f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The FMA kernels' epilogue on one 4-column block of output (m, n..n + 3):
// bias and fold, K6's row map, store4 (f32) or store4_bf16 (OBF).
template <bool OBF>
__device__ __forceinline__ void tc_epilogue4(const GemmProblem& P, int m, int n, float (&v)[4]) {
  if (m >= P.M || n >= P.N) return;
  size_t row = m;
  if (P.rs_B > 0) {
    const int T = P.M / P.rs_B, t = m / P.rs_B, b = m % P.rs_B;
    row = (size_t)(P.rs_dir ? T - 1 - t : t) * 2 * P.rs_B + (size_t)P.rs_dir * P.rs_B + b;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = n + j;
    if (P.bias != nullptr && c < P.N) {
      v[j] += P.bias[c];
      if (c < P.fold_n) v[j] += P.fold[c];
    }
  }
  if constexpr (OBF) {
    store4_bf16(P, row, 0, n, v);
  } else {
    store4(P, row, 0, n, v);
  }
}

// The core on the tensor cores, for A read in mode MA (kOpBF16 or kOpRound)
// and B in mode MB = kOpRound, in layouts LA = kLayK and LB (kLayK for gi
// and gh, kLayR for dX), bf16 outputs with OBF; GemmProblem's fields but
// db and the row chunks (kchunk). Grid: x column tiles, y row tiles (of the
// largest problem), z problem; 256 threads in WARPS_M x WARPS_N warps, warp
// (wm, wn) owning the WM x WN block (wm WM.., wn WN..) of the BM x BN tile as
// MI x NI mma tiles of 16 x 8.
template <int LA, int LB, int MA, int MB, bool OBF, int BM, int BN>
__global__ void __launch_bounds__(kTcThreads, 2) gemm_kernel_tc(const __grid_constant__ GemmArgs args) {
  static_assert(LA == kLayK && MA != kOpF32 && MB == kOpRound, "gemm_kernel_tc: A along k, both bf16");
  constexpr int WARPS_M = 4, WARPS_N = kTcThreads / 32 / WARPS_M;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N, MI = WM / 16, NI = WN / 8;
  static_assert(MI >= 1 && NI % 2 == 0 && MI * 16 * WARPS_M == BM && NI * 8 * WARPS_N == BN, "warp tiles");
  using SA = TcSlice<LA, BM, MA>;
  using SB = TcSlice<LB, BN, MB>;
  using TA = typename OpElem<MA>::T;
  using TB = typename OpElem<MB>::T;
  __shared__ __align__(16) __nv_bfloat16 As[2][SA::kStage];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][SB::kStage];

  const GemmProblem& P = args.p[blockIdx.z];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (m0 >= P.M || n0 >= P.N) return;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

  const TA* a0 = reinterpret_cast<const TA*>(P.a0);
  const TA* a1 = reinterpret_cast<const TA*>(P.a1);
  const TB* b0 = reinterpret_cast<const TB*>(P.b0);
  const TB* b1 = reinterpret_cast<const TB*>(P.b1);
  const bool va0 = tc_vec(a0, P.lda0), vb0 = tc_vec(b0, P.ldb0);
  const bool va1 = P.K1 > 0 && tc_vec(a1, P.lda1), vb1 = P.K1 > 0 && tc_vec(b1, P.ldb1);
  const int nt0 = (P.K0 + kTcBK - 1) / kTcBK;
  const int ntiles = nt0 + (P.K1 + kTcBK - 1) / kTcBK;

  SA ra;
  SB rb;
  auto fetch = [&](int q) {
    const bool s1 = q >= nt0;
    const int k0 = (s1 ? q - nt0 : q) * kTcBK, K = s1 ? P.K1 : P.K0;
    ra.fetch(s1 ? a1 : a0, s1 ? P.lda1 : P.lda0, s1 ? va1 : va0, m0, P.M, k0, K, tid);
    rb.fetch(s1 ? b1 : b0, s1 ? P.ldb1 : P.ldb0, s1 ? vb1 : vb0, n0, P.N, k0, K, tid);
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  if (ntiles > 0) {
    fetch(0);
    ra.store(As[0], tid);
    rb.store(Bs[0], tid);
  }
  if (ntiles > 1) fetch(1);
  for (int q = 0; q < ntiles; ++q) {
    // slice q's stage is complete; slice q + 1's stage was last read in iteration q - 1
    __syncthreads();
    if (q + 1 < ntiles) {
      ra.store(As[(q + 1) % 2], tid);
      rb.store(Bs[(q + 1) % 2], tid);
    }
    if (q + 2 < ntiles) fetch(q + 2);
    const __nv_bfloat16* as = As[q % 2];
    const __nv_bfloat16* bs = Bs[q % 2];
#pragma unroll
    for (int ks = 0; ks < kTcBK; ks += 16) {
      unsigned af[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldmatrix_x4(af[i], as + (wm * WM + i * 16 + lane % 16) * SA::kPitch + ks + lane / 16 * 8);
#pragma unroll
      for (int j = 0; j < NI; j += 2) {
        // b[0], b[1]: the k halves of n tile j; b[2], b[3]: of n tile j + 1
        unsigned b[4];
        if constexpr (LB == kLayK) {
          ldmatrix_x4(b, bs + (wn * WN + j * 8 + lane % 8 + lane / 16 * 8) * SB::kPitch + ks +
                             lane / 8 % 2 * 8);
        } else {
          ldmatrix_x4_trans(b, bs + (ks + lane % 8 + lane / 8 % 2 * 8) * SB::kPitch + wn * WN + j * 8 +
                                   lane / 16 * 8);
        }
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          mma_bf16(acc[i][j], af[i], b[0], b[1]);
          mma_bf16(acc[i][j + 1], af[i], b[2], b[3]);
        }
      }
    }
  }

  // Lane (g, c) = (lane / 4, lane % 4) holds rows g and g + 8, columns 2c and
  // 2c + 1 of each mma tile; an exchange with lane c ^ 1 leaves the even lane
  // row g and the odd lane row g + 8, each at columns 4 (c / 2) .. + 3.
  const int g = lane / 4, c = lane % 4;
  const bool odd = c & 1;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const float* a = acc[i][j];
      const float x0 = __shfl_xor_sync(0xffffffffu, odd ? a[0] : a[2], 1);
      const float x1 = __shfl_xor_sync(0xffffffffu, odd ? a[1] : a[3], 1);
      float v[4] = {odd ? x0 : a[0], odd ? x1 : a[1], odd ? a[2] : x0, odd ? a[3] : x1};
      tc_epilogue4<OBF>(P, m0 + wm * WM + i * 16 + g + (odd ? 8 : 0), n0 + wn * WN + j * 8 + c / 2 * 4,
                        v);
    }
  }
}

// The tile of gemm_kernel_tc for nprob problems of at most M x N: 0 (128 x
// 64), 1 (64 x 64) or 2 (64 x 32), the largest whose grid gives every SM
// two CTAs; else the smallest.
inline int tc_tile(int nprob, int M, int N, int sms) {
  constexpr int kBM[3] = {128, 64, 64}, kBN[3] = {64, 64, 32};
  for (int t = 0; t < 3; ++t) {
    if ((long long)nprob * ((M + kBM[t] - 1) / kBM[t]) * ((N + kBN[t] - 1) / kBN[t]) >= 2LL * sms) return t;
  }
  return 2;
}

inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// gemm_kernel_tc over args' problems on the tile tc_tile picks; refuses
// row chunks and db, which it does not take.
template <int LA, int LB, int MA, int MB, bool OBF>
cudaError_t launch_gemm_tc(const GemmArgs& args, int nchunks, cudaStream_t st) {
  int M = 0, N = 0;
  for (int i = 0; i < args.nprob; ++i) {
    if (args.p[i].db != nullptr) return cudaErrorInvalidValue;
    M = std::max(M, args.p[i].M);
    N = std::max(N, args.p[i].N);
  }
  if (nchunks != 1 || args.kchunk != 0) return cudaErrorInvalidValue;
  if (M == 0 || N == 0) return cudaSuccess;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const unsigned z = (unsigned)args.nprob;
  __atomic_fetch_add(&tsl_gemm_tc_launches, 1ULL, __ATOMIC_RELAXED);
  switch (tc_tile(args.nprob, M, N, sms)) {
    case 0:
      gemm_kernel_tc<LA, LB, MA, MB, OBF, 128, 64>
          <<<dim3((N + 63) / 64, (M + 127) / 128, z), kTcThreads, 0, st>>>(args);
      break;
    case 1:
      gemm_kernel_tc<LA, LB, MA, MB, OBF, 64, 64>
          <<<dim3((N + 63) / 64, (M + 63) / 64, z), kTcThreads, 0, st>>>(args);
      break;
    default:
      gemm_kernel_tc<LA, LB, MA, MB, OBF, 64, 32>
          <<<dim3((N + 31) / 32, (M + 63) / 64, z), kTcThreads, 0, st>>>(args);
  }
  return cudaGetLastError();
}

// Launches the core over args' problems and `nchunks` row chunks: the
// products whose operands are both bf16 (MA kOpBF16 or kOpRound, MB
// kOpRound) on the tensor cores, gemm_kernel_tc on its own tile; the others
// with the 128 x BN tile (BN 64 or 128): gemm_kernel (f32), or
// gemm_kernel_mixed (dW at bf16: MA kOpF32, MB kOpBF16).
template <int LA, int LB, int MA = kOpF32, int MB = kOpF32, bool OBF = false>
cudaError_t launch_gemm(const GemmArgs& args, int nchunks, int bn, cudaStream_t st) {
  if constexpr (MA != kOpF32 && MB == kOpRound) {
    return launch_gemm_tc<LA, LB, MA, MB, OBF>(args, nchunks, st);
  } else {
    int M = 0, N = 0;
    for (int i = 0; i < args.nprob; ++i) {
      M = std::max(M, args.p[i].M);
      N = std::max(N, args.p[i].N);
    }
    if (M == 0 || N == 0) return cudaSuccess;
    const unsigned z = (unsigned)(args.nprob * nchunks);
    const dim3 g64((N + 63) / 64, (M + 127) / 128, z), g128((N + 127) / 128, (M + 127) / 128, z);
    if constexpr (MA == kOpF32 && MB == kOpF32 && !OBF) {
      if (bn == 64) {
        gemm_kernel<LA, LB, 128, 64, 4><<<g64, 256, 0, st>>>(args);
      } else {
        gemm_kernel<LA, LB, 128, 128, 8><<<g128, 256, 0, st>>>(args);
      }
    } else if (bn == 64) {
      gemm_kernel_mixed<LA, LB, 128, 64, 4, MA, MB, OBF><<<g64, 256, 0, st>>>(args);
    } else {
      gemm_kernel_mixed<LA, LB, 128, 128, 8, MA, MB, OBF><<<g128, 256, 0, st>>>(args);
    }
    return cudaGetLastError();
  }
}

// The column tile of an unsplit product: 64 where the output is narrow or
// where 128-wide tiles would leave SMs idle, else 128.
inline int pick_bn(const GemmArgs& args, int sms) {
  int M = 0, N = 0;
  for (int i = 0; i < args.nprob; ++i) {
    M = std::max(M, args.p[i].M);
    N = std::max(N, args.p[i].N);
  }
  const long long wide = (long long)args.nprob * ((M + 127) / 128) * ((N + 127) / 128);
  return N <= 64 || wide < sms ? 64 : 128;
}

// gi (or gh) of one direction: [x1 | x2] (M x d1, M x d2; f32 or bf16)
// times w^T (w: N x (d1 + d2), torch layout, f32) plus b, into out (M x N,
// f32).
template <typename T>
inline GemmProblem proj_problem(const T* x1, int d1, const same_t<T>* x2, int d2, const float* w,
                                const float* b, float* out, int M, int N) {
  GemmProblem P = {};
  P.a0 = reinterpret_cast<const float*>(x1);
  P.lda0 = d1;
  P.b0 = w;
  P.ldb0 = d1 + d2;
  P.K0 = d1;
  if (d2 > 0) {
    P.a1 = reinterpret_cast<const float*>(x2);
    P.lda1 = d2;
    P.b1 = w + d1;
    P.ldb1 = d1 + d2;
    P.K1 = d2;
  }
  P.M = M;
  P.N = N;
  P.out = out;
  P.ldo = N;
  P.n_split = N;
  P.bias = b;
  return P;
}

// The projections of args, their x (or h_prev) operands stored as T: f32,
// or bf16 with the f32 weights rounded to bf16 as they are read.
template <typename T = float>
inline cudaError_t launch_proj(const GemmArgs& args, cudaStream_t st) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  constexpr bool kBF = kOpOf<T> == kOpBF16;
  return launch_gemm<kLayK, kLayK, kOpOf<T>, kBF ? kOpRound : kOpF32>(args, 1, pick_bn(args, sms),
                                                                     st);
}

// gi of both directions (ndir = 2, out (2, M, N)) or of the _f operands
// alone (ndir = 1); x f32 or bf16, gi f32.
template <typename T>
inline cudaError_t launch_gi_proj(const T* x1, int d1, const same_t<T>* x2, int d2,
                                  const float* w_f, const float* b_f, const float* w_b,
                                  const float* b_b, float* out, int M, int N, int ndir,
                                  cudaStream_t st) {
  GemmArgs args = {};
  args.nprob = ndir;
  args.p[0] = proj_problem(x1, d1, x2, d2, w_f, b_f, out, M, N);
  if (ndir == 2) args.p[1] = proj_problem(x1, d1, x2, d2, w_b, b_b, out + (size_t)M * N, M, N);
  return launch_proj<T>(args, st);
}

// The row-stacked projection of K6 over both directions of T x B rows, b_hh's
// r and z columns folded into b_ih; x f32 or bf16 (the weights then rounded
// to bf16 as they are read), gi f32.
template <typename TX = float>
inline cudaError_t launch_gi_proj_rs(const TX* x1, int d1, const same_t<TX>* x2, int d2,
                                     const float* w_f, const float* b_f, const float* bhh_f,
                                     const float* w_b, const float* b_b, const float* bhh_b,
                                     float* out, int T, int B, int N, cudaStream_t st) {
  GemmArgs args = {};
  args.nprob = 2;
  for (int d = 0; d < 2; ++d) {
    GemmProblem& P = args.p[d];
    P = proj_problem(x1, d1, x2, d2, d ? w_b : w_f, d ? b_b : b_f, out, T * B, N);
    P.fold = d ? bhh_b : bhh_f;
    P.fold_n = 2 * N / 3;
    P.rs_B = B;
    P.rs_dir = d;
  }
  return launch_proj<TX>(args, st);
}

// dx = sum_dir dgi[dir] W_ih_dir over k < H3, for n < D = d1 + d2; column n
// goes to dx1 (M x d1, n < d1) or dx2 (M x d2).
inline cudaError_t launch_dx(const float* dgi, const float* wih_f, const float* wih_b,
                             float* dx1, int d1, float* dx2, int d2, int M, int H3, int ndir,
                             cudaStream_t st) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int D = d1 + d2;
  GemmArgs args = {};
  args.nprob = 1;
  GemmProblem& P = args.p[0];
  P.a0 = dgi;
  P.lda0 = H3;
  P.b0 = wih_f;
  P.ldb0 = D;
  P.K0 = H3;
  if (ndir == 2) {
    P.a1 = dgi + (size_t)M * H3;
    P.lda1 = H3;
    P.b1 = wih_b;
    P.ldb1 = D;
    P.K1 = H3;
  }
  P.M = M;
  P.N = D;
  P.out = dx1;
  P.ldo = d1;
  P.out2 = dx2;
  P.ldo2 = d2;
  P.n_split = d1;
  return launch_gemm<kLayK, kLayR>(args, 1, pick_bn(args, sms), st);
}

// dX of both directions at bf16, rounded as the TPU kernel rounds it: each
// direction's dgi (f32, rounded to bf16 as it is read) times its bf16 W_ih
// into ITS OWN bf16 rows, pair[dir] (M x D), then their sum rounded again
// (the TPU kernel writes each direction's dX in bf16 and XLA adds the two,
// pallas_gru.py:1433-1436 and :1536).
__global__ void dx_pair_sum_kernel(const __nv_bfloat16* __restrict__ pair, int M, int D, int d1,
                                   __nv_bfloat16* __restrict__ dx1,
                                   __nv_bfloat16* __restrict__ dx2) {
  const size_t total = (size_t)M * D;
  const int d2 = D - d1;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const __nv_bfloat16 v =
        __float2bfloat16_rn(__bfloat162float(pair[e]) + __bfloat162float(pair[total + e]));
    const size_t m = e / D;
    const int n = (int)(e % D);
    if (n < d1) {
      dx1[m * d1 + n] = v;
    } else {
      dx2[m * d2 + (n - d1)] = v;
    }
  }
}

// dx (split at d1 into dx1 and dx2, bf16) of the two directions' dgi (2, M,
// H3, f32) and W_ih (H3 x D, f32), both rounded to bf16 as they are read,
// through `pair` (2 x M x D bf16). One direction (ndir = 1, K5b): its dX
// rounded once, straight into dx1 and dx2; `pair` is not read.
inline cudaError_t launch_dx_bf16(const float* dgi, const float* wih_f, const float* wih_b,
                                  __nv_bfloat16* dx1, int d1,
                                  __nv_bfloat16* dx2, int d2, __nv_bfloat16* pair, int M, int H3,
                                  cudaStream_t st, int ndir = 2) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int D = d1 + d2;
  GemmArgs args = {};
  if (ndir == 1) {
    args.nprob = 1;
    GemmProblem& P = args.p[0];
    P.a0 = dgi;
    P.lda0 = H3;
    P.b0 = wih_f;
    P.ldb0 = D;
    P.K0 = H3;
    P.M = M;
    P.N = D;
    P.out = reinterpret_cast<float*>(dx1);
    P.ldo = d1;
    P.out2 = reinterpret_cast<float*>(dx2);
    P.ldo2 = d2;
    P.n_split = d1;
    return launch_gemm<kLayK, kLayR, kOpRound, kOpRound, true>(args, 1, pick_bn(args, sms), st);
  }
  args.nprob = 2;
  for (int d = 0; d < 2; ++d) {
    GemmProblem& P = args.p[d];
    P.a0 = dgi + (size_t)d * M * H3;
    P.lda0 = H3;
    P.b0 = d ? wih_b : wih_f;
    P.ldb0 = D;
    P.K0 = H3;
    P.M = M;
    P.N = D;
    P.out = reinterpret_cast<float*>(pair + (size_t)d * M * D);
    P.ldo = D;
    P.n_split = D;
  }
  err = launch_gemm<kLayK, kLayR, kOpRound, kOpRound, true>(args, 1, pick_bn(args, sms), st);
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)M * D;
  const int blocks = (int)std::min<size_t>((total + 255) / 256, (size_t)sms * 8);
  dx_pair_sum_kernel<<<blocks, 256, 0, st>>>(pair, M, D, d1, dx1, dx2);
  return cudaGetLastError();
}

// The split of dW's reduction over M rows for outputs of H3 rows and parts
// of d1 and d2 columns in ndir directions: the column tile, the row chunk
// (a multiple of kBK, at least 64 rows) and the number of chunks, as many
// as give every SM two CTAs.
inline void dw_plan(int H3, int d1, int d2, int M, int ndir, int sms, int* bn, int* chunk,
                    int* nchunks) {
  *bn = std::max(d1, d2) <= 64 ? 64 : 128;
  const int cols = (d1 + *bn - 1) / *bn + (d2 + *bn - 1) / *bn;
  const int tiles = ndir * ((H3 + 127) / 128) * cols;
  int S = (2 * sms + tiles - 1) / tiles;  // two CTAs an SM
  S = std::max(1, std::min(S, (M + 63) / 64));
  *chunk = ((M + S - 1) / S + kBK - 1) / kBK * kBK;
  *nchunks = (M + *chunk - 1) / *chunk;
}

// Floats of one chunk's slots: dW (H3 x D) and db (H3) of each direction.
inline long long dw_slot_floats(int H3, int D, int ndir) {
  return (long long)ndir * ((long long)H3 * D + H3);
}

// Sums the chunks' slots in chunk order into dW (H3, D) and db (H3) of each
// direction.
__global__ void dw_reduce_kernel(const float* __restrict__ partial, int S, int H3, int D,
                                 float* __restrict__ dw_f, float* __restrict__ db_f,
                                 float* __restrict__ dw_b, float* __restrict__ db_b, int ndir) {
  const size_t per_dir = (size_t)H3 * D + H3;
  const size_t stride = ndir * per_dir;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < stride;
       e += (size_t)gridDim.x * blockDim.x) {
    const int dir = (int)(e / per_dir);
    const size_t r = e % per_dir;
    float s = 0.0f;
    for (int c = 0; c < S; ++c) s += partial[(size_t)c * stride + e];
    if (r < (size_t)H3 * D) {
      (dir == 0 ? dw_f : dw_b)[r] = s;
    } else {
      (dir == 0 ? db_f : db_b)[r - (size_t)H3 * D] = s;
    }
  }
}

// Floats of the `partial` workspace weight_grads needs.
inline long long dw_partial_floats(int H3, int d1, int d2, int M, int ndir, int sms) {
  int bn = 0, chunk = 0, S = 0;
  dw_plan(H3, d1, d2, M, ndir, sms, &bn, &chunk, &S);
  return (long long)S * dw_slot_floats(H3, d1 + d2, ndir);
}

// dW (H3, d1 + d2) and db (H3) of each direction: A[dir] (M x H3, f32)
// summed against X_dir = [x1 | x2] (x*_f for dir 0, x*_b for dir 1; f32 or
// bf16) over the M rows, by row chunks into `partial`, then the reduce pass.
template <typename T>
inline cudaError_t weight_grads(const float* A, int H3, const T* x1_f, const same_t<T>* x2_f,
                                const same_t<T>* x1_b, const same_t<T>* x2_b, int d1, int d2,
                                float* partial, float* dw_f, float* db_f, float* dw_b,
                                float* db_b, int M, int sms, cudaStream_t st, int ndir = 2) {
  const int D = d1 + d2;
  int bn = 0, chunk = 0, S = 0;
  dw_plan(H3, d1, d2, M, ndir, sms, &bn, &chunk, &S);
  const long long slot = dw_slot_floats(H3, D, ndir);
  GemmArgs args = {};
  args.kchunk = chunk;
  for (int dir = 0; dir < ndir; ++dir) {
    float* base = partial + (size_t)dir * ((size_t)H3 * D + H3);
    for (int p = 0; p < 2; ++p) {
      const int dp = p == 0 ? d1 : d2;
      if (dp == 0) continue;
      GemmProblem& P = args.p[args.nprob++];
      P.a0 = A + (size_t)dir * M * H3;
      P.lda0 = H3;
      P.b0 = reinterpret_cast<const float*>(p == 0 ? (dir == 0 ? x1_f : x1_b)
                                                   : (dir == 0 ? x2_f : x2_b));
      P.ldb0 = dp;
      P.K0 = M;
      P.M = H3;
      P.N = dp;
      P.out = base + (p == 0 ? 0 : d1);
      P.ldo = D;
      P.n_split = dp;
      P.db = p == 0 ? base + (size_t)H3 * D : nullptr;
      P.chunk_stride = slot;
    }
  }
  cudaError_t err = launch_gemm<kLayR, kLayR, kOpF32, kOpOf<T>>(args, S, bn, st);
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)slot;
  const int blocks = (int)std::min<size_t>((total + 255) / 256, (size_t)sms * 8);
  dw_reduce_kernel<<<blocks, 256, 0, st>>>(partial, S, H3, D, dw_f, db_f, dw_b, db_b, ndir);
  return cudaGetLastError();
}

}  // namespace
