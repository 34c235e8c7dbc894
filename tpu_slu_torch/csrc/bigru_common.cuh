// Pieces shared by the bi-GRU kernels (K1 and K6 bigru_shared_fwd.cu, K2
// bigru_trainpool_fwd.cu, K3 bigru_shared_bwd.cu, K4f and K5f
// bigru_masked_fwd.cu, K4b and K5b bigru_masked_bwd.cu): the logistic
// sigmoid, the dropout hash (K2's epilogue in gru_cluster.cuh, the gate pass
// of the backward kernels) and the choice of batch tile; the input
// projection is the GEMM core's (bigru_gemm.cuh); the conversions between
// a stream's storage type (f32, or bf16 at compute_dtype=bfloat16) and the
// f32 arithmetic. Arithmetic is f32 with f32 accumulation. Included by each
// source; the anonymous namespace gives each its own copy.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bigru_gemm.cuh"

namespace {

__device__ __forceinline__ float sigmoid_(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// x stored as T: itself, or rounded to the nearest even bf16
template <typename T>
__device__ __forceinline__ T from_f32(float x) {
  if constexpr (std::is_same_v<T, float>) {
    return x;
  } else {
    return __float2bfloat16_rn(x);
  }
}

// Dropout keep decision of the fused train path at natural (t, b, h):
// `_keep_mask` of tpu_slu/ops/pallas_gru.py, bit for bit (two rounds of a
// murmur-style finaliser, top 24 bits against thresh = round((1-p) 2^24)).
__device__ __forceinline__ bool keep_hash(uint32_t seed, uint32_t salt, uint32_t t, uint32_t b,
                                          uint32_t h, uint32_t thresh) {
  uint32_t x = (seed ^ salt) + t * 0x9E3779B1u + b * 0x85EBCA77u + h * 0xC2B2AE3Du;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    x ^= x >> 16;
    x *= 0x7FEB352Du;
    x ^= x >> 15;
    x *= 0x846CA68Bu;
  }
  x ^= x >> 16;
  return (x >> 8) < thresh;
}

constexpr uint32_t kSaltF = 0x9E3779B9u;
constexpr uint32_t kSaltB = 0x7F4A7C15u;
constexpr uint32_t kKeepAll = 1u << 24;  // thresh for p = 0: every element kept

// The smallest batch tile of 1, 2, 4 or 8 rows whose ctas * ceil(B / tile)
// CTAs (ctas a tile: one per direction, or the cluster recurrence's C per
// direction) fit in one wave of the card's SMs: a serial step's time grows
// with the rows a CTA carries, and the CTAs run side by side.
inline cudaError_t pick_batch_tile(int B, int* nb, int ctas = 2) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  *nb = 8;
  for (int cand = 1; cand < 8; cand *= 2) {
    if (ctas * ((B + cand - 1) / cand) <= sms) {
      *nb = cand;
      break;
    }
  }
  return cudaSuccess;
}

}  // namespace
