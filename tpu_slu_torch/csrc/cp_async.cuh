// The cp.async copies of the port's kernels, for sm_80 and later: 4- and
// 16-byte copies from device to shared memory that zero-fill when `valid`
// is false (reading nothing), grouped and awaited by commit groups. The GEMM
// core (bigru_gemm.cuh), the cluster recurrences and K8 (sinc_frontend.cu)
// stage their operands with them. Included by each source; the anonymous
// namespace gives each its own copy.

#pragma once

namespace {

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

// dst and src 16-byte aligned
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Waits until at most N of this thread's commit groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace
