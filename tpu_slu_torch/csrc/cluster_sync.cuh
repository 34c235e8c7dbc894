// Thread-block cluster exchange primitives for sm_90a, shared by the cluster
// recurrence (gru_cluster.cuh: K1 and K5f) and the beam search (K7,
// beam_decode.cu): a CTA sends 4-byte values into a peer CTA's shared memory
// by `st.async`, and each store's bytes complete a transaction count on an
// mbarrier in the receiving CTA, which waits on that mbarrier's phase. No
// cluster barrier is taken: one costs ~1.5 us on an H100, most of it the
// release that also waits for the CTA's global stores (PERF.md section 6).
// Included by each source; the anonymous namespace gives each its own copy.

#pragma once

#include <cuda_runtime.h>

namespace {

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

__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

// Makes the mbarrier inits visible to the cluster's st.async.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arms the mbarrier's current phase: it completes once `bytes` bytes have
// landed (its one arrival is this call).
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

// A full cluster barrier that orders every thread's prior global and shared
// stores before every thread's later loads, across the cluster.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

}  // namespace
