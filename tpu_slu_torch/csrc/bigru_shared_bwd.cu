// Shared-stream bidirectional GRU layer, BACKWARD (K3), for sm_90a.
//
// Replaces the TPU kernel `_mk_shared_bwd_kernel` in
// tpu_slu/ops/pallas_gru.py:1293 (reached through `_shared_bwd_call`): the
// VJP of K1's unpooled forward (plain mode: full-rate cotangents) and of
// K2's train forward (fused mode: POOLED cotangents, expanded here by the
// window count and the keep mask regenerated from the layer's seed). It
// takes the layer's parts, the h_prev residuals of both directions at
// natural t, the cotangents and the weights, and returns dX (summed over
// both directions, split at the parts' column offsets), dW_ih, dW_hh,
// db_ih and db_hh of both directions, in torch layout.
//
// The TPU kernel walks time blocks on a sequential grid and carries dh and
// the dW sums in VMEM from block to block. CUDA blocks run in no order, so
// the work is cut into three phases instead:
//   1. Gates (parallel over T): gi = x W_ih^T + b_ih and gh = hp W_hh^T +
//      b_hh for all T (the GEMM core, one launch), then the gate tensor
//      [gh_n r(1-r), z, n, r] (2, T, B, 4H) and, in fused mode, the
//      expanded dY (2, T, B, H). The logistic sigmoid, as K1 and K2 use.
//   2. The serial dh chain, on the backward cluster recurrence of
//      gru_cluster_bwd.cuh (K4b's and K5b's, with its SPLIT flag: each
//      direction's h_prev and cotangent at a base of its own): a
//      thread-block cluster of C CTAs per (batch tile, direction), each
//      holding its hidden units' columns of W_hh in registers and sending
//      each step's dgh to the others by st.async. The forward direction's
//      gradient walks t = T-1..0, the backward direction's t = 0..T-1; each
//      step is dh <- dgh W_hh + dh z and writes dgi and dgh = [dgi_rz,
//      dgi_n r] (2, T, B, 3H), over the phase-1 buffers.
//   3. Products (parallel): dX = sum_dir dgi W_ih; dW_ih = dgi^T x and
//      dW_hh = dgh^T hp; db the column sums of dgi and dgh. All of them, and
//      phase 1's gi and gh, are the one f32 GEMM core of bigru_gemm.cuh;
//      the dW reduction over T*B rows is cut into row chunks, each written
//      to its own slot, then summed in chunk order: no float atomics, so
//      repeated runs agree bit for bit.
// The gate kernel of phase 1 and the products do not depend on the order of
// the rows; they are shared with K4b and K5b (bigru_masked_bwd.cu).
//
// What bounds it on this card:
//   * the products: at the flagship's five layers and B = 64, ~55 GFLOP of
//     f32 FMAs (dW 21.7, dX 11.8, the recomputed x W_ih^T 11.8 and h_prev
//     W_hh^T 9.75), 0.82 ms at the 67 TFLOP/s f32 peak. Until this core they
//     ran in 64 x 64 tiles at ~5 TFLOP/s (dW: 4.3 ms), shared-memory bound,
//     with too few CTAs for dW and a ones column for db;
//   * the rest: the serial chain of 2T steps (T per direction, side by
//     side) of (NB, 3H) x (3H, H) products, latency-bound as K1's forward
//     (~1.1 ms over the five layers at B = 64, ~1.45 us a step); the gate
//     and reduce passes are a few bandwidth-bound sweeps.
// What the design does about it: everything without a serial dependence
// (gate math and transcendentals, the cotangent expansion and the mask
// hash, every product but dh's) leaves the chain, which keeps only the
// recurrent product and a few multiplies per element per step. The products
// take the GEMM core: 128 x 128 tiles of 8 x 8 accumulators a thread fed
// from a 3-stage cp.async ring, phase 1's four products (gi and gh of both
// directions) in one launch, dW split into as many row chunks as give every
// SM two CTAs, db summed from the tiles already in shared memory. The chain
// runs a step on C SMs with W_hh in registers and no CTA barrier.
//
// At compute_dtype=bfloat16 (`tsl_bigru_shared_bwd_bf16`) x, h_prev, the
// cotangents and dX are bf16, the f32 weights are rounded to bf16 as they
// are read, and the TPU kernel's rounding points (pallas_gru.py:1384-1441)
// are kept: phase 1 recomputes the gates from bf16 x and h_prev against the
// rounded weights, and widens the (pooled or full-rate) cotangents to an
// f32 dY; the chain (gru_cluster_bwd.cuh's BF) holds its units' columns of
// W_hh rounded to bf16 and rounds the dgh it sends for the next step's
// product, its dh carry and dgi and dgh f32, and reads the bf16 h_prev as it
// is (the ring copies the 4-byte word that holds a value); dX reads the f32
// dgi rounded to bf16, each direction's stored as bf16 and
// their sum rounded again, as the TPU kernel and XLA do; dW_ih = x^T dgi
// and dW_hh = h_prev^T dgh take the f32 dgi and dgh, and every weight and
// bias gradient is f32.

#include "bigru_bwd_common.cuh"
#include "gru_cluster_bwd.cuh"

namespace {

// The three phases on streams of type TS (f32, or bf16; see the top).
template <typename TS>
cudaError_t shared_bwd(const TS* x1, int d1, const TS* x2, int d2, const TS* hp_f,
                       const TS* hp_b, const TS* dy_f, const TS* dy_b, const float* wih_f,
                       const float* bih_f, const float* whh_f, const float* bhh_f,
                       const float* wih_b, const float* bih_b, const float* whh_b,
                       const float* bhh_b, TS* dx1, TS* dx2,
                       float* dwih_f, float* dbih_f, float* dwhh_f, float* dbhh_f,
                       float* dwih_b, float* dbih_b, float* dwhh_b, float* dbhh_b, float* buf_a,
                       float* buf_b, float* gates, float* dyx, float* partial, TS* pair, int T,
                       int B, int H, int pool, int fused, unsigned int seed, unsigned int thresh,
                       float inv_keep, cudaStream_t st) {
  constexpr bool kBF = !std::is_same_v<TS, float>;
  const int M = T * B, H3 = 3 * H;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;

  // 1. gates (and the expanded cotangent; at bf16 the widened one in plain mode too)
  err = launch_gi_gh(x1, d1, x2, d2, hp_f, hp_b, wih_f, bih_f, whh_f, bhh_f, wih_b, bih_b, whh_b,
                     bhh_b, buf_a, buf_b, M, H, 2, st);
  if (err != cudaSuccess) return err;
  bwd_gates_kernel<TS><<<grid_for((size_t)2 * M * H, sms), 256, 0, st>>>(
      buf_a, buf_b, gates, dy_f, dy_b, dyx, T, B, H, pool, fused, seed, thresh, inv_keep, 2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // 2. the serial dh chain on the backward cluster recurrence; dgi and dgh
  // overwrite gi and gh. Time-major (T, B, .) buffers, direction d's d * M
  // rows into each of phase 1's (2, T, B, .) ones; h_prev and the cotangent
  // at each direction's own base: the caller's tensors (h_prev bf16 at bf16),
  // or, widened, the two halves of dyx. The int strides hold: the wrapper
  // bounds 2 M 4H below 2^31.
  const bool widened = fused || kBF;
  ClusterBwdArgs<true, kBF> a = {};
  a.gates = gates;
  a.dgi = buf_a;
  a.dgh = buf_b;
  a.whh[0] = whh_f;
  a.whh[1] = whh_b;
  a.hps[0] = hp_f;
  a.hps[1] = hp_b;
  a.dys[0] = widened ? dyx : reinterpret_cast<const float*>(dy_f);
  a.dys[1] = widened ? dyx + (size_t)M * H : reinterpret_cast<const float*>(dy_b);
  a.gates_dir = M * 4 * H;
  a.dg_dir = M * H3;
  a.gates_b = 4 * H;
  a.gates_t = B * 4 * H;
  a.hp_b = H;
  a.hp_t = B * H;
  a.dy_b = H;
  a.dy_t = B * H;
  a.dg_b = H3;
  a.dg_t = B * H3;
  a.T = T;
  a.B = B;
  a.H = H;
  a.up = 2;  // the forward direction's gradient walks t = T-1..0, the backward's t = 0..T-1
  err = gru_cluster_bwd<kBF, true>(a, 2, st);
  if (err != cudaSuccess) return err;

  // 3. products; at bf16 each direction's dX goes through `pair` first
  if constexpr (kBF) {
    err = launch_dx_bf16(buf_a, wih_f, wih_b, dx1, d1, dx2, d2, pair, M, H3, st);
  } else {
    err = launch_dx(buf_a, wih_f, wih_b, dx1, d1, dx2, d2, M, H3, 2, st);
  }
  if (err != cudaSuccess) return err;
  err = weight_grads(buf_a, H3, x1, x2, x1, x2, d1, d2, partial, dwih_f, dbih_f, dwih_b, dbih_b,
                     M, sms, st);
  if (err != cudaSuccess) return err;
  return weight_grads(buf_b, H3, hp_f, nullptr, hp_b, nullptr, H, 0, partial, dwhh_f, dbhh_f,
                      dwhh_b, dbhh_b, M, sms, st);
}

}  // namespace

extern "C" {

// Floats of the `partial` workspace of tsl_bigru_shared_bwd (ndir = 2; input
// parts of d1 and d2 columns), tsl_bigru_masked_bwd (ndir = 2, d2 = 0) and
// tsl_gru1_bwd (ndir = 1, d2 = 0) at hidden width H over M = T*B rows on the
// current device: dW's row chunks, each with its own slot. -1 on a CUDA
// error.
long long tsl_bigru_shared_bwd_partial_floats(int d1, int d2, int H, int M, int ndir) {
  int sms = 0;
  if (sm_count(&sms) != cudaSuccess) return -1;
  return std::max(dw_partial_floats(3 * H, d1, d2, M, ndir, sms),
                  dw_partial_floats(3 * H, H, 0, M, ndir, sms));
}

// Backward of one bidirectional GRU layer. Parts, weights and layouts as
// tsl_bigru_shared_fwd; hp_f and hp_b (T, B, H) are the h_prev residuals at
// natural t. Plain mode (fused = 0): dy_f and dy_b are full-rate (T, B, H)
// cotangents. Fused mode: they are POOLED (ceil(T/pool), B, H) cotangents of
// K2's output, expanded with its avg pool and its keep mask (seed, thresh,
// inv_keep as tsl_bigru_trainpool_fwd). Outputs: dx1 (T, B, d1), dx2 (T, B,
// d2; null when d2 = 0), and dW_ih (3H, D), db_ih, dW_hh (3H, H), db_hh of
// each direction, all overwritten. Scratch: buf_a and buf_b 2*T*B*3H floats
// each, gates 2*T*B*4H, dyx 2*T*B*H (fused mode only), partial as
// tsl_bigru_shared_bwd_partial_floats(d1, d2, H, T*B, 2). H must be a
// multiple of 4. Returns
// cudaSuccess (0) or the first launch error; does not synchronise.
int tsl_bigru_shared_bwd(
    const float* x1, int d1, const float* x2, int d2,
    const float* hp_f, const float* hp_b, const float* dy_f, const float* dy_b,
    const float* wih_f, const float* bih_f, const float* whh_f, const float* bhh_f,
    const float* wih_b, const float* bih_b, const float* whh_b, const float* bhh_b,
    float* dx1, float* dx2,
    float* dwih_f, float* dbih_f, float* dwhh_f, float* dbhh_f,
    float* dwih_b, float* dbih_b, float* dwhh_b, float* dbhh_b,
    float* buf_a, float* buf_b, float* gates, float* dyx, float* partial,
    int T, int B, int H, int pool, int fused, unsigned int seed, unsigned int thresh,
    float inv_keep, void* stream) {
  return (int)shared_bwd<float>(x1, d1, x2, d2, hp_f, hp_b, dy_f, dy_b, wih_f, bih_f, whh_f, bhh_f,
                                wih_b, bih_b, whh_b, bhh_b, dx1, dx2, dwih_f, dbih_f, dwhh_f,
                                dbhh_f, dwih_b, dbih_b, dwhh_b, dbhh_b, buf_a, buf_b, gates, dyx,
                                partial, nullptr, T, B, H, pool, fused, seed, thresh, inv_keep,
                                (cudaStream_t)stream);
}

// tsl_bigru_shared_bwd on bf16 storage: x1, x2, hp_f, hp_b, dy_f, dy_b, dx1
// and dx2 are bf16; the weights (rounded to bf16 as they are read), the
// biases, the weight and bias gradients and the scratch f32. dyx (2*T*B*H floats) is needed in plain
// mode too: the chain reads the cotangents widened to f32 there; pair
// (2*T*B*(d1 + d2) bf16) holds each direction's dX before their sum.
int tsl_bigru_shared_bwd_bf16(
    const __nv_bfloat16* x1, int d1, const __nv_bfloat16* x2, int d2,
    const __nv_bfloat16* hp_f, const __nv_bfloat16* hp_b, const __nv_bfloat16* dy_f,
    const __nv_bfloat16* dy_b, const float* wih_f, const float* bih_f, const float* whh_f,
    const float* bhh_f, const float* wih_b, const float* bih_b, const float* whh_b,
    const float* bhh_b, __nv_bfloat16* dx1,
    __nv_bfloat16* dx2, float* dwih_f, float* dbih_f, float* dwhh_f, float* dbhh_f,
    float* dwih_b, float* dbih_b, float* dwhh_b, float* dbhh_b, float* buf_a, float* buf_b,
    float* gates, float* dyx, float* partial, __nv_bfloat16* pair, int T, int B, int H,
    int pool, int fused, unsigned int seed, unsigned int thresh, float inv_keep, void* stream) {
  return (int)shared_bwd<__nv_bfloat16>(x1, d1, x2, d2, hp_f, hp_b, dy_f, dy_b, wih_f, bih_f,
                                        whh_f, bhh_f, wih_b, bih_b, whh_b, bhh_b, dx1, dx2, dwih_f,
                                        dbih_f, dwhh_f, dbhh_f, dwih_b, dbih_b, dwhh_b, dbhh_b,
                                        buf_a, buf_b, gates, dyx, partial, pair, T, B, H, pool,
                                        fused, seed, thresh, inv_keep, (cudaStream_t)stream);
}

}  // extern "C"
