// Length-masked GRU layer, BACKWARD: K4b (bidirectional) and K5b
// (unidirectional), for sm_90a.
//
// Replaces the TPU kernel `_fused_bwd_kernel` in tpu_slu/ops/pallas_gru.py:400
// (`pallas_call` at :525), the custom-VJP backward of the joint bi-GRU
// (`_bigru_seq_for` :557-605), which seq2seq training reaches through
// `seq2seq_encode` -> `gru_apply` -> `gru_apply_pallas` -> `_bigru_streams`.
// It is the VJP of K4f (bigru_masked_fwd.cu): a batch-major input x (B, T,
// D) whose row b holds n_b valid frames, the layer's output `out` (B, T, 2H)
// and its cotangent dy (B, T, 2H) -> dX (B, T, D), the sum of both
// directions' contributions, and dW_ih, db_ih, dW_hh, db_hh of each
// direction in torch layout. With every n_b = T it is the VJP of the
// unmasked layer, the one seq2seq training takes.
//
// The TPU kernel takes time-flipped copies of x, h_prev and dy for each
// direction, returns one dX stream per direction, and relies on dy = 0 at
// the padded steps (pallas_gru.py:420-423). Here nothing is flipped: the
// blocks compute their own addresses, as K4f's do. Nor is dy trusted: the
// output past n_b is a constant 0, so a caller's cotangent there is read by
// no step. The work runs in K3's three phases (bigru_shared_bwd.cu), with
// K4f's layout (row m = b*T + t) and per-row lengths:
//   1. Gates (parallel): each direction's h_prev gathered from `out` by
//      index (out[b, t-1, :H] forward, out[b, t+1, H:] backward, zero at the
//      direction's first step, t = 0 and t = n_b - 1); gi and gh for all
//      rows by the GEMM core of bigru_gemm.cuh, one launch; the gate tensor
//      [gh_n r(1-r), z, n, r] (bigru_bwd_common.cuh). The logistic sigmoid,
//      as K4f uses.
//   2. The serial dh chain, on the backward cluster recurrence of
//      gru_cluster_bwd.cuh: a thread-block cluster of C CTAs per (batch
//      tile, direction), each holding its hidden units' columns of W_hh in
//      registers and sending each step's dgh to the others by st.async; a
//      row's chain walks its valid steps only, the forward direction's
//      gradient t = n_b-1..0, the backward direction's t = 0..n_b-1. Each
//      step is dh <- dgh W_hh + dh z and writes dgi and dgh; exact zeros
//      go to both at t >= n_b.
//   3. Products (the GEMM core, K3's): dX = sum_dir dgi W_ih into one
//      tensor; dW_ih = dgi^T x, dW_hh = dgh^T h_prev, db the column sums,
//      over row chunks summed in chunk order. Padded rows
//      hold dgi = dgh = 0, so they add exactly 0 to dW and db, and dX there is
//      exactly 0. No float atomics: repeated runs agree bit for bit.
//
// K5b replaces the TPU kernel `_fused1_bwd_kernel` (pallas_gru.py:189,
// `pallas_call` at :261), the custom-VJP backward of every unidirectional
// GRU layer (`_gru1_seq_for` :617-644). It is the VJP of K5f
// (bigru_masked_fwd.cu, NDIR = 1): the same three phases with one
// direction: x (B, T, D), the forward output (B, T, H) and dy (B, T, H) ->
// dX, dW_ih, db_ih, dW_hh, db_hh; h_prev is out[b, t-1] (0 at t = 0), the
// chain walks t = n_b-1..0. The TPU kernel
// takes time-flipped x, h_prev and dy and carries dh and the dW sums across
// its sequential time blocks; here nothing is flipped and dW is phase 3's
// fixed-order reduction.
//
// What bounds it on this card: at the seq2seq encoder's layer (B = 64,
// T = 25, D = 256, H = 128) ~2.8 GFLOP of f32 products, of which the chain
// holds ~0.3 GFLOP in 2 x 25 serial steps side by side; the rest are the
// gate recompute and the dX/dW products, f32 FMAs on the GEMM core
// (bigru_gemm.cuh). What the design does about it: everything without a
// serial dependence leaves the chain, whose step runs on C SMs with its
// weights in registers, and the dW reduction splits its 1,600 rows into
// enough chunks to give every SM two CTAs.
// f32 operands and accumulation throughout.
//
// At compute_dtype=bfloat16 (`tsl_bigru_masked_bwd_bf16`, the seq2seq
// encoder layer's backward in a bf16 trainer; `tsl_gru1_bwd_bf16`, its
// unidirectional layers') x, out, dy and dX are bf16 and the TPU kernels'
// rounding points are kept (pallas_gru.py:440-495, :206-244): h_prev is
// gathered from the bf16 output and widened, so is dy (phase 1a writes the
// chain's f32 copies, and a bf16 copy of h_prev for the gh product); gi and
// gh read the bf16 x and h_prev against W_ih and W_hh rounded to bf16; the
// chain holds W_hh's columns rounded to bf16 and rounds the dgh it sends for
// the next step's product, its dgi and dgh f32; each direction's dX is
// bf16(dgi) bf16(W_ih) stored as bf16 and their sum rounded again (the TPU
// kernel returns one bf16 dX a direction and XLA adds them); dW_ih = dgi^T x
// and dW_hh = dgh^T h_prev take the f32 dgi and dgh, in the same fixed
// order.

#include "bigru_bwd_common.cuh"
#include "gru_cluster_bwd.cuh"

namespace {

// Row b's valid frames, clamped to [0, T]; every row has T without lengths.
__device__ __forceinline__ int row_len(const long long* __restrict__ lengths, int b, int T) {
  if (lengths == nullptr) return T;
  const long long n = lengths[b];
  return (int)(n < 0 ? 0 : (n > T ? T : n));
}

// Phase 1a: hp[dir][b*T + t] = each direction's h_prev at natural t, read
// from the forward output (B, T, ndir*H) by index.
__global__ void masked_hprev_kernel(const float* __restrict__ out,
                                    const long long* __restrict__ lengths,
                                    float* __restrict__ hp, int T, int B, int H, int ndir) {
  const size_t M = (size_t)B * T;
  const size_t total = (size_t)ndir * M * H;
  const size_t P = (size_t)ndir * H;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int i = (int)(e % H);
    const size_t row = e / H;  // dir * M + m
    const int dir = (int)(row / M);
    const size_t m = row % M;
    const int b = (int)(m / T), t = (int)(m % T);
    float v = 0.0f;
    if (dir == 0) {
      if (t > 0) v = out[(m - 1) * P + i];
    } else if (t + 1 < row_len(lengths, b, T)) {
      v = out[(m + 1) * P + H + i];
    }
    hp[e] = v;
  }
}

// Phase 1a at bf16: masked_hprev_kernel on the bf16 output, each value
// written twice, widened to f32 (hp, the chain's and dW_hh's operand; exact)
// and as it is (hp16, the gh product's operand); and the bf16 cotangent dy
// (B, T, ndir*H) widened to f32 in the chain's layout dyx[dir][b*T + t].
__global__ void masked_hprev_kernel_bf16(const __nv_bfloat16* __restrict__ out,
                                         const __nv_bfloat16* __restrict__ dy,
                                         const long long* __restrict__ lengths,
                                         float* __restrict__ hp, __nv_bfloat16* __restrict__ hp16,
                                         float* __restrict__ dyx, int T, int B, int H, int ndir) {
  const size_t M = (size_t)B * T;
  const size_t total = (size_t)ndir * M * H;
  const size_t P = (size_t)ndir * H;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int i = (int)(e % H);
    const size_t row = e / H;  // dir * M + m
    const int dir = (int)(row / M);
    const size_t m = row % M;
    const int b = (int)(m / T), t = (int)(m % T);
    __nv_bfloat16 v = __float2bfloat16_rn(0.0f);
    if (dir == 0) {
      if (t > 0) v = out[(m - 1) * P + i];
    } else if (t + 1 < row_len(lengths, b, T)) {
      v = out[(m + 1) * P + H + i];
    }
    hp[e] = __bfloat162float(v);
    hp16[e] = v;
    dyx[e] = __bfloat162float(dy[m * P + (size_t)dir * H + i]);
  }
}

// The three phases for NDIR directions; the _b operands are unused at NDIR =
// 1. TS: the streams' type (x, out, dy, dx). At bf16 (see the top) hp16, dyx
// and pair are read: hp16 ndir*B*T*H bf16, dyx ndir*B*T*H f32, pair 2*B*T*D
// bf16 (NDIR = 2); the f32 path takes them null.
template <int NDIR, typename TS = float>
cudaError_t masked_bwd(const TS* x, int D, const long long* lengths, const TS* out,
                       const TS* dy, const float* wih_f, const float* bih_f,
                       const float* whh_f, const float* bhh_f, const float* wih_b,
                       const float* bih_b, const float* whh_b, const float* bhh_b, TS* dx,
                       float* dwih_f, float* dbih_f, float* dwhh_f, float* dbhh_f,
                       float* dwih_b, float* dbih_b, float* dwhh_b, float* dbhh_b, float* hp,
                       float* buf_a, float* buf_b, float* gates, float* partial,
                       same_t<TS>* hp16, float* dyx, same_t<TS>* pair, int T, int B, int H,
                       cudaStream_t st) {
  constexpr bool kBF = !std::is_same_v<TS, float>;
  const int M = B * T, H3 = 3 * H;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;

  // 1. h_prev, gates
  const float* hp_b = hp + (size_t)M * H;
  if constexpr (kBF) {
    masked_hprev_kernel_bf16<<<grid_for((size_t)NDIR * M * H, sms), 256, 0, st>>>(
        out, dy, lengths, hp, hp16, dyx, T, B, H, NDIR);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = launch_gi_gh(x, D, nullptr, 0, hp16, hp16 + (size_t)M * H, wih_f, bih_f, whh_f, bhh_f,
                       wih_b, bih_b, whh_b, bhh_b, buf_a, buf_b, M, H, NDIR, st);
  } else {
    masked_hprev_kernel<<<grid_for((size_t)NDIR * M * H, sms), 256, 0, st>>>(out, lengths, hp, T,
                                                                             B, H, NDIR);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = launch_gi_gh(x, D, nullptr, 0, hp, hp_b, wih_f, bih_f, whh_f, bhh_f, wih_b, bih_b,
                       whh_b, bhh_b, buf_a, buf_b, M, H, NDIR, st);
  }
  if (err != cudaSuccess) return err;
  bwd_gates_kernel<float><<<grid_for((size_t)NDIR * M * H, sms), 256, 0, st>>>(
      buf_a, buf_b, gates, nullptr, nullptr, nullptr, T, B, H, 1, 0, 0u, kKeepAll, 1.0f, NDIR);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // 2. the serial dh chain on the backward cluster recurrence; dgi and dgh
  // overwrite gi and gh. Direction d's rows start d * M rows into each
  // (NDIR, B*T, .) buffer, and at d * H into dy's (B, T, NDIR*H) rows (at
  // bf16, d * M rows into dyx's (NDIR, B*T, H))
  ClusterBwdRec a = {};
  a.gates = gates;
  a.hp = hp;
  a.dgi = buf_a;
  a.dgh = buf_b;
  a.whh[0] = whh_f;
  a.whh[1] = whh_b;
  a.lengths = lengths;
  a.gates_dir = NDIR == 2 ? M * 4 * H : 0;
  a.hp_dir = NDIR == 2 ? M * H : 0;
  a.dg_dir = NDIR == 2 ? M * H3 : 0;
  a.gates_b = T * 4 * H;
  a.gates_t = 4 * H;
  a.hp_b = T * H;
  a.hp_t = H;
  if constexpr (kBF) {
    a.dy = dyx;
    a.dy_dir = NDIR == 2 ? M * H : 0;
    a.dy_b = T * H;
    a.dy_t = H;
  } else {
    a.dy = dy;
    a.dy_dir = H;
    a.dy_b = T * NDIR * H;
    a.dy_t = NDIR * H;
  }
  a.dg_b = T * H3;
  a.dg_t = H3;
  a.T = T;
  a.B = B;
  a.H = H;
  a.up = 2;  // the backward direction's gradient walks t = 0..n_b-1
  err = gru_cluster_bwd<kBF>(a, NDIR, st);
  if (err != cudaSuccess) return err;

  // 3. products; at bf16 each direction's dX is rounded, and their sum again
  if constexpr (kBF) {
    err = launch_dx_bf16(buf_a, wih_f, wih_b, dx, D, nullptr, 0, pair, M, H3, st, NDIR);
  } else {
    err = launch_dx(buf_a, wih_f, wih_b, dx, D, nullptr, 0, M, H3, NDIR, st);
  }
  if (err != cudaSuccess) return err;
  err = weight_grads(buf_a, H3, x, nullptr, x, nullptr, D, 0, partial, dwih_f, dbih_f, dwih_b,
                     dbih_b, M, sms, st, NDIR);
  if (err != cudaSuccess) return err;
  return weight_grads(buf_b, H3, hp, nullptr, hp_b, nullptr, H, 0, partial, dwhh_f, dbhh_f,
                      dwhh_b, dbhh_b, M, sms, st, NDIR);
}

}  // namespace

extern "C" {

// Backward of one length-masked bidirectional GRU layer (K4f's VJP). x (B, T,
// D), out and dy (B, T, 2H) row-major, lengths (B,) int64 (clamped to [0,
// T]); weights as tsl_bigru_masked_fwd. Outputs, all overwritten: dx (B, T,
// D), and dW_ih (3H, D), db_ih, dW_hh (3H, H), db_hh of each direction.
// Scratch: hp 2*B*T*H floats, buf_a and buf_b 2*B*T*3H each, gates
// 2*B*T*4H, partial as tsl_bigru_shared_bwd_partial_floats(D, 0, H, B*T,
// 2). H must be a multiple of 4. Returns cudaSuccess (0) or the first launch error; does
// not synchronise.
int tsl_bigru_masked_bwd(
    const float* x, int D, const long long* lengths, const float* out, const float* dy,
    const float* wih_f, const float* bih_f, const float* whh_f, const float* bhh_f,
    const float* wih_b, const float* bih_b, const float* whh_b, const float* bhh_b,
    float* dx, float* dwih_f, float* dbih_f, float* dwhh_f, float* dbhh_f,
    float* dwih_b, float* dbih_b, float* dwhh_b, float* dbhh_b,
    float* hp, float* buf_a, float* buf_b, float* gates, float* partial,
    int T, int B, int H, void* stream) {
  return (int)masked_bwd<2>(x, D, lengths, out, dy, wih_f, bih_f, whh_f, bhh_f, wih_b, bih_b,
                            whh_b, bhh_b, dx, dwih_f, dbih_f, dwhh_f, dbhh_f, dwih_b, dbih_b,
                            dwhh_b, dbhh_b, hp, buf_a, buf_b, gates, partial, nullptr, nullptr,
                            nullptr, T, B, H, (cudaStream_t)stream);
}

// Backward of one unidirectional GRU layer (K5f's VJP, K5b). x (B, T, D),
// out and dy (B, T, H) row-major, lengths (B,) int64 (clamped to [0, T]) or
// nullptr for T frames in every row; weights as tsl_gru1_fwd. Outputs, all
// overwritten: dx (B, T, D), dW_ih (3H, D), db_ih, dW_hh (3H, H), db_hh.
// Scratch: hp B*T*H floats, buf_a and buf_b B*T*3H each, gates B*T*4H,
// partial as tsl_bigru_shared_bwd_partial_floats(D, 0, H, B*T, 1). H
// must be a multiple of 4. Returns cudaSuccess (0) or the first launch error; does
// not synchronise.
int tsl_gru1_bwd(const float* x, int D, const long long* lengths, const float* out,
                 const float* dy, const float* wih, const float* bih, const float* whh,
                 const float* bhh, float* dx, float* dwih, float* dbih, float* dwhh, float* dbhh,
                 float* hp, float* buf_a, float* buf_b, float* gates, float* partial, int T, int B,
                 int H, void* stream) {
  return (int)masked_bwd<1>(x, D, lengths, out, dy, wih, bih, whh, bhh, nullptr, nullptr,
                            nullptr, nullptr, dx, dwih, dbih, dwhh, dbhh, nullptr, nullptr,
                            nullptr, nullptr, hp, buf_a, buf_b, gates, partial, nullptr, nullptr,
                            nullptr, T, B, H, (cudaStream_t)stream);
}

// tsl_bigru_masked_bwd and tsl_gru1_bwd on bf16 storage (compute_dtype=
// bfloat16): x, out, dy and dx bf16; the weights (rounded to bf16 as they
// are read), the biases, the weight and bias gradients and the rest of the
// scratch f32. Beside the f32 entries' scratch: hp16 (ndir*B*T*H bf16),
// dyx (ndir*B*T*H floats) and, for the two directions, pair (2*B*T*D bf16),
// each direction's rounded dX before their sum is rounded.
int tsl_bigru_masked_bwd_bf16(
    const __nv_bfloat16* x, int D, const long long* lengths, const __nv_bfloat16* out,
    const __nv_bfloat16* dy, const float* wih_f, const float* bih_f, const float* whh_f,
    const float* bhh_f, const float* wih_b, const float* bih_b, const float* whh_b,
    const float* bhh_b, __nv_bfloat16* dx, float* dwih_f, float* dbih_f, float* dwhh_f,
    float* dbhh_f, float* dwih_b, float* dbih_b, float* dwhh_b, float* dbhh_b,
    float* hp, float* buf_a, float* buf_b, float* gates, float* partial,
    __nv_bfloat16* hp16, float* dyx, __nv_bfloat16* pair, int T, int B, int H, void* stream) {
  return (int)masked_bwd<2, __nv_bfloat16>(
      x, D, lengths, out, dy, wih_f, bih_f, whh_f, bhh_f, wih_b, bih_b, whh_b, bhh_b, dx, dwih_f,
      dbih_f, dwhh_f, dbhh_f, dwih_b, dbih_b, dwhh_b, dbhh_b, hp, buf_a, buf_b, gates, partial,
      hp16, dyx, pair, T, B, H, (cudaStream_t)stream);
}

int tsl_gru1_bwd_bf16(const __nv_bfloat16* x, int D, const long long* lengths,
                      const __nv_bfloat16* out, const __nv_bfloat16* dy, const float* wih,
                      const float* bih, const float* whh, const float* bhh, __nv_bfloat16* dx,
                      float* dwih, float* dbih, float* dwhh, float* dbhh, float* hp, float* buf_a,
                      float* buf_b, float* gates, float* partial, __nv_bfloat16* hp16, float* dyx,
                      int T, int B, int H, void* stream) {
  return (int)masked_bwd<1, __nv_bfloat16>(
      x, D, lengths, out, dy, wih, bih, whh, bhh, nullptr, nullptr, nullptr, nullptr, dx, dwih,
      dbih, dwhh, dbhh, nullptr, nullptr, nullptr, nullptr, hp, buf_a, buf_b, gates, partial, hp16,
      dyx, nullptr, T, B, H, (cudaStream_t)stream);
}

}  // extern "C"
