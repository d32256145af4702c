// BiGRU and BiLSTM recurrences, both directions, the time loop inside the
// kernel.
//
// Replaces the Pallas kernels of crnn_ocr_tpu/kernels/bigru.py, whose
// sequential grid over T carried the state in VMEM:
// * bigru_pallas_raw (K2, _kernel) and bigru_pallas_train (K3,
//   _kernel_train: the same recurrence that also writes the gate activations
//   for the analytic backward). Keras GRU with reset_after, gates z|r|h:
//     rec = round(h) . U[d] + b_rec[d]   (round: to the compute type)
//     z = sig(xz + rz), r = sig(xr + rr), hh = tanh(xh + r * rh)
//     h = z * h + (1 - z) * hh           (h carried in f32)
//   K3 stashes (T, 2, B, 4H) f32 = [z | r | hh | rh], rh being the recurrent
//   h-part including its bias, exactly the values the step used.
// * bilstm_pallas_raw (K4, _lstm_kernel) and bilstm_pallas_train (K5,
//   _lstm_kernel_train). Keras LSTM, gates i|f|c|o, its single bias folded
//   into xw by the caller, no recurrent bias:
//     gates = xw + round(h) . U[d]
//     i, f, o = sig(gates), g = tanh(gates)
//     c = f * c + i * g, h = o * tanh(c)  (h and c carried in f32)
//   K5 stashes (T, 2, B, 5H) f32 = [i | f | g | o | c], c the new state.
// xw (T, 2, B, nH) holds the input projections plus the input bias, with
// direction 1 already time-reversed by the caller; hs (T, 2, B, H) is
// written in xw's type, direction 1 still reversed.
//
// The cell is a template policy (GruCell, LstmCell): its gate count, its
// stash, whether it has a recurrent bias and its per-unit step. Three
// designs; kernels/bigru.py::design_for picks one from the shape alone:
//
// * resident (K2-K5 in bf16 and in f32, H <= 256 after padding),
//   birnn_resident_kernel, its operand types and product a policy
//   (ResBf16, ResTf32): U stays in shared memory for all T steps. Each
//   (direction, tile of R batch rows) is a cluster of C CTAs; CTA c owns
//   the units [c H/C, (c+1) H/C) of every gate, at most a tile of kUnits:
//   64 in C <= 4 (every instance but one), or 32 in C <= 8, the portable
//   maximum (the f32 LSTM past 128 padded units). Its U slice (at H = 256,
//   C = 4: 96 KB for the bf16 GRU, 128 KB for the bf16 LSTM; C = 8: 128 KB
//   for the f32 LSTM) is loaded once, rearranged from kernel_weights'
//   operand into K-major core matrices, and the cell step stays in the
//   CTA's registers (h, and c, in f32). Each CTA keeps the whole round(h),
//   R x H, twice (this step's, the next's): after its cell step it writes
//   its units of the new h into every CTA's next buffer with
//   st.shared::cluster, then one cluster barrier (arrive after the writes,
//   wait at the step's end) replaces __syncthreads. The product runs with
//   the operands swapped, gates^T = U_slice^T . round(h)^T: gate q's units
//   are M-tile q, the batch rows N, so the thread that holds (unit, row)
//   of one gate holds it in every gate. The product is mma.sync.m16n8k16,
//   its fragments loaded with ldmatrix from the resident K-major core
//   matrices (wgmma.m64nRk16 on the same layouts measured 13-19 % slower
//   on the H100 at the main-path shapes; PERF.md). M rows are ordered so
//   that a thread's two rows are adjacent units: xw, h, hs and the stash
//   move two units at a time. xw is loaded into registers one step ahead
//   (where that fits in registers; else at the step's start, before the
//   product). R is 8, 16 or 32, the fewest whose grid the card holds in
//   one wave (kernels/bigru.py::design_for, from measured capacities): in
//   bf16 at H = 256, K2 at B = 256 runs 128 CTAs of 16 rows, K3 at B = 128 128
//   CTAs of 8, K4 at B = 256 64 CTAs of 32 (16 rows would take 128 CTAs,
//   two waves of the 120 the card holds) and K5 at B = 128 64 CTAs of 16.
//   Per step and CTA the tensor cores read the U slice from shared memory
//   once (128 KB for the LSTM at H = 256, ~1000 cycles at 128 B a cycle)
//   and the cluster barrier waits for the slowest CTA: the design is bound
//   by this latency per step, not by the bytes of xw and the outputs.
//   In f32 (ResTf32) U's slice and h are f32, 4 k a 16-byte core row, and
//   the product is 3xTF32 on mma.sync.m16n8k8 from the same ldmatrix
//   fragments: every operand split hi + lo as it is loaded, hi.hi + hi.lo
//   + lo.hi (one TF32 product errs by ~5e-4 of the terms' magnitudes,
//   tests/test_torch_rnn_f32.py, and a gate keeps f32's ~1e-7). The f32
//   GRU's slice is 3 x 64 x H x 4 bytes (96 KB at H = 128, 192 KB at
//   H = 256) plus two f32 h buffers of R x H (at H = 256 and R = 16, 32 KB:
//   224 KB of the 227). So R is 8 or 16; at H = 128 the card holds two
//   CTAs an SM (264 in a wave), at H = 256 one (120, in clusters of 4), and
//   K2 at B = 256 runs 128 CTAs of 16 rows in two waves. On the H100 a step
//   takes ~3.1 us at H = 128 on 8 rows whatever the batch: about half of
//   it the product (~20 % of the TF32 peak) and half the h exchange, the
//   barrier and the cell math (a variant without the product, timing only,
//   1.5-1.9 us). FMAs on the CUDA cores from the same layouts measured 10 %
//   slower at H = 128 and 25-40 % at H = 256 (PERF.md).
//   The f32 LSTM's slice on the 64-unit tile would be 4 x 64 x 256 x 4 =
//   256 KB at H = 256: past 128 padded units it takes the 32-unit tile, C
//   = 8 at H = 256 (128 KB), two M-tiles of 16 units. To keep every warp
//   multiplying, K is split over the warps of each M-tile: 2 parts (4
//   warps) at 8 and 32 rows, 4 parts (8 warps) at 16. Each warp forms its
//   K part's 3xTF32 partial for all R rows, then owns a share of the rows
//   (its slots: 8-row tile and row parity); it hands the other slots'
//   partials to their owners through shared memory (f32, 4 gates x 32
//   units x R rows a part), adds those it is handed in K order after one
//   __syncthreads, and does its rows' cell step, exchange and stores. At
//   H = 256: 128 KB slice + 2 x 32 KB h + 16 KB partials at R = 32 (208
//   KB); at R = 16 with 4 parts 128 + 32 + 24. One CTA an SM; the card
//   holds 15 clusters of 8 (120 CTAs), so K5 at B = 128 runs 64 CTAs of 32
//   rows in one wave (~8 us a step) and K4 at B = 256 256 CTAs of 16 rows
//   in three waves (measured faster than 32 rows' two; PERF.md).
// * streamed (bf16 shapes above 4 x 64 units), birnn_mma_kernel: the
//   work is split by (direction, tile of batch rows), never by hidden
//   columns, so no block needs another block's state and the time loop
//   runs inside the block with one __syncthreads per step. A block owns
//   16 batch rows (one m16 tile) and kMmaJT 8-wide tiles of hidden units j
//   per warp, for every gate, so the thread that holds a (row, j)'s gate
//   accumulators also does its gate math and keeps its f32 state (h; and c
//   for the LSTM) in registers across all T steps. round(h) sits in shared
//   memory as the A operand of mma.sync.m16n8k16 (bf16 in, f32
//   accumulate), two buffers that alternate between steps. U does not fit:
//   384 KB (GRU) or 512 KB (LSTM) per direction in bf16 at H = 256, above
//   the 227 KB of shared memory a block may hold. So every step each warp
//   streams its B fragments from global memory (L2) through its own ring of
//   shared-memory stages with cp.async, several k-steps ahead and on across
//   time steps. The wrapper transposes U to [d][n][k] and permutes k within
//   each 16-block, so that a fragment is 256 contiguous bytes and one
//   8-byte shared load per lane. At H = 256 the LSTM's ring (8 warps x 6
//   stages x 4 gates x 4 tiles x 256 B = 192 KB) and the two A buffers
//   (16.5 KB) take 208.5 KB.
// * f32 (f32 shapes above 256 units), birnn_f32_kernel, split as the
//   streamed design: a block has H threads;
//   thread j owns column j of every gate for kBT rows and walks k over H
//   with CUDA-core FMAs, U[d][k][j] read from global memory (L2) every
//   step, h in shared memory as [H][kBT]: ~35 us a step at H = 256.
//
// The GRU's training backward, the reverse recurrence over K3's stash, is
// bigru_bwd_kernel at the end of this file (its own header: the work split,
// shared memory, precision and bound).
//
// K3 and K5 are the kernels instantiated with kStash = true, chosen by a
// non-null gates pointer: the serving instances (kStash = false) compute
// no stash. The stash adds, per (row, unit), four (GRU) or five (LSTM) f32
// stores to the step's epilogue; each lane writes its two adjacent units of
// a gate as one 8-byte store.
//
// Bounds on the H100 per layer (bytes over 3.35 TB/s, operations over the
// bf16 peak; each input read once, each output written once):
// * K2 at the serving path (T=64, B=256, H=256, bf16): 50.3 MB of xw in +
//   16.8 MB of hs out = 67.9 MB -> 20.3 us; 12.9 GFLOP -> 13 us. K3 at the
//   training path (B=128): xw 25.2 MB + hs 8.4 MB + gates 67.1 MB = 100.7 MB
//   -> 30 us; 6.4 GFLOP -> 6.5 us.
// * K4 at the serving path: xw 67.1 MB + U 1.0 MB + hs 16.8 MB = 84.9 MB
//   -> 25.4 us; 17.2 GFLOP -> 17.4 us. K5 at the training path: xw 33.6 MB
//   + U 1.0 MB + hs 8.4 MB + stash 83.9 MB = 126.9 MB -> 37.9 us; 8.6 GFLOP
//   -> 8.7 us.
// * f32 K4 at fonts-hard-lstm's serving path (B=256): 170 MB -> 50.7 us;
//   17.2 GFLOP -> 104 us as 3xTF32. K5 at its training path (B=128): xw
//   67.1 MB + U 2.1 MB + hs 16.8 MB + stash 83.9 MB = 170 MB -> 50.7 us;
//   8.6 GFLOP -> 52.6 us as 3xTF32: both operations-bound.
// * f32 K2 at fonts-small's serving path (T=32, B=256, H=128): xw 25.2 MB
//   + U 0.4 MB + hs 8.4 MB = 34.0 MB -> 10.1 us; 1.64 GFLOP -> 9.9 us as
//   3xTF32 (three TF32 products each, at 495 TFLOP/s), 24.4 us by FMAs on
//   the CUDA cores (67 TFLOP/s). K3 at its training path (B=128): xw 12.6
//   MB + U 0.4 MB + hs 4.2 MB + gates 16.8 MB = 34.0 MB -> 10.1 us.
// All others are bytes-bound, the stash above all, plus T dependent steps.
// In the streamed design each block re-reads its direction's U from L2
// every step, which bounds it near 3.4 us (GRU) and 4.5 us (LSTM) per
// step; the resident design reads U from global memory once, and its step
// is bound by the shared-memory read of the U slice (~0.6 us for the
// LSTM at H = 256), the cell math of 2 x R / 4 (unit, row) pairs per
// thread and one cluster barrier.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int kBT = 8;     // f32 kernel: batch rows per block
constexpr int kMmaRows = 16;  // bf16 kernel: batch rows per block (m16)
constexpr int kMmaJT = 4;     // bf16 kernel: 8-wide tiles of j per warp

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// Keras GRU, reset_after: a[] is round(h) . U[d] plus the recurrent bias per
// gate; h carried in f32, no c. The stash is [z | r | hh | rh].
struct GruCell {
  static constexpr int kGates = 3;
  static constexpr int kStash = 4;
  static constexpr bool kRecBias = true;
  __device__ __forceinline__ static void step(float& h, float& /*c*/,
                                              const float (&x)[kGates],
                                              const float (&a)[kGates],
                                              float (&st)[kStash]) {
    const float z = sigmoid(x[0] + a[0]);
    const float r = sigmoid(x[1] + a[1]);
    const float hh = tanhf(x[2] + r * a[2]);
    h = z * h + (1.f - z) * hh;
    st[0] = z;
    st[1] = r;
    st[2] = hh;
    st[3] = a[2];
  }
};

// Keras LSTM, gates i|f|c|o (g the cell candidate): a[] is round(h) . U[d],
// the bias already in x[]; h and c carried in f32. The stash is
// [i | f | g | o | c].
struct LstmCell {
  static constexpr int kGates = 4;
  static constexpr int kStash = 5;
  static constexpr bool kRecBias = false;
  __device__ __forceinline__ static void step(float& h, float& c,
                                              const float (&x)[kGates],
                                              const float (&a)[kGates],
                                              float (&st)[kStash]) {
    const float i = sigmoid(x[0] + a[0]);
    const float f = sigmoid(x[1] + a[1]);
    const float g = tanhf(x[2] + a[2]);
    const float o = sigmoid(x[3] + a[3]);
    c = f * c + i * g;
    h = o * tanhf(c);
    st[0] = i;
    st[1] = f;
    st[2] = g;
    st[3] = o;
    st[4] = c;
  }
};

// gates: (T, 2, B, kStash * H) f32, written only when kStash.
template <class Cell, bool kStash>
__global__ void __launch_bounds__(1024)
birnn_f32_kernel(const float* __restrict__ xw, const float* __restrict__ U,
                 const float* __restrict__ brec, float* __restrict__ hs,
                 float* __restrict__ gates, int steps, int B, int H) {
  constexpr int NG = Cell::kGates;
  extern __shared__ float4 smem4[];  // 2 buffers of [H][kBT] floats
  float* smem = reinterpret_cast<float*>(smem4);
  const int j = threadIdx.x;
  const int d = blockIdx.y;
  const int b0 = blockIdx.x * kBT;
  const int G = NG * H;
  const float* Ud = U + (size_t)d * H * G;
  float bias[NG];
  if constexpr (Cell::kRecBias) {
#pragma unroll
    for (int q = 0; q < NG; ++q) bias[q] = brec[d * G + q * H + j];
  }

  float h[kBT], c[kBT];
#pragma unroll
  for (int i = 0; i < kBT; ++i) {
    h[i] = c[i] = 0.f;
    smem[j * kBT + i] = 0.f;
  }
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    const float* hin = smem + (t & 1) * H * kBT;
    float* hout = smem + ((t + 1) & 1) * H * kBT;
    float acc[NG][kBT];
#pragma unroll
    for (int q = 0; q < NG; ++q)
#pragma unroll
      for (int i = 0; i < kBT; ++i) acc[q][i] = 0.f;
    const float* u = Ud + j;
#pragma unroll 4
    for (int k = 0; k < H; ++k) {
      float uq[NG];
#pragma unroll
      for (int q = 0; q < NG; ++q) uq[q] = u[q * H];
      u += G;
      const float4* hk = reinterpret_cast<const float4*>(hin + k * kBT);
      float hv[kBT];
#pragma unroll
      for (int p = 0; p < kBT / 4; ++p) {
        const float4 v = hk[p];
        hv[4 * p] = v.x;
        hv[4 * p + 1] = v.y;
        hv[4 * p + 2] = v.z;
        hv[4 * p + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < kBT; ++i)
#pragma unroll
        for (int q = 0; q < NG; ++q) acc[q][i] = fmaf(hv[i], uq[q], acc[q][i]);
    }
#pragma unroll
    for (int i = 0; i < kBT; ++i) {
      const int b = b0 + i;
      const size_t row = ((size_t)t * 2 + d) * B + b;
      float x[NG], a[NG], st[Cell::kStash];
#pragma unroll
      for (int q = 0; q < NG; ++q) {
        x[q] = b < B ? xw[row * G + q * H + j] : 0.f;
        a[q] = acc[q][i];
        if constexpr (Cell::kRecBias) a[q] += bias[q];
      }
      Cell::step(h[i], c[i], x, a, st);
      hout[j * kBT + i] = h[i];
      if (b < B) {
        hs[row * H + j] = h[i];
        if (kStash) {
          float* gt = gates + row * Cell::kStash * H + j;
#pragma unroll
          for (int q = 0; q < Cell::kStash; ++q) gt[q * H] = st[q];
        }
      }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// xw (T, 2, B, nH), hs (T, 2, B, H) bf16; ut (2, nH, H) bf16 is U[d]
// transposed ([n][k]) with k permuted inside each 16-block to
// (0,1,8,9, 2,3,10,11, 4,5,12,13, 6,7,14,15). H % 16 == 0.
// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4):
//   A a0: (row g, k 2t..2t+1)  a1: (g+8, 2t..)  a2: (g, 2t+8..)  a3: (g+8, 2t+8..)
//   B b0: (k 2t..2t+1, col g)  b1: (k 2t+8..2t+9, col g)
//   C c0,c1: (row g, cols 2t, 2t+1)  c2,c3: (row g+8, cols 2t, 2t+1)
// Each warp streams its own B fragments through a ring of kStages
// shared-memory stages with cp.async, kStages - 1 k-steps ahead; the ring
// runs on across time steps, since U does not change.
// gates: (T, 2, B, kStash * H) f32, written only when kStash.
template <class Cell, int kMaxThreads, int kStages, bool kStash>
__global__ void __launch_bounds__(kMaxThreads)
birnn_mma_kernel(const __nv_bfloat16* __restrict__ xw,
                 const __nv_bfloat16* __restrict__ ut,
                 const float* __restrict__ brec,
                 __nv_bfloat16* __restrict__ hs, float* __restrict__ gates,
                 int steps, int B, int H) {
  constexpr int NG = Cell::kGates;
  // bytes of one k-step's B fragments of one warp: kMmaJT tiles x NG gates
  // x (8 columns n x 16 k x 2 bytes)
  constexpr int kStageBytes = kMmaJT * NG * 256;
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* hA = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  const int lda = H + 8;  // padded row: the 8 rows of a fragment hit
                          // 8 different bank groups
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int d = blockIdx.y, b0 = blockIdx.x * kMmaRows;
  const int G = NG * H;
  const int ntiles = H / 8;
  const __nv_bfloat16* utd = ut + (size_t)d * G * H;

  unsigned char* ring = reinterpret_cast<unsigned char*>(
      hA + 2 * kMmaRows * lda) + warp * kStages * kStageBytes;
  const int nk = H / 16;
  const int total = steps * nk;  // k-steps over the whole sequence
  int issue_q = 0, issue_kt = 0, issue_stage = 0;
  // queue the B fragments of the next k-step (one commit group per k-step,
  // empty past the end, so the group count stays uniform)
  auto issue = [&]() {
    if (issue_q < total) {
      unsigned char* st = ring + issue_stage * kStageBytes;
#pragma unroll
      for (int i = 0; i < kStageBytes / 16 / 32; ++i) {
        const int c = i * 32 + lane;
        const int f = c >> 4;        // fragment: tile slot * NG + gate
        const int r = (c >> 1) & 7;  // column n within the fragment
        const int half = c & 1;      // which 16 bytes of its 32
        const int tile = warp * kMmaJT + f / NG;
        if (tile < ntiles)
          cp_async16(st + f * 256 + r * 32 + half * 16,
                     utd + (size_t)((f % NG) * H + tile * 8 + r) * H +
                         issue_kt * 16 + half * 8);
      }
    }
    cp_async_commit();
    ++issue_q;
    if (++issue_kt == nk) issue_kt = 0;
    if (++issue_stage == kStages) issue_stage = 0;
  };
  for (int i = 0; i < kStages - 1; ++i) issue();
  int stage = 0;

  for (int i = threadIdx.x; i < 2 * kMmaRows * lda; i += blockDim.x)
    hA[i] = __float2bfloat16(0.f);
  float h[kMmaJT][4], cs[kMmaJT][4];
  float bias[kMmaJT][NG][2];
#pragma unroll
  for (int s = 0; s < kMmaJT; ++s) {
    const int j = (warp * kMmaJT + s) * 8 + 2 * t4;
    const bool on = warp * kMmaJT + s < ntiles;
#pragma unroll
    for (int e = 0; e < 4; ++e) h[s][e] = cs[s][e] = 0.f;
    if constexpr (Cell::kRecBias) {
#pragma unroll
      for (int q = 0; q < NG; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          bias[s][q][e] = on ? brec[d * G + q * H + j + e] : 0.f;
    }
  }
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    const __nv_bfloat16* A = hA + (t & 1) * kMmaRows * lda;
    __nv_bfloat16* An = hA + ((t + 1) & 1) * kMmaRows * lda;
    // this step's projections, fetched before the products to hide latency
    uint32_t xv[kMmaJT][NG][2];
#pragma unroll
    for (int s = 0; s < kMmaJT; ++s) {
      const int j = (warp * kMmaJT + s) * 8 + 2 * t4;
      const bool on = warp * kMmaJT + s < ntiles;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int b = b0 + g + 8 * r;
        const __nv_bfloat16* x = xw + (((size_t)t * 2 + d) * B + b) * G + j;
#pragma unroll
        for (int q = 0; q < NG; ++q)
          xv[s][q][r] = (on && b < B)
              ? __ldg(reinterpret_cast<const unsigned int*>(x + q * H))
              : 0u;
      }
    }
    float acc[kMmaJT][NG][4];
#pragma unroll
    for (int s = 0; s < kMmaJT; ++s)
#pragma unroll
      for (int q = 0; q < NG; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[s][q][e] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      __syncwarp();  // every lane is done with the stage issue() refills
      issue();
      cp_async_wait<kStages - 1>();  // this k-step's group has landed ...
      __syncwarp();                  // ... for every lane of the warp
      const unsigned char* st = ring + stage * kStageBytes;
      if (++stage == kStages) stage = 0;
      uint32_t a[4];
      const __nv_bfloat16* ap = A + g * lda + kt * 16 + 2 * t4;
      a[0] = *reinterpret_cast<const uint32_t*>(ap);
      a[1] = *reinterpret_cast<const uint32_t*>(ap + 8 * lda);
      a[2] = *reinterpret_cast<const uint32_t*>(ap + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(ap + 8 * lda + 8);
#pragma unroll
      for (int s = 0; s < kMmaJT; ++s) {
        if (warp * kMmaJT + s >= ntiles) continue;  // warp-uniform
#pragma unroll
        for (int q = 0; q < NG; ++q) {
          const uint2 bv = *reinterpret_cast<const uint2*>(
              st + (s * NG + q) * 256 + g * 32 + t4 * 8);
          mma_bf16_16816(acc[s][q], a, bv.x, bv.y);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kMmaJT; ++s) {
      if (warp * kMmaJT + s >= ntiles) continue;
      const int j = (warp * kMmaJT + s) * 8 + 2 * t4;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = g + 8 * r;
        const int b = b0 + row;
        float hn[2], st[2][Cell::kStash];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 2 * r + e;
          float x[NG], a[NG];
#pragma unroll
          for (int q = 0; q < NG; ++q) {
            x[q] = e ? bf16_hi(xv[s][q][r]) : bf16_lo(xv[s][q][r]);
            a[q] = acc[s][q][c];
            if constexpr (Cell::kRecBias) a[q] += bias[s][q][e];
          }
          Cell::step(h[s][c], cs[s][c], x, a, st[e]);
          hn[e] = h[s][c];
        }
        const uint32_t packed = pack_bf16(hn[0], hn[1]);
        *reinterpret_cast<uint32_t*>(An + row * lda + j) = packed;
        if (b < B) {
          const size_t rowi = ((size_t)t * 2 + d) * B + b;
          *reinterpret_cast<uint32_t*>(hs + rowi * H + j) = packed;
          if (kStash) {
            float2* gt = reinterpret_cast<float2*>(
                gates + rowi * Cell::kStash * H + j);
            const int w2 = H / 2;  // one stash slice's width in float2
#pragma unroll
            for (int q = 0; q < Cell::kStash; ++q)
              gt[q * w2] = make_float2(st[0][q], st[1][q]);
          }
        }
      }
    }
    __syncthreads();
  }
}

// ---- the resident design (K2-K5): U in a cluster's shared memory ----

// An instance's tile: the units of each gate a CTA owns at most (units,
// one M-tile of 16 rows per 16) and the warps that split K for each M-tile.
// 64 units on 4 warps (every bf16 instance, the f32 GRU, the f32 LSTM up to
// 128 padded units); 32 units (the f32 LSTM past 128, whose 64-unit f32
// slice would not fit) on 2 M-tiles x 4 K parts at 16 rows and x 2 K halves
// at 8 and 32 (8 rows have too few row slots for 4 parts, and at 32 the 3
// partials' buffer would not fit: PERF.md).
__host__ __device__ constexpr int res_split(int units, int R) {
  return units == 64 ? 1 : R == 16 ? 4 : 2;
}
__host__ __device__ constexpr int res_threads(int units, int R) {
  return 32 * (units / 16) * res_split(units, R);
}
// the most CTAs a cluster: 8 is the portable maximum
__host__ __device__ constexpr int res_max_cluster(int units) {
  return units == 64 ? 4 : 8;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
// barrier.cluster's arrive releases and its wait acquires by default
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
// the address of the same shared-memory offset in the cluster's CTA `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_cluster(uint32_t addr, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(addr), "r"(v)
               : "memory");
}
__device__ __forceinline__ void st_cluster(uint32_t addr, float2 v) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr),
               "f"(v.x), "f"(v.y)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3,
                                        uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1,
                                        uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}
__device__ __forceinline__ void mma16816(float* c, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma1688(float* c, const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x = hi + lo exactly: hi is x with its low 13 mantissa bits cleared (a
// TF32 value), lo = x - hi, |lo| < 2^-10 |x|. The tensor cores read a TF32
// operand's top 19 bits, so lo enters a product as its own truncation (the
// split of csrc/fused_stem.cu's K8 and K10).
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = x & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(__uint_as_float(x), __uint_as_float(hi)));
}

// The unit of the CTA's slice that row m of a gate's M-tile holds: the
// accumulator rows m and m + 8 of one thread (m = 16 warp + lane / 4) are
// the adjacent units 16 warp + 2 (lane / 4) and the next, so that a thread
// loads xw and stores h, hs and the stash two units at a time.
__device__ __forceinline__ int res_unit(int m) {
  return 16 * (m >> 4) + 2 * (m & 7) + ((m >> 3) & 1);
}

// B's fragments (round(h)^T, NJ 8-row tiles of batch rows) of one k-step
// from the lane's ldmatrix row address: matrix mi of an x4 is (tile mi / 2
// of a pair, k half mi % 2); one x2 when NJ = 1.
template <int NJ>
__device__ __forceinline__ void load_b(uint32_t (&b)[NJ][2], uint32_t addr,
                                       int kc) {
  if constexpr (NJ == 1) {
    ldsm_x2(b[0][0], b[0][1], addr);
  } else {
#pragma unroll
    for (int p = 0; p < NJ / 2; ++p)  // tiles 2p and 2p + 1
      ldsm_x4(b[2 * p][0], b[2 * p][1], b[2 * p + 1][0], b[2 * p + 1][1],
              addr + 2 * p * kc * 128);
  }
}

// The resident design's operand types and products. Shared memory holds U's
// slice (NG M-tiles of kUnits rows x H) and round(h) (R rows x H, twice) as
// K-major core matrices of 8 rows x 16 bytes: (row, k) at ((row / 8) kc +
// k / E) 128 + (row % 8) 16 + (k % E) sizeof(T), E = 16 / sizeof(T)
// elements a core row and kc = H / E. A thread moves its two adjacent units
// of xw, h and hs as one Pair. The products fill acc[q][4 jn + v] with
// (M row 16 mt + lane / 4 + 8 (v / 2), batch row 8 jn + 2 (lane % 4) +
// v % 2) of gates^T = U_slice^T . round(h)^T over the k-steps [kk0, kk1)
// (kK k a step): gate q's units are M-tile q, the batch rows N, so the
// thread that holds (unit, row) of one gate holds it in every gate.

// bf16 (K2-K5): mma.sync.m16n8k16, its fragments loaded with ldmatrix.
struct ResBf16 {
  using T = __nv_bfloat16;
  using Pair = uint32_t;
  static constexpr int kK = 16;
  __device__ static float first(Pair p) { return bf16_lo(p); }
  __device__ static float second(Pair p) { return bf16_hi(p); }
  __device__ static Pair pack(float a, float b) { return pack_bf16(a, b); }
  __device__ static Pair load(const T* p) {
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  }
  __device__ static void store(T* p, Pair v) {
    *reinterpret_cast<uint32_t*>(p) = v;
  }

  // U's slice, once, from ut (birnn_mma_kernel's operand): 32 bytes of ut
  // (one 16-block of k, permuted) become the two core-matrix rows of k 0-7
  // and 8-15; rows past upc stay 0
  template <int NG, int kUnits, int kThreads>
  __device__ static void load_u(unsigned char* sA, const T* utd, int H,
                                int rank, int upc, int tid) {
    const int nk = H / 16, kc = H / 8;
    const uint32_t tile_bytes = (uint32_t)kUnits * H * 2;
#pragma unroll 4
    for (int i = tid; i < NG * kUnits * nk; i += kThreads) {
      const int kb = i % nk, m = (i / nk) % kUnits, q = i / (nk * kUnits);
      const int jl = res_unit(m);
      uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
      if (jl < upc) {
        const uint4* src = reinterpret_cast<const uint4*>(
            utd + (size_t)(q * H + rank * upc + jl) * H + kb * 16);
        const uint4 v0 = __ldg(src), v1 = __ldg(src + 1);
        lo = make_uint4(v0.x, v0.z, v1.x, v1.z);
        hi = make_uint4(v0.y, v0.w, v1.y, v1.w);
      }
      unsigned char* dst =
          sA + q * tile_bytes + ((m >> 3) * kc + 2 * kb) * 128 + (m & 7) * 16;
      *reinterpret_cast<uint4*>(dst) = lo;
      *reinterpret_cast<uint4*>(dst + 128) = hi;
    }
  }

  // M-tile mt takes M rows 16mt..16mt+15 of every gate tile; matrix mi of
  // A's ldmatrix is (rows + 8 if mi & 1, k half mi >> 1) of the tile's rows
  template <int R, int NG, int kUnits>
  __device__ static void product(float (&acc)[NG][R / 2],
                                 const unsigned char* sA,
                                 const unsigned char* sH, int H, int mt,
                                 int lane, int kk0, int kk1) {
    constexpr int NJ = R / 8;
    const int kc = H / 8;
    const uint32_t tile_bytes = (uint32_t)kUnits * H * 2;
    const int mi = lane >> 3, r8 = lane & 7;  // this lane's ldmatrix row
    const uint32_t a_lane = smem_addr(sA) +
        ((2 * mt + (mi & 1)) * kc + (mi >> 1)) * 128 + r8 * 16;
    const uint32_t b_lane =
        smem_addr(sH) + (((mi >> 1) % NJ) * kc + (mi & 1)) * 128 + r8 * 16;
    for (int kk = kk0; kk < kk1; ++kk) {
      uint32_t b[NJ][2];
      load_b<NJ>(b, b_lane + kk * 256, kc);
#pragma unroll
      for (int q = 0; q < NG; ++q) {
        uint32_t a[4];
        ldsm_x4(a[0], a[1], a[2], a[3], a_lane + q * tile_bytes + kk * 256);
#pragma unroll
        for (int jn = 0; jn < NJ; ++jn)
          mma16816(&acc[q][4 * jn], a, b[jn][0], b[jn][1]);
      }
    }
  }
};

// f32 (K2, K3): U and h in f32, U read from kernel_weights' (2, NG H, H)
// f32 operand, U[d] transposed ([n][k]), 16 bytes (4 k) a core row. The
// product runs on mma.sync.m16n8k8 in TF32 on the same ldmatrix fragments
// as bf16's (a 16-byte core row is 4 f32, so lane (g, t)'s 32-bit word of
// matrix row g is element (g, t) of a TF32 fragment), every operand split
// hi + lo as it is loaded (split_tf32) and three products a k-step: hi.hi
// into acc, lo.hi + hi.lo into a second accumulator (shorter dependent
// chains), added at the end. The dropped lo.lo and the truncation of lo
// leave less than 3 x 2^-20 of |u h| a term (tests/test_torch_rnn_f32.py
// models the split).
struct ResTf32 {
  using T = float;
  using Pair = float2;
  static constexpr int kK = 8;
  __device__ static float first(Pair p) { return p.x; }
  __device__ static float second(Pair p) { return p.y; }
  __device__ static Pair pack(float a, float b) { return make_float2(a, b); }
  __device__ static Pair load(const T* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
  }
  __device__ static void store(T* p, Pair v) {
    *reinterpret_cast<float2*>(p) = v;
  }

  template <int NG, int kUnits, int kThreads>
  __device__ static void load_u(unsigned char* sA, const T* utd, int H,
                                int rank, int upc, int tid) {
    const int kc = H / 4;
    const uint32_t tile_bytes = (uint32_t)kUnits * H * 4;
#pragma unroll 4
    for (int i = tid; i < NG * kUnits * kc; i += kThreads) {
      const int kb = i % kc, m = (i / kc) % kUnits, q = i / (kc * kUnits);
      const int jl = res_unit(m);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (jl < upc)
        v = __ldg(reinterpret_cast<const float4*>(
            utd + (size_t)(q * H + rank * upc + jl) * H + kb * 4));
      *reinterpret_cast<float4*>(sA + q * tile_bytes +
                                 ((m >> 3) * kc + kb) * 128 + (m & 7) * 16) =
          v;
    }
  }

  template <int R, int NG, int kUnits>
  __device__ static void product(float (&acc)[NG][R / 2],
                                 const unsigned char* sA,
                                 const unsigned char* sH, int H, int mt,
                                 int lane, int kk0, int kk1) {
    constexpr int NJ = R / 8;
    const int kc = H / 4;
    const uint32_t tile_bytes = (uint32_t)kUnits * H * 4;
    const int mi = lane >> 3, r8 = lane & 7;
    const uint32_t a_lane = smem_addr(sA) +
        ((2 * mt + (mi & 1)) * kc + (mi >> 1)) * 128 + r8 * 16;
    const uint32_t b_lane =
        smem_addr(sH) + (((mi >> 1) % NJ) * kc + (mi & 1)) * 128 + r8 * 16;
    float cross[NG][R / 2];  // the lo.hi and hi.lo products
#pragma unroll
    for (int q = 0; q < NG; ++q)
#pragma unroll
      for (int v = 0; v < R / 2; ++v) cross[q][v] = 0.f;
#pragma unroll 2
    for (int kk = kk0; kk < kk1; ++kk) {
      uint32_t b[NJ][2], bh[NJ][2], bl[NJ][2];
      load_b<NJ>(b, b_lane + kk * 256, kc);
#pragma unroll
      for (int jn = 0; jn < NJ; ++jn)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          split_tf32(b[jn][i], bh[jn][i], bl[jn][i]);
#pragma unroll
      for (int q = 0; q < NG; ++q) {
        uint32_t a[4], ah[4], al[4];
        ldsm_x4(a[0], a[1], a[2], a[3], a_lane + q * tile_bytes + kk * 256);
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
#pragma unroll
        for (int jn = 0; jn < NJ; ++jn) {
          mma1688(&cross[q][4 * jn], al, bh[jn]);
          mma1688(&cross[q][4 * jn], ah, bl[jn]);
          mma1688(&acc[q][4 * jn], ah, bh[jn]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < NG; ++q)
#pragma unroll
      for (int v = 0; v < R / 2; ++v) acc[q][v] += cross[q][v];
  }
};

// Call f(std::integral_constant<int, p>) for the runtime p in [0, N): code
// that indexes registers by a warp's K part, with the part a constant.
template <int N, class F>
__device__ __forceinline__ void with_part(int p, F&& f) {
  if constexpr (N == 1) {
    f(std::integral_constant<int, 0>{});
  } else {
    if (p == N - 1)
      f(std::integral_constant<int, N - 1>{});
    else
      with_part<N - 1>(p, f);
  }
}

// xw (T, 2, B, NG H), hs (T, 2, B, H) in Ops::T; ut (2, NG H, H) as Ops
// reads it; gates (T, 2, B, kStash H) f32 when kStash. Grid (C x tiles of R
// rows, 2 directions), clusters of C CTAs along x; CTA `rank` owns the units
// [rank upc, (rank + 1) upc) of every gate. Shared memory: U's slice as NG
// M-tiles of kUnits rows x H, then two h buffers of R rows x H, in Ops'
// layout, then (K split over kSplit warps) the partial products each K
// part hands to the others. Warp w multiplies M-tile w % kTiles over the
// k-steps of its K part p = w / kTiles, for all R rows; then it owns the
// rows of its slots [p kSlots, (p + 1) kSlots) (slot s: the rows 8 (s / 2)
// + 2 (lane % 4) + s % 2 of its lanes): it hands the other slots' partials
// to their owners, adds the ones it is handed in K order, and does those
// rows' cell step, h exchange and stores.
template <class Cell, int R, bool kStash, class Ops, int kUnits>
__global__ void __launch_bounds__(res_threads(kUnits, R), 1)
birnn_resident_kernel(const typename Ops::T* __restrict__ xw,
                      const typename Ops::T* __restrict__ ut,
                      const float* __restrict__ brec,
                      typename Ops::T* __restrict__ hs,
                      float* __restrict__ gates, int steps, int B, int H,
                      int upc) {
  using T = typename Ops::T;
  using Pair = typename Ops::Pair;
  constexpr int NG = Cell::kGates;
  constexpr int NJ = R / 8;  // 8-row tiles of the batch (mma N = 8)
  constexpr int E = 16 / (int)sizeof(T);  // elements a core-matrix row
  constexpr int kTiles = kUnits / 16, kSplit = res_split(kUnits, R);
  constexpr int kThreads = res_threads(kUnits, R);
  constexpr int kPeers = res_max_cluster(kUnits);
  constexpr int kSlots = 2 * NJ / kSplit;  // row slots a thread owns
  static_assert(kSlots * kSplit == 2 * NJ, "the rows split over the K parts");
  // xw a whole step ahead in registers while one step's takes at most 32 of
  // them and the accumulators (f32: and the cross products) at most 64
  constexpr bool kAhead = kSlots * NG * sizeof(Pair) <= 128 &&
                          NG * R / 2 * (sizeof(T) == 4 ? 2 : 1) <= 64;
  extern __shared__ __align__(128) unsigned char res_smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // M-tile, K part (with no K split, warp and 0: the addresses fold)
  const int mt = kSplit == 1 ? warp : warp % kTiles;
  const int kp = kSplit == 1 ? 0 : warp / kTiles;
  const uint32_t rank = cluster_rank(), csize = cluster_size();
  const int d = blockIdx.y, b0 = (blockIdx.x / csize) * R;
  const int G = NG * H, kc = H / E;
  const uint32_t hbuf_bytes = (uint32_t)R * H * sizeof(T);
  unsigned char* sA = res_smem;
  unsigned char* sH = res_smem + (size_t)NG * kUnits * H * sizeof(T);
  // the partials handed over: [writer][slot][q][i][M-tile][lane], f32,
  // writer w < kSplit - 1 the slot's K parts but its owner, in order
  float* red = reinterpret_cast<float*>(sH + 2 * hbuf_bytes) + mt * 32 + lane;
  auto red_at = [](int w, int slot, int q, int i) {
    return (((w * 2 * NJ + slot) * NG + q) * 2 + i) * kTiles * 32;
  };
  const int nk = H / Ops::kK;
  const int kk0 = kSplit == 1 ? 0 : kp * nk / kSplit;
  const int kk1 = kSplit == 1 ? nk : (kp + 1) * nk / kSplit;

  Ops::template load_u<NG, kUnits, kThreads>(sA, ut + (size_t)d * G * H, H,
                                             rank, upc, tid);
  for (int i = tid; i < (int)(hbuf_bytes / 16); i += kThreads)
    reinterpret_cast<uint4*>(sH)[i] = make_uint4(0, 0, 0, 0);  // h = 0

  // this thread's units u0 and u0 + 1 of the slice (j, j + 1 of the layer)
  // and, in its slots, rows 8 (slot / 2) + 2 t4 + slot % 2 of the tile
  const int u0 = 16 * mt + 2 * g;
  const bool on = u0 < upc;
  const int j = rank * upc + u0;
  auto row_of = [&](int s) {
    const int slot = kp * kSlots + s;
    return 8 * (slot >> 1) + 2 * t4 + (slot & 1);
  };
  float bias[NG][2];
#pragma unroll
  for (int q = 0; q < NG; ++q)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      bias[q][i] = Cell::kRecBias && on ? brec[d * G + q * H + j + i] : 0.f;
  uint32_t peer[kPeers];  // the h buffers' base in each CTA of the cluster
#pragma unroll
  for (int r = 0; r < kPeers; ++r)
    peer[r] = r < (int)csize ? map_rank(smem_addr(sH), r) : 0u;
  // + the row's offset
  const uint32_t h_at = (j / E) * 128 + (j % E) * (uint32_t)sizeof(T);

  auto load_x = [&](int t, Pair (&x)[kSlots][NG]) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int b = b0 + row_of(s);
      const T* p = xw + (((size_t)t * 2 + d) * B + b) * G + j;
#pragma unroll
      for (int q = 0; q < NG; ++q)
        x[s][q] = on && b < B ? Ops::load(p + q * H) : Pair{};
    }
  };

  float h[kSlots][2], c[kSlots][2];  // [slot][i]: unit u0 + i
#pragma unroll
  for (int s = 0; s < kSlots; ++s)
#pragma unroll
    for (int i = 0; i < 2; ++i) h[s][i] = c[s][i] = 0.f;
  // xw one step ahead, in registers: each step's loads are issued a whole
  // step before its cell math reads them (else at the step's start, before
  // the product)
  Pair xc[kSlots][NG], xn[kSlots][NG];
  if (kAhead && steps > 0) load_x(0, xc);
  cluster_arrive();  // every CTA runs, its U slice and h = 0 in place
  cluster_wait();

  for (int t = 0; t < steps; ++t) {
    const uint32_t cur = (t & 1) * hbuf_bytes, nxt = ((t + 1) & 1) * hbuf_bytes;
    if (!kAhead)
      load_x(t, xc);
    else if (t + 1 < steps)
      load_x(t + 1, xn);
    float acc[NG][R / 2];
#pragma unroll
    for (int q = 0; q < NG; ++q)
#pragma unroll
      for (int v = 0; v < R / 2; ++v) acc[q][v] = 0.f;
    Ops::template product<R, NG, kUnits>(acc, sA, sH + cur, H, mt, lane, kk0,
                                         kk1);

    // the full products of the thread's slots, tot[slot][i][q]: with a K
    // split, the other slots' partials go to their owners first
    float tot[kSlots][2][NG];
    if constexpr (kSplit > 1) {
      with_part<kSplit>(kp, [&](auto part) {
        constexpr int p = decltype(part)::value;
#pragma unroll
        for (int slot = 0; slot < 2 * NJ; ++slot) {
          const int owner = slot / kSlots;
          if (owner == p) continue;
#pragma unroll
          for (int q = 0; q < NG; ++q)
#pragma unroll
            for (int i = 0; i < 2; ++i)
              red[red_at(p < owner ? p : p - 1, slot, q, i)] =
                  acc[q][4 * (slot >> 1) + 2 * i + (slot & 1)];
        }
      });
      __syncthreads();
    }
    with_part<kSplit>(kp, [&](auto part) {
      constexpr int p = decltype(part)::value;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int slot = p * kSlots + s;
#pragma unroll
        for (int q = 0; q < NG; ++q)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float v = 0.f;
#pragma unroll
            for (int k = 0; k < kSplit; ++k) {  // K order
              const float a = k == p
                  ? acc[q][4 * (slot >> 1) + 2 * i + (slot & 1)]
                  : red[red_at(k < p ? k : k - 1, slot, q, i)];
              v = k == 0 ? a : v + a;
            }
            tot[s][i][q] = v;
          }
      }
    });

    // the cell step in registers; the new round(h) into every CTA's next
    // buffer (its own included), then the cluster barrier's arrive
    Pair hv[kSlots];
    float st[kSlots][2][Cell::kStash];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float x[NG], a[NG];
#pragma unroll
        for (int q = 0; q < NG; ++q) {
          x[q] = i ? Ops::second(xc[s][q]) : Ops::first(xc[s][q]);
          a[q] = tot[s][i][q] + bias[q][i];
        }
        Cell::step(h[s][i], c[s][i], x, a, st[s][i]);
      }
      hv[s] = Ops::pack(h[s][0], h[s][1]);
      if (on) {
        const int n = row_of(s);
        const uint32_t o = nxt + h_at + (n >> 3) * kc * 128 + (n & 7) * 16;
#pragma unroll
        for (int r = 0; r < kPeers; ++r)
          if (r < (int)csize) st_cluster(peer[r] + o, hv[s]);
      }
    }
    cluster_arrive();

    // the step's outputs go out while the peers catch up
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int b = b0 + row_of(s);
      if (on && b < B) {
        const size_t row = ((size_t)t * 2 + d) * B + b;
        Ops::store(hs + row * H + j, hv[s]);
        if constexpr (kStash) {
          float* gt = gates + row * Cell::kStash * H + j;
#pragma unroll
          for (int k = 0; k < Cell::kStash; ++k)
            *reinterpret_cast<float2*>(gt + k * H) =
                make_float2(st[s][0][k], st[s][1][k]);
        }
      }
    }
    if (kAhead) {
#pragma unroll
      for (int s = 0; s < kSlots; ++s)
#pragma unroll
        for (int q = 0; q < NG; ++q) xc[s][q] = xn[s][q];
    }
    // h(t + 1) has landed everywhere; nobody reads h(t) any more, so the
    // next step may overwrite it (and every handed partial has been read).
    // After the last step this wait also keeps every CTA alive until no
    // peer writes into its shared memory.
    cluster_wait();
  }
}

// the units a CTA owns at most: 32 for the f32 LSTM past 128 padded units
// (4 gates x 64 x 256 x 4 bytes would be 256 KB), else 64
constexpr int res_units(int gates, int elem, int H) {
  return gates == 4 && elem == 4 && H > 128 ? 32 : 64;
}

size_t resident_smem(int gates, int R, int H, int elem_bytes, int units) {
  return ((size_t)gates * units + 2 * (size_t)R) * H * elem_bytes +
         (size_t)(res_split(units, R) - 1) * gates * units * R * 4;
}

// Launch, or with info != null fill info = {dynamic shared memory bytes,
// the most clusters that can be resident at once, registers per thread,
// local memory bytes per thread} and launch nothing. A cluster that cannot
// be scheduled is refused with cudaErrorInvalidConfiguration.
template <class Cell, int R, bool kStash, class Ops, int kUnits>
cudaError_t launch_resident(const void* xw, const void* ut, const void* brec,
                            void* hs, void* gates, int steps, int B, int H,
                            int C, cudaStream_t stream, int* info) {
  using T = typename Ops::T;
  const auto kernel = birnn_resident_kernel<Cell, R, kStash, Ops, kUnits>;
  const size_t smem =
      resident_smem(Cell::kGates, R, H, sizeof(T), kUnits);
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * ((B + R - 1) / R), 2);
  cfg.blockDim = dim3(res_threads(kUnits, R));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  // the occupancy answer for (smem, C) does not change, and serving is
  // host-bound: it is kept, key and answer in one word so that concurrent
  // launches read them together
  static std::atomic<uint64_t> known{0};
  const uint64_t key = ((uint64_t)smem * 16 + C) << 32;
  const uint64_t seen = known.load(std::memory_order_relaxed);
  int clusters = (int)(uint32_t)seen;
  if ((seen & ~0xffffffffull) != key) {
    e = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg);
    if (e != cudaSuccess) return e;
    known.store(key | (uint32_t)clusters, std::memory_order_relaxed);
  }
  if (info) {
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, (const void*)kernel);
    if (e != cudaSuccess) return e;
    info[0] = (int)smem;
    info[1] = clusters;
    info[2] = fa.numRegs;
    info[3] = (int)fa.localSizeBytes;
    return cudaSuccess;
  }
  if (clusters == 0) return cudaErrorInvalidConfiguration;
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(xw),
                         static_cast<const T*>(ut),
                         static_cast<const float*>(brec), static_cast<T*>(hs),
                         static_cast<float*>(gates), steps, B, H, H / C);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// R 8, 16 or 32 batch rows a cluster; the f32 GRU 8 or 16 (at 256 units
// two f32 h buffers of 32 rows would not fit beside its U slice).
template <class Cell, bool kStash, class Ops, int kUnits>
int run_resident(const void* xw, const void* ut, const void* brec, void* hs,
                 void* gates, int steps, int B, int H, int C, int R,
                 void* stream, int* info) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R == 8)
    return (int)launch_resident<Cell, 8, kStash, Ops, kUnits>(
        xw, ut, brec, hs, gates, steps, B, H, C, s, info);
  if (R == 16)
    return (int)launch_resident<Cell, 16, kStash, Ops, kUnits>(
        xw, ut, brec, hs, gates, steps, B, H, C, s, info);
  if constexpr (sizeof(typename Ops::T) == 2 || Cell::kGates == 4) {
    if (R == 32)
      return (int)launch_resident<Cell, 32, kStash, Ops, kUnits>(
          xw, ut, brec, hs, gates, steps, B, H, C, s, info);
  }
  return (int)cudaErrorInvalidValue;
}

template <class Cell, class Ops, int kUnits = 64>
int run_cell(bool stash, const void* xw, const void* ut, const void* brec,
             void* hs, void* gates, int steps, int B, int H, int C, int R,
             void* stream, int* info) {
  return stash ? run_resident<Cell, true, Ops, kUnits>(
                     xw, ut, brec, hs, gates, steps, B, H, C, R, stream, info)
               : run_resident<Cell, false, Ops, kUnits>(
                     xw, ut, brec, hs, gates, steps, B, H, C, R, stream,
                     info);
}

// Every (cell, stash) pair in bf16 (elem 2, the bytes of xw's elements):
// the GRU without a stash (K2) and with one (K3), the LSTM without (K4) and
// with (K5); the same four in f32 (elem 4, 3xTF32 on the tensor cores). H
// (padded units) % 16 == 0, split over C CTAs of at most res_units units
// each, an even number: C <= 4 of 64, or for the f32 LSTM past 128 units C
// <= 8 of 32.
int resident(bool lstm, int elem, bool stash, const void* xw, const void* ut,
             const void* brec, void* hs, void* gates, int steps, int B, int H,
             int C, int R, void* stream, int* info) {
  const int units = res_units(lstm ? 4 : 3, elem, H);
  if (H % 16 || C < 1 || C > res_max_cluster(units) || H % C ||
      (H / C) % 2 || H / C > units || (elem != 2 && elem != 4))
    return (int)cudaErrorInvalidValue;
  if (elem == 2)
    return lstm ? run_cell<LstmCell, ResBf16>(stash, xw, ut, brec, hs, gates,
                                              steps, B, H, C, R, stream, info)
                : run_cell<GruCell, ResBf16>(stash, xw, ut, brec, hs, gates,
                                             steps, B, H, C, R, stream, info);
  if (!lstm)
    return run_cell<GruCell, ResTf32>(stash, xw, ut, brec, hs, gates, steps,
                                      B, H, C, R, stream, info);
  return units == 32
             ? run_cell<LstmCell, ResTf32, 32>(stash, xw, ut, brec, hs, gates,
                                               steps, B, H, C, R, stream, info)
             : run_cell<LstmCell, ResTf32>(stash, xw, ut, brec, hs, gates,
                                           steps, B, H, C, R, stream, info);
}

cudaError_t set_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <class Cell, bool kStash>
cudaError_t launch_f32(const void* xw, const void* U, const void* brec,
                       void* hs, void* gates, int steps, int B, int H,
                       cudaStream_t stream) {
  const size_t smem = 2 * (size_t)H * kBT * sizeof(float);
  cudaError_t e = set_smem((const void*)birnn_f32_kernel<Cell, kStash>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((B + kBT - 1) / kBT, 2);
  birnn_f32_kernel<Cell, kStash><<<grid, H, smem, stream>>>(
      static_cast<const float*>(xw), static_cast<const float*>(U),
      static_cast<const float*>(brec), static_cast<float*>(hs),
      static_cast<float*>(gates), steps, B, H);
  return cudaGetLastError();
}

template <class Cell, bool kStash>
cudaError_t launch_bf16(const void* xw, const void* ut, const void* brec,
                        void* hs, void* gates, int steps, int B, int H,
                        cudaStream_t stream) {
  const int warps = (H / 8 + kMmaJT - 1) / kMmaJT;
  const size_t a_bytes = 2 * (size_t)kMmaRows * (H + 8) * sizeof(__nv_bfloat16);
  const size_t stage = kMmaJT * Cell::kGates * 256;  // one ring stage
  dim3 grid((B + kMmaRows - 1) / kMmaRows, 2);
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(xw);
  const __nv_bfloat16* u = static_cast<const __nv_bfloat16*>(ut);
  const float* b = static_cast<const float*>(brec);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(hs);
  float* g = static_cast<float*>(gates);
  cudaError_t e;
  if (warps <= 8) {  // H <= 256: a 6-stage ring per warp fits
    const size_t smem = a_bytes + (size_t)warps * 6 * stage;
    e = set_smem((const void*)birnn_mma_kernel<Cell, 256, 6, kStash>, smem);
    if (e != cudaSuccess) return e;
    birnn_mma_kernel<Cell, 256, 6, kStash><<<grid, warps * 32, smem, stream>>>(
        x, u, b, o, g, steps, B, H);
  } else {  // up to 32 warps: one stage each, no lookahead
    const size_t smem = a_bytes + (size_t)warps * stage;
    e = set_smem((const void*)birnn_mma_kernel<Cell, 1024, 1, kStash>, smem);
    if (e != cudaSuccess) return e;
    birnn_mma_kernel<Cell, 1024, 1, kStash><<<grid, warps * 32, smem, stream>>>(
        x, u, b, o, g, steps, B, H);
  }
  return cudaGetLastError();
}

// The serving instance, or the training one when gates is not null.
template <class Cell>
int run(bool bf16, const void* xw, const void* u, const void* brec, void* hs,
        void* gates, int steps, int B, int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)(gates ? launch_bf16<Cell, true>(xw, u, brec, hs, gates,
                                                 steps, B, H, s)
                       : launch_bf16<Cell, false>(xw, u, brec, hs, nullptr,
                                                  steps, B, H, s));
  return (int)(gates ? launch_f32<Cell, true>(xw, u, brec, hs, gates, steps,
                                              B, H, s)
                     : launch_f32<Cell, false>(xw, u, brec, hs, nullptr,
                                               steps, B, H, s));
}

// ---- the GRU's reverse recurrence (bigru_backward's kernel) ----
//
// Replaces the plain loop of kernels/bigru.py::bigru_backward_plain, the
// port of JAX's lax.scan backward (crnn_ocr_tpu/kernels/bigru.py:214 _bwd;
// the JAX package has no Pallas kernel there). Per step t = T-1 .. 0, both
// directions at once (direction 1 time-reversed, as in the forward), from
// K3's stash [z | r | hh | rh], h_prev = hs[t - 1] (0 at t = 0) and g = the
// cotangent of hs:
//   dh = dh_carry + g_t
//   da_z = dh (h_prev - hh) z (1 - z), da_h = dh (1 - z) (1 - hh^2),
//   da_r = da_h rh r (1 - r)
//   drec_t = [da_z, da_r, da_h r], dxw_t = [da_z, da_r, da_h]
//   dh_carry = dh z + drec_t . U^T
// Each (direction, tile of R batch rows) is a cluster of C CTAs. CTA
// `rank` owns the units [rank upc, (rank + 1) upc): it reads their stash,
// keeps their dh z in registers, and writes their dxw, drec and h_prev.
// The product is split over K, not over its outputs: the CTA multiplies its
// own drec (R x 3 upc, in shared memory) by U's columns of its units (all H
// rows x 3 upc, resident in shared memory) into a partial dh_carry of every
// unit, and hands each owner its units' share with st.shared::cluster; after
// one cluster barrier the owner adds the C shares in rank order (a
// reduce-scatter). That moves H f32 a row; handing drec itself round (the
// forward's split, which exchanges h) would move 3H a row and need 2 x R x
// 3H x 4 bytes of buffers, 192 KB at R = 32 beside U's 96 KB.
// Shared memory, at H = 256, C = 4 (upc 64), R = 40, bf16 U (train-hard):
// U's columns as the product's A, H rows of 3 upc + 8 bf16 (the 8 keep a
// warp's rows on different banks), 100 KB; this step's drec as B, R rows of
// 3 upc + 8 f32, 31 KB (at upc % 16 == 8 the rows share banks: slower, not
// wrong); the shares handed in, two buffers (the step's and the last
// one's) of C x R x (upc + 4) f32, 85 KB: 216 KB of the 227
// (kernels/bigru.py::bwd_smem computes the same). An f32 U at H 256 takes
// C = 8 (upc 32, 104 KB of A). One CTA an SM: the card holds 30 clusters
// of 4, so B 1024 runs 52 clusters of 40 rows in two waves (32 rows: 64
// in three, 23 % slower; PERF.md). Where the time goes, at 32 rows: the
// kernel took 1.87 ms, 0.80 without the shares' remote stores and 0.89
// without the product (timing variants, not results).
// The product is f32, as the reference's (preferred_element_type=f32), on
// mma.sync.m16n8k8 in TF32 with drec split hi + lo (split_tf32). A bf16 U
// is a TF32 value (8 significant bits of 11), so U hi(drec) + U lo(drec) is
// the whole 3xTF32 product: its third term, lo(U) hi(drec), is 0
// (tests/test_torch_rnn_bwd.py shows it). An f32 U is split too: three
// products. A thread reads A and B as pairs of adjacent columns (8 kk + 2
// t4, + 1), the mma's k = t4 and t4 + 4: the same permutation of k on both
// operands, so the sum is over the same terms. No atomics: the same inputs
// give the same bits.
// dxw is rounded to hs's type once, from the f32 value the plain version
// casts. drec (2, T, B, 3H) and h_prev (2, T, B, H) f32 are laid out so that
// dU[d] = h_prev[d]^T drec[d] is one batched matmul after the kernel
// (kernels/bigru.py), and db a sum over drec's rows.
// Bound at train-hard's shape (T 64, B 1024, H 256, bf16), a layer: read
// the stash 537 MB, hs 67 MB and g 67 MB, write dxw 201 MB and drec 403 MB:
// 1.27 GB, 0.38 ms at 3.35 TB/s (h_prev's 134 MB f32 more, 0.42 ms); the
// products, 51.5 GFLOP, take 0.21 ms as two TF32 products at 495 TFLOP/s.
// Bytes-bound, plus T dependent steps of a cluster barrier each.

constexpr int kBwdThreads = 256;  // 8 warps
// the product's M-tiles (16 output units each) a warp takes at most: warp w
// takes tiles w and w + 8, so H <= 256
constexpr int kBwdTiles = 2;

// bytes of the backward's shared memory: A (H rows of 3 upc + 8 elements of
// U's type, rounded up to 16 bytes), B (R rows of 3 upc + 8 f32), the
// shares (2 x C x R x (upc + 4) f32)
__host__ __device__ size_t bwd_a_bytes(int H, int upc, int elem) {
  return ((size_t)H * (3 * upc + 8) * elem + 15) / 16 * 16;
}
size_t bwd_smem(int H, int C, int R, int elem) {
  const int upc = H / C;
  return bwd_a_bytes(H, upc, elem) + (size_t)R * (3 * upc + 8) * 4 +
         2 * (size_t)C * R * (upc + 4) * 4;
}

// The backward's operand types: hs, g, dxw and U in T; a thread moves two
// adjacent units as one Pair. a_pair: U's two columns (8 kk + 2 t4, + 1) of
// one A row as the TF32 operand words (bf16 widened exactly; f32 as is).
template <class T>
struct BwdOps;

template <>
struct BwdOps<__nv_bfloat16> {
  using Pair = uint32_t;
  static constexpr bool kSplitA = false;  // a bf16 value is a TF32 value
  __device__ static float first(Pair p) { return bf16_lo(p); }
  __device__ static float second(Pair p) { return bf16_hi(p); }
  __device__ static Pair load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  }
  __device__ static void store(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
  }
  __device__ static void a_pair(const __nv_bfloat16* p, uint32_t& k0,
                                uint32_t& k1) {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
    k0 = v << 16;
    k1 = v & 0xffff0000u;
  }
};

template <>
struct BwdOps<float> {
  using Pair = float2;
  static constexpr bool kSplitA = true;
  __device__ static float first(Pair p) { return p.x; }
  __device__ static float second(Pair p) { return p.y; }
  __device__ static Pair load(const float* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
  }
  __device__ static void store(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
  __device__ static void a_pair(const float* p, uint32_t& k0, uint32_t& k1) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    k0 = __float_as_uint(v.x);
    k1 = __float_as_uint(v.y);
  }
};

// g, hs (T, 2, B, H) and U (2, H, 3H) in T; gates (T, 2, B, 4H) f32 (K3's
// stash). Writes dxw (T, 2, B, 3H) in T, drec (2, T, B, 3H) and hprev (2,
// T, B, H) f32. Grid (C x tiles of R rows, 2 directions), clusters of C
// CTAs along x, upc = H / C units a CTA, at most 64. A thread takes the
// items tid + 256 k (k < R / 8) of the CTA's R x upc / 2 (row, unit pair)
// items, row-major, so a warp's loads and stores of a row are contiguous.
template <class T, int R>
__global__ void __launch_bounds__(kBwdThreads, 1)
bigru_bwd_kernel(const T* __restrict__ g, const T* __restrict__ hs,
                 const float* __restrict__ gates, const T* __restrict__ u,
                 T* __restrict__ dxw, float* __restrict__ drec,
                 float* __restrict__ hprev, int steps, int B, int H,
                 int upc) {
  using Ops = BwdOps<T>;
  using Pair = typename Ops::Pair;
  constexpr int NJ = R / 8;     // 8-row tiles of the batch (mma N = 8)
  constexpr int kItems = R / 8;  // items a thread at most (upc <= 64)
  extern __shared__ __align__(16) unsigned char bwd_smem_raw[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g4 = lane >> 2, t4 = lane & 3;
  const uint32_t rank = cluster_rank(), csize = cluster_size();
  const int d = blockIdx.y, b0 = (blockIdx.x / csize) * R;
  const int K = 3 * upc, ks = K + 8, ps = upc + 4, UP = upc / 2;
  const int G = 3 * H;
  T* sU = reinterpret_cast<T*>(bwd_smem_raw);
  float* sD = reinterpret_cast<float*>(bwd_smem_raw +
                                       bwd_a_bytes(H, upc, sizeof(T)));
  float* sP = sD + R * ks;
  const int pbuf = (int)csize * R * ps;  // floats of one buffer of shares

  // U's columns of this CTA's units, once: sU[m][q upc + c] = U[d][m][q H +
  // rank upc + c], two columns at a time
  const T* ud = u + (size_t)d * H * G;
  for (int i = tid; i < H * K / 2; i += kBwdThreads) {
    const int m = i / (K / 2), k = 2 * (i % (K / 2));
    const int q = k / upc, c = k - q * upc;
    *reinterpret_cast<Pair*>(sU + m * ks + k) =
        *reinterpret_cast<const Pair*>(ud + (size_t)m * G + q * H +
                                       rank * upc + c);
  }
  const uint32_t sp = smem_addr(sP);

  struct In {
    float2 z, r, hh, rh;
    Pair hp, g;
  };
  In in[kItems];
  float dhz[kItems][2];
  const int items = R * UP;
  // step t's inputs of the thread's items, zero past the batch
  auto load_in = [&](int t) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int it = tid + k * kBwdThreads;
      const int n = it / UP, j = rank * upc + 2 * (it % UP);
      const int b = b0 + n;
      In v = {};
      if (it < items && b < B) {
        const size_t row = ((size_t)t * 2 + d) * B + b;
        const float* st = gates + row * 4 * H + j;
        v.z = __ldg(reinterpret_cast<const float2*>(st));
        v.r = __ldg(reinterpret_cast<const float2*>(st + H));
        v.hh = __ldg(reinterpret_cast<const float2*>(st + 2 * H));
        v.rh = __ldg(reinterpret_cast<const float2*>(st + 3 * H));
        v.g = Ops::load(g + row * H + j);
        if (t > 0) v.hp = Ops::load(hs + (row - 2 * (size_t)B) * H + j);
      }
      in[k] = v;
    }
  };
  if (steps > 0) load_in(steps - 1);
  cluster_arrive();  // every CTA runs, its U columns in place
  cluster_wait();

  const int mtiles = H / 16;
  for (int s = 0; s < steps; ++s) {
    const int t = steps - 1 - s;
    const float* prev = sP + ((s + 1) & 1) * pbuf;  // step s - 1's shares
    // the elementwise part, the thread's items: dh from the carry, the
    // gate cotangents, drec into shared memory (the product's B) and the
    // step's outputs
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int it = tid + k * kBwdThreads;
      if (it >= items) continue;
      const int n = it / UP, c = 2 * (it % UP), j = rank * upc + c;
      const int b = b0 + n;
      float car[2] = {0.f, 0.f};
      if (s > 0) {
        float2 sum = *reinterpret_cast<const float2*>(prev + n * ps + c);
        for (int src = 1; src < (int)csize; ++src) {  // rank order
          const float2 v = *reinterpret_cast<const float2*>(
              prev + (src * R + n) * ps + c);
          sum.x += v.x;
          sum.y += v.y;
        }
        car[0] = dhz[k][0] + sum.x;
        car[1] = dhz[k][1] + sum.y;
      }
      const In& v = in[k];
      const float gz[2] = {v.z.x, v.z.y}, gr[2] = {v.r.x, v.r.y};
      const float ghh[2] = {v.hh.x, v.hh.y}, grh[2] = {v.rh.x, v.rh.y};
      const float gg[2] = {Ops::first(v.g), Ops::second(v.g)};
      const float hp[2] = {Ops::first(v.hp), Ops::second(v.hp)};
      float az[2], ar[2], ah[2], arh[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dh = car[e] + gg[e];
        const float z = gz[e], r = gr[e], hh = ghh[e];
        az[e] = dh * (hp[e] - hh) * z * (1.f - z);
        ah[e] = dh * (1.f - z) * (1.f - hh * hh);
        ar[e] = ah[e] * grh[e] * r * (1.f - r);
        arh[e] = ah[e] * r;
        dhz[k][e] = dh * z;
      }
      float* bd = sD + n * ks + c;
      *reinterpret_cast<float2*>(bd) = make_float2(az[0], az[1]);
      *reinterpret_cast<float2*>(bd + upc) = make_float2(ar[0], ar[1]);
      *reinterpret_cast<float2*>(bd + 2 * upc) = make_float2(arh[0], arh[1]);
      if (b < B) {
        const size_t row = ((size_t)t * 2 + d) * B + b;
        T* dx = dxw + row * G + j;
        Ops::store(dx, az[0], az[1]);
        Ops::store(dx + H, ar[0], ar[1]);
        Ops::store(dx + 2 * H, ah[0], ah[1]);
        const size_t orow = ((size_t)d * steps + t) * B + b;
        float* dr = drec + orow * G + j;
        *reinterpret_cast<float2*>(dr) = make_float2(az[0], az[1]);
        *reinterpret_cast<float2*>(dr + H) = make_float2(ar[0], ar[1]);
        *reinterpret_cast<float2*>(dr + 2 * H) = make_float2(arh[0], arh[1]);
        *reinterpret_cast<float2*>(hprev + orow * H + j) =
            make_float2(hp[0], hp[1]);
      }
    }
    if (t == 0) break;  // dh_carry before the first step is not needed
    load_in(t - 1);     // in flight through the product and the barrier
    __syncthreads();    // drec complete in sD

    // the partial dh_carry of every unit from this CTA's K part: warp w
    // takes the M-tiles w and w + 8 (16 units each) over all R rows
    float acc[kBwdTiles][NJ][4], cross[kBwdTiles][NJ][4];
#pragma unroll
    for (int i = 0; i < kBwdTiles; ++i)
#pragma unroll
      for (int jn = 0; jn < NJ; ++jn)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][jn][v] = cross[i][jn][v] = 0.f;
    for (int kk = 0; kk < K / 8; ++kk) {
      uint32_t bh[NJ][2], bl[NJ][2];
#pragma unroll
      for (int jn = 0; jn < NJ; ++jn) {
        const float2 v = *reinterpret_cast<const float2*>(
            sD + (8 * jn + g4) * ks + 8 * kk + 2 * t4);
        split_tf32(__float_as_uint(v.x), bh[jn][0], bl[jn][0]);
        split_tf32(__float_as_uint(v.y), bh[jn][1], bl[jn][1]);
      }
#pragma unroll
      for (int i = 0; i < kBwdTiles; ++i) {
        const int mt = warp + 8 * i;
        if (mt >= mtiles) break;  // warp-uniform
        const T* ap = sU + (16 * mt + g4) * ks + 8 * kk + 2 * t4;
        uint32_t a[4];
        Ops::a_pair(ap, a[0], a[2]);
        Ops::a_pair(ap + 8 * ks, a[1], a[3]);
        if constexpr (Ops::kSplitA) {
          uint32_t ah[4], al[4];
#pragma unroll
          for (int x = 0; x < 4; ++x) split_tf32(a[x], ah[x], al[x]);
#pragma unroll
          for (int jn = 0; jn < NJ; ++jn) {
            mma1688(cross[i][jn], al, bh[jn]);
            mma1688(cross[i][jn], ah, bl[jn]);
            mma1688(acc[i][jn], ah, bh[jn]);
          }
        } else {
#pragma unroll
          for (int jn = 0; jn < NJ; ++jn) {
            mma1688(cross[i][jn], a, bl[jn]);
            mma1688(acc[i][jn], a, bh[jn]);
          }
        }
      }
    }
    // each unit's share to its owner: unit 16 mt + g4 (+ 8), rows 8 jn + 2
    // t4 (+ 1), into the owner's buffer s & 1, slot `rank`
    const uint32_t cur = (uint32_t)((s & 1) * pbuf + rank * R * ps) * 4u;
#pragma unroll
    for (int i = 0; i < kBwdTiles; ++i) {
      const int mt = warp + 8 * i;
      if (mt >= mtiles) break;
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int jj = 16 * mt + g4 + 8 * hi;
        const int owner = jj / upc, c = jj - owner * upc;
        const uint32_t base = map_rank(sp, owner) + cur + (uint32_t)c * 4u;
#pragma unroll
        for (int jn = 0; jn < NJ; ++jn)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = 8 * jn + 2 * t4 + e;
            st_cluster(base + (uint32_t)(n * ps) * 4u,
                       __float_as_uint(acc[i][jn][2 * hi + e] +
                                       cross[i][jn][2 * hi + e]));
          }
      }
    }
    cluster_arrive();
    // every share of this step has landed; nobody reads step s - 1's any
    // more, so step s + 1 may overwrite that buffer (and sD). After the
    // last exchange this wait also keeps every CTA alive until no peer
    // writes into its shared memory.
    cluster_wait();
  }
}

// Launch, or with info != null fill info = {dynamic shared memory bytes, the
// most clusters resident at once, registers per thread, local memory bytes
// per thread} and launch nothing. A cluster that cannot be scheduled is
// refused with cudaErrorInvalidConfiguration.
template <class T, int R>
cudaError_t launch_bwd(const void* g, const void* hs, const void* gates,
                       const void* u, void* dxw, void* drec, void* hprev,
                       int steps, int B, int H, int C, cudaStream_t stream,
                       int* info) {
  const auto kernel = bigru_bwd_kernel<T, R>;
  const size_t smem = bwd_smem(H, C, R, sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * ((B + R - 1) / R), 2);
  cfg.blockDim = dim3(kBwdThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  // the occupancy answer for (smem, C), kept as launch_resident keeps it
  static std::atomic<uint64_t> known{0};
  const uint64_t key = ((uint64_t)smem * 16 + C) << 32;
  const uint64_t seen = known.load(std::memory_order_relaxed);
  int clusters = (int)(uint32_t)seen;
  if ((seen & ~0xffffffffull) != key) {
    e = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg);
    if (e != cudaSuccess) return e;
    known.store(key | (uint32_t)clusters, std::memory_order_relaxed);
  }
  if (info) {
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, (const void*)kernel);
    if (e != cudaSuccess) return e;
    info[0] = (int)smem;
    info[1] = clusters;
    info[2] = fa.numRegs;
    info[3] = (int)fa.localSizeBytes;
    return cudaSuccess;
  }
  if (clusters == 0) return cudaErrorInvalidConfiguration;
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(g),
                         static_cast<const T*>(hs),
                         static_cast<const float*>(gates),
                         static_cast<const T*>(u), static_cast<T*>(dxw),
                         static_cast<float*>(drec),
                         static_cast<float*>(hprev), steps, B, H, H / C);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <class T>
int run_bwd(const void* g, const void* hs, const void* gates, const void* u,
            void* dxw, void* drec, void* hprev, int steps, int B, int H,
            int C, int R, cudaStream_t s, int* info) {
  if (R == 8)
    return (int)launch_bwd<T, 8>(g, hs, gates, u, dxw, drec, hprev, steps,
                                 B, H, C, s, info);
  if (R == 16)
    return (int)launch_bwd<T, 16>(g, hs, gates, u, dxw, drec, hprev, steps,
                                  B, H, C, s, info);
  if (R == 32)
    return (int)launch_bwd<T, 32>(g, hs, gates, u, dxw, drec, hprev, steps,
                                  B, H, C, s, info);
  return (int)launch_bwd<T, 40>(g, hs, gates, u, dxw, drec, hprev, steps, B,
                                H, C, s, info);
}

// H (padded units) % 16 == 0 and at most 256, split over C CTAs (at most 8,
// the portable maximum) of upc = H / C units, upc % 8 == 0 (3 upc whole
// k-steps of 8; a warp's 8 units of a share have one owner) and at most 64;
// R 8, 16, 32 or 40; the shared memory within the 227 KB a block may hold
// (kernels/bigru.py::backward_design_for picks only such shapes).
int bigru_bwd(int elem, const void* g, const void* hs, const void* gates,
              const void* u, void* dxw, void* drec, void* hprev, int steps,
              int B, int H, int C, int R, void* stream, int* info) {
  if (H % 16 || H < 16 || H > 16 * 8 * kBwdTiles || C < 1 || C > 8 ||
      H % C || (H / C) % 8 || H / C > 64 ||
      (R != 8 && R != 16 && R != 32 && R != 40) ||
      (elem != 2 && elem != 4) || bwd_smem(H, C, R, elem) > 232448)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem == 2)
    return run_bwd<__nv_bfloat16>(g, hs, gates, u, dxw, drec, hprev, steps,
                                  B, H, C, R, s, info);
  return run_bwd<float>(g, hs, gates, u, dxw, drec, hprev, steps, B, H, C, R,
                        s, info);
}

}  // namespace

// K2, or K3 when gates is not null (then gates (T, 2, B, 4H) f32 is written
// too). f32: xw (T, 2, B, 3H), U (2, H, 3H), brec (2, 3H) -> hs (T, 2, B, H).
extern "C" int crnn_bigru_f32(const void* xw, const void* U, const void* brec,
                              void* hs, void* gates, int steps, int B, int H,
                              void* stream) {
  return run<GruCell>(false, xw, U, brec, hs, gates, steps, B, H, stream);
}

// bf16: xw, hs bf16 as above; ut (2, 3H, H) bf16 is U prepared as the mma
// kernel's header says; brec f32. H % 16 == 0, H <= 1024.
extern "C" int crnn_bigru_bf16(const void* xw, const void* ut,
                               const void* brec, void* hs, void* gates,
                               int steps, int B, int H, void* stream) {
  return run<GruCell>(true, xw, ut, brec, hs, gates, steps, B, H, stream);
}

// K4, or K5 when gates is not null (then gates (T, 2, B, 5H) f32 is written
// too). f32: xw (T, 2, B, 4H) with the bias folded in, U (2, H, 4H) ->
// hs (T, 2, B, H).
extern "C" int crnn_bilstm_f32(const void* xw, const void* U, void* hs,
                               void* gates, int steps, int B, int H,
                               void* stream) {
  return run<LstmCell>(false, xw, U, nullptr, hs, gates, steps, B, H, stream);
}

// bf16: xw, hs bf16 as above; ut (2, 4H, H) bf16 is U prepared as the mma
// kernel's header says. H % 16 == 0, H <= 1024.
extern "C" int crnn_bilstm_bf16(const void* xw, const void* ut, void* hs,
                                void* gates, int steps, int B, int H,
                                void* stream) {
  return run<LstmCell>(true, xw, ut, nullptr, hs, gates, steps, B, H, stream);
}

// K2 or K3 (lstm = 0, brec the (2, 3H) f32 recurrent bias), K4 or K5
// (lstm = 1, brec null) on the resident design: the training instance (K3,
// K5) when gates is not null, which then receives the stash (T, 2, B, 4H or
// 5H) f32. C CTAs a cluster (at most 4; 8 for the f32 LSTM past 128
// units), R (8, 16 or 32; the f32 GRU 8 or 16) batch rows a cluster. elem,
// the bytes of an element of xw, picks the instance: 2, bf16, xw, ut, hs as
// crnn_bigru_bf16 and crnn_bilstm_bf16 take them; 4, f32 (3xTF32): xw, hs
// f32 as crnn_bigru_f32 and crnn_bilstm_f32 take them, ut (2, nH, H) f32
// U[d] transposed.
extern "C" int crnn_birnn_resident(int lstm, int elem, const void* xw,
                                   const void* ut, const void* brec, void* hs,
                                   void* gates, int steps, int B, int H,
                                   int C, int R, void* stream) {
  return resident(lstm, elem, gates != nullptr, xw, ut, brec, hs, gates,
                  steps, B, H, C, R, stream, nullptr);
}

// The resources of the resident instance (lstm, elem, stash, R) at H
// units over C CTAs, launching nothing: info[4] = {dynamic shared memory
// bytes, most clusters resident at once, registers per thread, local memory
// bytes per thread}.
extern "C" int crnn_birnn_resident_info(int lstm, int elem, int stash,
                                        int H, int C, int R, int* info) {
  return resident(lstm, elem, stash, nullptr, nullptr, nullptr, nullptr,
                  nullptr, 0, 1, H, C, R, nullptr, info);
}

extern "C" const char* crnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The GRU's backward on the resident design (kernels/bigru.py::
// bigru_backward): elem 2, g, hs, U (2, H, 3H) and dxw bf16; elem 4, f32.
// gates is K3's stash (T, 2, B, 4H) f32; drec (2, T, B, 3H) and hprev (2, T,
// B, H) f32 are written for dU and db. H padded units over C CTAs, R batch
// rows a cluster (bigru_bwd's header).
extern "C" int crnn_bigru_bwd(int elem, const void* g, const void* hs,
                              const void* gates, const void* u, void* dxw,
                              void* drec, void* hprev, int steps, int B,
                              int H, int C, int R, void* stream) {
  return bigru_bwd(elem, g, hs, gates, u, dxw, drec, hprev, steps, B, H, C,
                   R, stream, nullptr);
}

// The resources of the backward's instance (elem, R) at H units over C CTAs,
// launching nothing: info[4] as crnn_birnn_resident_info's.
extern "C" int crnn_bigru_bwd_info(int elem, int H, int C, int R, int* info) {
  return bigru_bwd(elem, nullptr, nullptr, nullptr, nullptr, nullptr,
                   nullptr, nullptr, 0, 1, H, C, R, nullptr, info);
}
