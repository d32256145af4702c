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
// Design: the work is split by (direction, tile of batch rows), never by
// hidden columns, so no block needs another block's state, no grid-wide
// sync exists, and the time loop runs inside the block with one
// __syncthreads per step. The cell is a template policy (GruCell,
// LstmCell): its gate count, its stash, whether it has a recurrent bias and
// its per-unit step. Two kernels, one per compute type, each instantiated
// for both cells:
//
// * bf16 (the main path), birnn_mma_kernel: a block owns 16 batch rows (one
//   m16 tile) and kMmaJT 8-wide tiles of hidden units j per warp, for every
//   gate, so the thread that holds a (row, j)'s gate accumulators also does
//   its gate math and keeps its f32 state (h; and c for the LSTM) in
//   registers across all T steps. round(h) sits in shared memory as the A
//   operand of mma.sync.m16n8k16 (bf16 in, f32 accumulate), two buffers
//   that alternate between steps. U does not fit: 384 KB (GRU) or 512 KB
//   (LSTM) per direction in bf16 at H = 256, above the 227 KB of shared
//   memory a block may hold. So every step each warp streams its B
//   fragments from global memory (L2) through its own ring of shared-memory
//   stages with cp.async, several k-steps ahead and on across time steps.
//   The wrapper transposes U to [d][n][k] and permutes k within each
//   16-block, so that a fragment is 256 contiguous bytes and one 8-byte
//   shared load per lane. At H = 256 the LSTM's ring (8 warps x 6 stages x
//   4 gates x 4 tiles x 256 B = 192 KB) and the two A buffers (16.5 KB)
//   take 208.5 KB.
// * f32, birnn_f32_kernel: a block has H threads; thread j owns column j of
//   every gate for kBT rows and walks k over H with CUDA-core FMAs,
//   U[d][k][j] read from global memory, round(h) (here h itself) in shared
//   memory as [H][kBT].
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
// All four are bytes-bound, the stash above all, plus 64 dependent steps.
// Each block re-reads its direction's U from L2 every step, which bounds
// this design near 3.4 us (GRU) and 4.5 us (LSTM) per step. Left for later:
// U resident in shared memory (a cluster with distributed shared memory at
// H = 256) and wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

extern "C" const char* crnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
