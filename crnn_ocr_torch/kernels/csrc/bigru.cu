// BiGRU recurrence, both directions, the time loop inside the kernel.
//
// Replaces crnn_ocr_tpu/kernels/bigru.py::bigru_pallas_raw (the Pallas body
// _kernel, whose sequential grid over T carried h in VMEM). Keras GRU with
// reset_after, gates z|r|h:
//   rec = round(h) . U[d] + b_rec[d]   (round: to the compute type)
//   z = sig(xz + rz), r = sig(xr + rr), hh = tanh(xh + r * rh)
//   h = z * h + (1 - z) * hh           (h carried in f32)
// xw (T, 2, B, 3H) holds the input projections plus the input bias, with
// direction 1 already time-reversed by the caller; hs (T, 2, B, H) is
// written in xw's type, direction 1 still reversed.
//
// Design: the work is split by (direction, tile of batch rows), never by
// hidden columns, so no block needs another block's state, no grid-wide
// sync exists, and the time loop runs inside the block with one
// __syncthreads per step. Two kernels, one per compute type:
//
// * bf16 (the main path), bigru_mma_kernel: a block owns 16 batch rows (one
//   m16 tile) and kMmaJT 8-wide tiles of hidden units j per warp, for all
//   three gates, so the thread that holds the z, r and h accumulators of a
//   (row, j) also does its gate math and keeps its f32 state h in
//   registers across all T steps. round(h) sits in shared memory as the A
//   operand of mma.sync.m16n8k16 (bf16 in, f32 accumulate), two buffers
//   that alternate between steps. U does not fit: 384 KB per direction in
//   bf16 at H = 256, above the 227 KB of shared memory a block may hold. So
//   every step each warp streams its B fragments from global memory (L2)
//   through its own ring of shared-memory stages with cp.async, several
//   k-steps ahead and on across time steps. The wrapper transposes U to
//   [d][n][k] and permutes k within each 16-block, so that a fragment is
//   256 contiguous bytes and one 8-byte shared load per lane.
// * f32, bigru_f32_kernel: a block has H threads; thread j owns column j of
//   the three gates for kBT rows and walks k over H with CUDA-core FMAs,
//   U[d][k][j] read from global memory, round(h) (here h itself) in shared
//   memory as [H][kBT].
//
// Bound on the H100 per layer at the main path (T=64, B=256, H=256, bf16):
// bytes, 50.3 MB of xw in + 16.8 MB of hs out = 67.9 MB / 3.35 TB/s =
// 20.3 us; operations, 12.9 GFLOP / 989 TFLOP/s = 13 us; plus 64 dependent
// steps. Each block re-reads its direction's 384 KB of U from L2 every
// step, which bounds this design near 3.4 us per step. Left for later: U resident in
// shared memory (a 2-CTA cluster with distributed shared memory at H = 256)
// and wgmma.

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

// Keras reset_after gate math; h carried in f32.
__device__ __forceinline__ float gru_cell(float h, float xz, float xr,
                                          float xh, float rz, float rr,
                                          float rh) {
  const float z = sigmoid(xz + rz);
  const float r = sigmoid(xr + rr);
  const float hh = tanhf(xh + r * rh);
  return z * h + (1.f - z) * hh;
}

__global__ void __launch_bounds__(1024)
bigru_f32_kernel(const float* __restrict__ xw, const float* __restrict__ U,
                 const float* __restrict__ brec, float* __restrict__ hs,
                 int steps, int B, int H) {
  extern __shared__ float4 smem4[];  // 2 buffers of [H][kBT] floats
  float* smem = reinterpret_cast<float*>(smem4);
  const int j = threadIdx.x;
  const int d = blockIdx.y;
  const int b0 = blockIdx.x * kBT;
  const int G = 3 * H;
  const float* Ud = U + (size_t)d * H * G;
  const float bz = brec[d * G + j];
  const float br = brec[d * G + H + j];
  const float bh = brec[d * G + 2 * H + j];

  float h[kBT];
#pragma unroll
  for (int i = 0; i < kBT; ++i) {
    h[i] = 0.f;
    smem[j * kBT + i] = 0.f;
  }
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    const float* hin = smem + (t & 1) * H * kBT;
    float* hout = smem + ((t + 1) & 1) * H * kBT;
    float az[kBT], ar[kBT], ah[kBT];
#pragma unroll
    for (int i = 0; i < kBT; ++i) az[i] = ar[i] = ah[i] = 0.f;
    const float* u = Ud + j;
#pragma unroll 4
    for (int k = 0; k < H; ++k) {
      const float uz = u[0], ur = u[H], uh = u[2 * H];
      u += G;
      const float4* hk = reinterpret_cast<const float4*>(hin + k * kBT);
      float hv[kBT];
#pragma unroll
      for (int q = 0; q < kBT / 4; ++q) {
        const float4 v = hk[q];
        hv[4 * q] = v.x;
        hv[4 * q + 1] = v.y;
        hv[4 * q + 2] = v.z;
        hv[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < kBT; ++i) {
        az[i] = fmaf(hv[i], uz, az[i]);
        ar[i] = fmaf(hv[i], ur, ar[i]);
        ah[i] = fmaf(hv[i], uh, ah[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kBT; ++i) {
      const int b = b0 + i;
      float xz = 0.f, xr = 0.f, xh = 0.f;
      const size_t row = ((size_t)t * 2 + d) * B + b;
      if (b < B) {
        const float* x = xw + row * G;
        xz = x[j];
        xr = x[H + j];
        xh = x[2 * H + j];
      }
      h[i] = gru_cell(h[i], xz, xr, xh, az[i] + bz, ar[i] + br, ah[i] + bh);
      hout[j * kBT + i] = h[i];
      if (b < B) hs[row * H + j] = h[i];
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

// Bytes of one k-step's B fragments of one warp: kMmaJT tiles x 3 gates x
// (8 columns n x 16 k x 2 bytes).
constexpr int kStageBytes = kMmaJT * 3 * 256;

// xw (T, 2, B, 3H), hs (T, 2, B, H) bf16; ut (2, 3H, H) bf16 is U[d]
// transposed ([n][k]) with k permuted inside each 16-block to
// (0,1,8,9, 2,3,10,11, 4,5,12,13, 6,7,14,15). H % 16 == 0.
// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4):
//   A a0: (row g, k 2t..2t+1)  a1: (g+8, 2t..)  a2: (g, 2t+8..)  a3: (g+8, 2t+8..)
//   B b0: (k 2t..2t+1, col g)  b1: (k 2t+8..2t+9, col g)
//   C c0,c1: (row g, cols 2t, 2t+1)  c2,c3: (row g+8, cols 2t, 2t+1)
// Each warp streams its own B fragments through a ring of kStages
// shared-memory stages with cp.async, kStages - 1 k-steps ahead; the ring
// runs on across time steps, since U does not change.
template <int kMaxThreads, int kStages>
__global__ void __launch_bounds__(kMaxThreads)
bigru_mma_kernel(const __nv_bfloat16* __restrict__ xw,
                 const __nv_bfloat16* __restrict__ ut,
                 const float* __restrict__ brec,
                 __nv_bfloat16* __restrict__ hs, int steps, int B, int H) {
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* hA = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  const int lda = H + 8;  // padded row: the 8 rows of a fragment hit
                          // 8 different bank groups
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int d = blockIdx.y, b0 = blockIdx.x * kMmaRows;
  const int G = 3 * H;
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
        const int f = c >> 4;        // fragment: tile slot * 3 + gate
        const int r = (c >> 1) & 7;  // column n within the fragment
        const int half = c & 1;      // which 16 bytes of its 32
        const int tile = warp * kMmaJT + f / 3;
        if (tile < ntiles)
          cp_async16(st + f * 256 + r * 32 + half * 16,
                     utd + (size_t)((f % 3) * H + tile * 8 + r) * H +
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
  float h[kMmaJT][4];
  float bias[kMmaJT][3][2];
#pragma unroll
  for (int s = 0; s < kMmaJT; ++s) {
    const int j = (warp * kMmaJT + s) * 8 + 2 * t4;
    const bool on = warp * kMmaJT + s < ntiles;
#pragma unroll
    for (int e = 0; e < 4; ++e) h[s][e] = 0.f;
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        bias[s][q][e] = on ? brec[d * G + q * H + j + e] : 0.f;
  }
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    const __nv_bfloat16* A = hA + (t & 1) * kMmaRows * lda;
    __nv_bfloat16* An = hA + ((t + 1) & 1) * kMmaRows * lda;
    // this step's projections, fetched before the products to hide latency
    uint32_t xv[kMmaJT][3][2];
#pragma unroll
    for (int s = 0; s < kMmaJT; ++s) {
      const int j = (warp * kMmaJT + s) * 8 + 2 * t4;
      const bool on = warp * kMmaJT + s < ntiles;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int b = b0 + g + 8 * r;
        const __nv_bfloat16* x = xw + (((size_t)t * 2 + d) * B + b) * G + j;
#pragma unroll
        for (int q = 0; q < 3; ++q)
          xv[s][q][r] = (on && b < B)
              ? __ldg(reinterpret_cast<const unsigned int*>(x + q * H))
              : 0u;
      }
    }
    float acc[kMmaJT][3][4];
#pragma unroll
    for (int s = 0; s < kMmaJT; ++s)
#pragma unroll
      for (int q = 0; q < 3; ++q)
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
        for (int q = 0; q < 3; ++q) {
          const uint2 bv = *reinterpret_cast<const uint2*>(
              st + (s * 3 + q) * 256 + g * 32 + t4 * 8);
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
        float hn[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 2 * r + e;
          const float xz = e ? bf16_hi(xv[s][0][r]) : bf16_lo(xv[s][0][r]);
          const float xr = e ? bf16_hi(xv[s][1][r]) : bf16_lo(xv[s][1][r]);
          const float xh = e ? bf16_hi(xv[s][2][r]) : bf16_lo(xv[s][2][r]);
          h[s][c] = gru_cell(h[s][c], xz, xr, xh, acc[s][0][c] + bias[s][0][e],
                             acc[s][1][c] + bias[s][1][e],
                             acc[s][2][c] + bias[s][2][e]);
          hn[e] = h[s][c];
        }
        const uint32_t packed = pack_bf16(hn[0], hn[1]);
        *reinterpret_cast<uint32_t*>(An + row * lda + j) = packed;
        if (b < B)
          *reinterpret_cast<uint32_t*>(
              hs + (((size_t)t * 2 + d) * B + b) * H + j) = packed;
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

}  // namespace

// f32: xw (T, 2, B, 3H), U (2, H, 3H), brec (2, 3H) -> hs (T, 2, B, H).
extern "C" int crnn_bigru_f32(const void* xw, const void* U, const void* brec,
                              void* hs, int steps, int B, int H,
                              void* stream) {
  const size_t smem = 2 * (size_t)H * kBT * sizeof(float);
  cudaError_t e = set_smem((const void*)bigru_f32_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((B + kBT - 1) / kBT, 2);
  bigru_f32_kernel<<<grid, H, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xw), static_cast<const float*>(U),
      static_cast<const float*>(brec), static_cast<float*>(hs), steps, B, H);
  return (int)cudaGetLastError();
}

// bf16: xw, hs bf16 as above; ut (2, 3H, H) bf16 is U prepared as the
// mma kernel's header says; brec f32. H % 16 == 0, H <= 1024.
extern "C" int crnn_bigru_bf16(const void* xw, const void* ut,
                               const void* brec, void* hs, int steps, int B,
                               int H, void* stream) {
  const int warps = (H / 8 + kMmaJT - 1) / kMmaJT;
  const size_t a_bytes = 2 * (size_t)kMmaRows * (H + 8) * sizeof(__nv_bfloat16);
  dim3 grid((B + kMmaRows - 1) / kMmaRows, 2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(xw);
  const __nv_bfloat16* u = static_cast<const __nv_bfloat16*>(ut);
  const float* b = static_cast<const float*>(brec);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(hs);
  cudaError_t e;
  if (warps <= 8) {  // H <= 256: a 6-stage ring per warp fits
    const size_t smem = a_bytes + (size_t)warps * 6 * kStageBytes;
    e = set_smem((const void*)bigru_mma_kernel<256, 6>, smem);
    if (e != cudaSuccess) return (int)e;
    bigru_mma_kernel<256, 6><<<grid, warps * 32, smem, s>>>(x, u, b, o,
                                                             steps, B, H);
  } else {  // up to 32 warps: one stage each, no lookahead
    const size_t smem = a_bytes + (size_t)warps * kStageBytes;
    e = set_smem((const void*)bigru_mma_kernel<1024, 1>, smem);
    if (e != cudaSuccess) return (int)e;
    bigru_mma_kernel<1024, 1><<<grid, warps * 32, smem, s>>>(x, u, b, o,
                                                              steps, B, H);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* crnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
