// The stem, serving and training: conv3x3 (1 -> C) + BatchNorm + ReLU +
// maxpool 2x2, without the full-resolution activation in device memory.
//
// Four kernels share one conv function on the same patch values (K1 and K8
// load them with load_patch, K9 and K10 from a staged band), so that every
// pass computes each conv output z bit for bit alike (K9 and K10 route the
// pooled gradient by comparing recomputed activations; a different sum
// order could move a tie or a first maximum between passes):
//
// K1  stem_kernel: maxpool2x2(relu(z * scale + bias)), NHWC out. Replaces
//     crnn_ocr_tpu/kernels/fused_stem.py::fused_stem_serve (_stem_kernel).
//     Serving folds BatchNorm's running statistics into (scale, bias);
//     training feeds it the batch statistics from K8.
// K8  stats_kernel: per-channel partial sums of z and z^2 over the batch.
//     Replaces kernels/fused_stem_train.py::_run_stats (_stats_kernel).
// K9  bwd_tile_kernel<T, false>: the pooled gradient routed to the first
//     maximum of its window in (h, w) order and masked by the ReLU, then
//     per-channel partial sums of d and d * xhat. Replaces
//     ::_run_bwd_partials (_bwd_partials_kernel).
// K10 bwd_tile_kernel<T, true>: the same routing, the BatchNorm backward
//     d_conv = c1 * (d - c2 - xhat * c3) at every position (dense: c2 and c3
//     couple every position through the batch statistics), and per-CTA
//     partials of d_w[kh][kw][c] = sum(tap * d_conv), on the tensor cores.
//     Replaces ::_run_bwd_final (_bwd_final_kernel). No image gradient: the
//     training stem's image is a gradient leaf (non-STN models only).
//
// Design of K1 and K8: K1 one thread per (image, pooled pixel, group of 8
// channels), 8 channels written with one vector store; K8 one thread per
// (pooled pixel, channel) in 256-thread blocks of (CB, P): CB = min(C, 256)
// channels, P = 256 / CB pixels, each thread loading its 4x4 input patch
// (SAME zero padding) from device memory; sums in registers over a
// grid-stride loop, then a fixed-order block reduction into per-block
// partials (blocks, 2, C).
//
// Design of K9 and K10: a persistent grid of one wave (the wrapper's plan,
// fused_stem_train.py::bwd_plan: min(tiles, the CTAs the card holds)) walks
// tiles in a static order (tile blockIdx.x, + gridDim.x, ...). A tile is
// one image's band of `rows` pooled rows by one column tile (the pooled
// columns in `col_tiles` near-equal runs of at most kColCap) by one chunk
// of kChunk channels. The CTA stages the band's 2 rows + 2 image rows,
// widened to f32 with the SAME zero halo written in (patch reads are then
// shared-memory loads without bounds checks), and the chunk's taps and
// BatchNorm vectors, 20 floats a channel. A thread owns (pooled pixel,
// kCPT channels): it reads the 4x4 patch once for its channels (the 16
// threads of a pixel broadcast), each channel's constants as four 16-byte
// loads without bank conflicts, the pooled gradient with the next pass's
// loads in flight, and recomputes z with conv9. Routing and sums are
// branch-free. K9 adds d and d * xhat at the hit position only (the other
// three are exact zeros), then reduces its sums by warp shuffle and shared
// memory in a fixed order into per-CTA partials (CTAs, 2, C). K10 writes
// each pass's d_conv and patches to its warp's own buffer (no CTA barrier
// a pass: a warp multiplies only its own two pixels' 8 positions) and runs
// d_w[tap][c] += sum tap * d_conv with mma.sync.m16n8k8 in TF32: A the
// taps (M 16 = 9 taps padded, exact in TF32 in bf16 mode), B d_conv split
// into hi (x's low 13 mantissa bits cleared) and lo = x - hi, two products
// (in f32 mode the taps split too, three). The tensor cores read lo as its
// TF32 truncation, so the dropped terms are < 2^-20 of sum |tap * d_conv|
// (2^-18 in f32 mode). The accumulators stay in registers over the CTA's
// tiles and go out as per-CTA partials (CTAs, 9, C). A second small
// kernel of the C entry sums the partials in CTA order. No float atomics:
// a step run twice gives the same bits.
//
// Rounding points (the TPU kernels'): in bf16 mode the image, the weights
// and the gradient are bf16, products and sums f32, every piece of the
// BatchNorm math f32; K10's tap operand is the bf16 image widened to f32.
// In f32 mode everything is f32. Products and sums outside the conv use _rn
// intrinsics, so no FMA contraction changes them against the plain version.
//
// Bounds on the H100 (fonts-small training, B 128, 32 x 128, C 64, bf16):
// K8 0.6 GFLOP of conv, ~0.6 us on the tensor cores, set by operations; K9
// and K10 read the image (1.05 MB) and the pooled gradient (16.8 MB), ~5.3
// us each, set by bytes. K1 in training ~5.3 us (its pooled output). K1 and
// K8 run the conv FMAs on the CUDA cores (67 TFLOP/s f32: ~9 us a pass).
// K9 and K10 keep z on the CUDA cores too, in the same conv9 as K1 and K8
// (bit-equal z), and are bound by instruction issue: a warp's pass (two
// pooled pixels, 64 channels) is the conv's 144 FMAs, the routing and the
// BatchNorm math, with 16 warps an SM (two CTAs, up to 128 registers).
// That keeps them 7-11x above their byte bound (PERF.md). Moving z onto the
// tensor cores moves K1, K8, K9 and K10 together. At fonts-hard's bucket
// 256 every figure doubles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCG = 8;         // K1: channels per thread
constexpr int kThreads = 256;  // K1: threads per block

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// The 4x4 patch under pooled pixel (h2, w2): rows 2*h2-1 .. 2*h2+2, cols
// 2*w2-1 .. 2*w2+2 of image `base` (H x W), zero outside.
template <typename T>
__device__ __forceinline__ void load_patch(const T* base, int h2, int w2,
                                           int H, int W, float p[4][4]) {
#pragma unroll
  for (int dy = 0; dy < 4; ++dy) {
    const int y = 2 * h2 - 1 + dy;
#pragma unroll
    for (int dx = 0; dx < 4; ++dx) {
      const int x = 2 * w2 - 1 + dx;
      p[dy][dx] = (y >= 0 && y < H && x >= 0 && x < W)
                      ? load_f(base + y * W + x)
                      : 0.f;
    }
  }
}

// z at window position (oy, ox): the 9-term sum, kh-major, one order for
// every kernel.
__device__ __forceinline__ float conv9(const float p[4][4], const float w[9],
                                       int oy, int ox) {
  float z = 0.f;
#pragma unroll
  for (int kh = 0; kh < 3; ++kh)
#pragma unroll
    for (int kw = 0; kw < 3; ++kw)
      z = fmaf(p[oy + kh][ox + kw], w[kh * 3 + kw], z);
  return z;
}

// The window's four z in the routing order (row 2i, col 2j), (2i, 2j+1),
// (2i+1, 2j), (2i+1, 2j+1).
__device__ __forceinline__ void conv_window(const float p[4][4],
                                            const float w[9], float z[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) z[k] = conv9(p, w, k >> 1, k & 1);
}

__device__ __forceinline__ float affine_relu(float z, float s, float b) {
  return fmaxf(__fadd_rn(__fmul_rn(z, s), b), 0.f);  // as z * s + b
}

// Max-pool's backward routes a window's pooled gradient to the first
// position, in (h, w) order, whose activation relu(z * s + b) equals the
// window's maximum; the ReLU then masks it unless that maximum is > 0.
// Returns that position (0-3), or -1 where the gradient is masked. The ReLU
// keeps the order of positive values, so where the maximum is > 0 the first
// position at the maximum before the ReLU is the one after it.
__device__ __forceinline__ int window_hit(const float z[4], float s,
                                          float b) {
  float a[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) a[k] = __fadd_rn(__fmul_rn(z[k], s), b);
  const float m = fmaxf(fmaxf(a[0], a[1]), fmaxf(a[2], a[3]));
  const int k = a[0] == m ? 0 : a[1] == m ? 1 : a[2] == m ? 2 : 3;
  return m > 0.f ? k : -1;
}

__device__ __forceinline__ void store8(float* dst, const float* v, bool vec,
                                       int n) {
  if (vec) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    for (int i = 0; i < n; ++i) dst[i] = v[i];
  }
}
__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float* v,
                                       bool vec, int n) {
  if (vec) {
    unsigned u[4];
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 pair = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      u[i] = *reinterpret_cast<unsigned*>(&pair);
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(u[0], u[1], u[2], u[3]);
  } else {
    for (int i = 0; i < n; ++i) dst[i] = __float2bfloat16(v[i]);
  }
}

// ---- K1 ----
// params: taps[9][C] (kh-major, then kw), scale[C], bias[C]; f32, taps
// already rounded to bf16 by the wrapper in bf16 mode.
template <typename T>
__global__ void __launch_bounds__(kThreads)
stem_kernel(const T* __restrict__ img, const float* __restrict__ params,
            T* __restrict__ out, int B, int H, int W, int C) {
  extern __shared__ float sp[];  // 11 * C floats
  for (int i = threadIdx.x; i < 11 * C; i += blockDim.x) sp[i] = params[i];
  __syncthreads();
  const float* taps = sp;
  const float* scale = sp + 9 * C;
  const float* bias = sp + 10 * C;

  const int H2 = H / 2, W2 = W / 2;
  const int G = (C + kCG - 1) / kCG;
  const bool vec = (C % kCG) == 0;
  const long long total = (long long)B * H2 * W2 * G;
  for (long long item = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       item < total; item += (long long)gridDim.x * blockDim.x) {
    const int g = (int)(item % G);
    long long pix = item / G;
    const int w2 = (int)(pix % W2);
    pix /= W2;
    const int h2 = (int)(pix % H2);
    const int b = (int)(pix / H2);

    float p[4][4];
    load_patch(img + (long long)b * H * W, h2, w2, H, W, p);

    const int c0 = g * kCG;
    const int n = min(kCG, C - c0);
    float res[kCG];
#pragma unroll
    for (int i = 0; i < kCG; ++i) {
      const int c = c0 + i;
      if (i >= n) {
        res[i] = 0.f;
        continue;
      }
      float w[9], z[4];
#pragma unroll
      for (int k = 0; k < 9; ++k) w[k] = taps[k * C + c];
      conv_window(p, w, z);
      const float s = scale[c], bb = bias[c];
      float m = 0.f;  // max(relu(.)) == relu(max(.))
#pragma unroll
      for (int k = 0; k < 4; ++k) m = fmaxf(m, affine_relu(z[k], s, bb));
      res[i] = m;
    }
    T* dst = out + (((long long)b * H2 + h2) * W2 + w2) * C + c0;
    store8(dst, res, vec, n);
  }
}

template <typename T>
cudaError_t launch_stem(const void* img, const float* params, void* out,
                        int B, int H, int W, int C, cudaStream_t stream) {
  const long long total =
      (long long)B * (H / 2) * (W / 2) * ((C + kCG - 1) / kCG);
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;  // grid-stride covers the rest
  const size_t smem = 11 * (size_t)C * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        stem_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  stem_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(img), params, static_cast<T*>(out), B, H, W, C);
  return cudaGetLastError();
}

// ---- K8 ----
// Thread (threadIdx.x, slot threadIdx.y) of a (CB, P) block owns channel
// c = blockIdx.y * CB + threadIdx.x (a thread past C reads channel C - 1
// and writes nothing). params, f32, each [C]: taps[9] (rounded to bf16 in
// bf16 mode), then for K9/K10 mean, inv, scale, bias, then for K10 c1, c2,
// c3.
constexpr int kRedThreads = 256;  // K8: threads per block

__device__ __forceinline__ int channel(int C) {
  return min((int)(blockIdx.y * blockDim.x + threadIdx.x), C - 1);
}

// Writes acc[0..K) of every thread to shared memory, then the slot-0
// threads sum the P slots in order and write the block's partials
// out[blockIdx.x][k][c].
template <int K>
__device__ __forceinline__ void block_partials(const float acc[K],
                                               float* __restrict__ out,
                                               int C) {
  extern __shared__ float red[];  // K * P * CB floats
  const int x = threadIdx.x, y = threadIdx.y, P = blockDim.y;
  const int CB = blockDim.x, c = blockIdx.y * CB + x;
#pragma unroll
  for (int k = 0; k < K; ++k) red[(k * P + y) * CB + x] = acc[k];
  __syncthreads();
  if (y == 0 && c < C) {
    float* dst = out + (size_t)blockIdx.x * K * C;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float s = 0.f;
      for (int i = 0; i < P; ++i) s = __fadd_rn(s, red[(k * P + i) * CB + x]);
      dst[k * C + c] = s;
    }
  }
}

// Pooled pixels of the batch in the grid-stride order; 32-bit indices (the
// wrapper checks B * H/2 * W/2 < 2^31), as 64-bit division costs several
// times the 36 FMAs of a window's conv.
struct PixIter {
  int pix, total, stride, H2, W2;
  __device__ PixIter(int B, int H, int W)
      : pix(blockIdx.x * blockDim.y + threadIdx.y),
        total(B * (H / 2) * (W / 2)), stride(gridDim.x * blockDim.y),
        H2(H / 2), W2(W / 2) {}
  __device__ bool more() const { return pix < total; }
  __device__ void next() { pix += stride; }
  __device__ int w2() const { return pix % W2; }
  __device__ int h2() const { return (pix / W2) % H2; }
  __device__ int b() const { return pix / (W2 * H2); }
};

template <typename T>
__global__ void __launch_bounds__(kRedThreads)
stats_kernel(const T* __restrict__ img, const float* __restrict__ params,
             float* __restrict__ out, int B, int H, int W, int C) {
  const int c = channel(C);
  float w[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) w[k] = params[k * C + c];
  float acc[2] = {0.f, 0.f};
  for (PixIter it(B, H, W); it.more(); it.next()) {
    float p[4][4], z[4];
    load_patch(img + (long long)it.b() * H * W, it.h2(), it.w2(), H, W, p);
    conv_window(p, w, z);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc[0] = __fadd_rn(acc[0], z[k]);
      acc[1] = __fadd_rn(acc[1], __fmul_rn(z[k], z[k]));
    }
  }
  block_partials<2>(acc, out, C);
}

// ---- K9, K10: tiles staged in shared memory ----
constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kChunk = 64;                   // channels a tile covers
constexpr int kCPT = 4;                      // channels a thread owns
constexpr int kTPP = kChunk / kCPT;          // threads a pooled pixel (16)
constexpr int kPPP = kBwdThreads / kTPP;     // pooled pixels a pass (16)
constexpr int kColCap = 128;                 // pooled columns a tile, at most
constexpr int kConstStride = 20;             // floats a channel's constants
constexpr int kConstFloats = kChunk * kConstStride;
// K10: a warp's two pixels of a pass, their 8 positions' d_conv rows (72
// floats, rows 4-7 shifted by 16: no bank conflicts on either side) after
// their two 4x4 patches
constexpr int kDcStride = kChunk + 8;
constexpr int kWarpFloats = 32 + 8 * kDcStride + 16;
static_assert(kPPP == 2 * kBwdWarps, "K10: two pixels a warp a pass");
static_assert(kBwdWarps * kWarpFloats >= kBwdWarps * 9 * kChunk,
              "K10's flush reuses the warps' buffers");

// The tiles of one K9/K10 launch (the wrapper's plan: `rows` pooled rows a
// tile, `col_tiles` column tiles). Tile i: chunk i / spatial, then image,
// row tile and column tile, the column tile fastest.
struct Tiling {
  int H2, W2, rows, col_tiles, row_tiles, spatial, tiles;
  __host__ __device__ Tiling(int B, int H, int W, int C, int rows_, int ct)
      : H2(H / 2), W2(W / 2), rows(rows_), col_tiles(ct),
        row_tiles((H / 2 + rows_ - 1) / rows_),
        spatial(B * ((H / 2 + rows_ - 1) / rows_) * ct),
        tiles(B * ((H / 2 + rows_ - 1) / rows_) * ct *
              ((C + kChunk - 1) / kChunk)) {}
  __host__ __device__ int max_cols() const {
    return (W2 + col_tiles - 1) / col_tiles;
  }
  // floats of the staged band: (2 rows + 2) x (2 columns + 2)
  __host__ __device__ int band_floats() const {
    return (2 * rows + 2) * (2 * max_cols() + 2);
  }
};

// Dynamic shared memory: the band, the chunk's constants, then K10's warp
// buffers or K9's reduction scratch.
inline int bwd_smem_bytes(const Tiling& t, bool final_pass) {
  const int extra = final_pass ? kBwdWarps * kWarpFloats
                               : kBwdWarps * 2 * kChunk;
  return (t.band_floats() + kConstFloats + extra) * (int)sizeof(float);
}

struct Tile {
  int b, r0, nr, c0, tw, chunk;
  __device__ Tile(const Tiling& t, int i) {
    chunk = i / t.spatial;
    int s = i - chunk * t.spatial;
    const int ct = s % t.col_tiles;
    s /= t.col_tiles;
    const int rt = s % t.row_tiles;
    b = s / t.row_tiles;
    r0 = rt * t.rows;
    nr = min(t.rows, t.H2 - r0);
    c0 = ct * t.W2 / t.col_tiles;
    tw = (ct + 1) * t.W2 / t.col_tiles - c0;
  }
};

// Row of chunk channel ch in the constants: a thread's channel pairs
// (2 cg + 32 i, + 1) sit in rows cg + 16 i and cg + 16 i + 32, so the 16
// threads of a pixel read 16 consecutive rows.
__device__ __forceinline__ int const_row(int ch) {
  return (ch >> 1) + (ch & 1) * (kChunk / 2);
}

// K9's and K10's f32 operands: tap k = kh * 3 + kw of channel c at
// taps[k * tap_k + c * tap_c] (the HWIO weights, or their OIHW storage
// seen through a permute, without a copy), then the per-channel vectors
// mean, inv, scale, bias and, for K10, c1, c2, c3, each [C].
struct BwdOperands {
  const float* taps;
  int tap_k, tap_c;
  const float* vec[7];
};

// The chunk's per-channel constants into shared memory, channel ch's at
// consts[const_row(ch) * kConstStride + k]: k 0-8 its taps (rounded to
// bf16 in bf16 mode, as the conv's operands), then mean, inv, scale, bias
// and, for K10, c1, c2, c3. A channel past C takes channel C - 1's;
// nothing of it is written.
template <typename T, bool kFinal>
__device__ __forceinline__ void load_consts(const BwdOperands op,
                                            float* consts, int C,
                                            int chunk) {
  for (int i = threadIdx.x; i < kChunk * 9; i += kBwdThreads) {
    const int ch = i / 9, k = i - ch * 9;
    const int c = min(chunk * kChunk + ch, C - 1);
    float v = op.taps[k * op.tap_k + c * op.tap_c];
    if (sizeof(T) == 2) v = __bfloat162float(__float2bfloat16(v));
    consts[const_row(ch) * kConstStride + k] = v;
  }
#pragma unroll
  for (int j = 0; j < (kFinal ? 7 : 4); ++j)
    for (int ch = threadIdx.x; ch < kChunk; ch += kBwdThreads)
      consts[const_row(ch) * kConstStride + 9 + j] =
          op.vec[j][min(chunk * kChunk + ch, C - 1)];
}

// x = hi + lo exactly, hi TF32 (x's low 13 mantissa bits cleared) and
// |lo| < 2^-10 |x|. The tensor cores read a TF32 operand's top 19 bits, so
// lo enters the product as its own truncation: the product's error is
// < 2^-20 |tap * x|.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Row r (< 8) of a warp's d_conv buffer.
__device__ __forceinline__ int dc_row(int r) {
  return r * kDcStride + (r >> 2) * 16;
}

// K10's product for one warp's pass: d_w[tap][c] += sum over its two
// pixels' 8 positions of tap * d_conv, for the chunk's 64 channels (8
// n-tiles). A (16 x 8, row-major) is taps x positions: row m < 9 is tap
// (m / 3, m % 3), rows 9-15 zero; position k is window position k % 4 of
// pixel k / 4, whose tap m is patch element (k % 4 / 2 + m / 3) * 4 +
// k % 2 + m % 3. B (8 x 8, column-major) is d_conv[k][c]: n-tile 2 j + e
// takes channels 16 j + 2 n + e (n < 8), so one 8-byte load gives a lane
// its B elements of two n-tiles. Fragments (PTX ISA, mma.m16n8k8 .tf32):
// lane = 4 g + t holds A (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4),
// B (t, g) and (t + 4, g), C (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1).
template <bool kSplitTaps>
__device__ __forceinline__ void dw_warp(const float* patches,
                                        const float* dc, float acc[8][4]) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int off = ((t >> 1) + g / 3) * 4 + (t & 1) + g % 3;  // tap g
  const int off8 = ((t >> 1) + 2) * 4 + (t & 1) + 2;         // tap 8
  const float a[4] = {patches[off], g == 0 ? patches[off8] : 0.f,
                      patches[16 + off], g == 0 ? patches[16 + off8] : 0.f};
  uint32_t ah[4], al[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (kSplitTaps)
      split_tf32(a[i], ah[i], al[i]);
    else  // bf16 values: exact in TF32
      ah[i] = __float_as_uint(a[i]);
  }
  const float* b0 = dc + dc_row(t) + 2 * g;
  const float* b1 = dc + dc_row(t + 4) + 2 * g;
#pragma unroll
  for (int j = 0; j < kChunk / 16; ++j) {
    const float2 v0 = *reinterpret_cast<const float2*>(b0 + 16 * j);
    const float2 v1 = *reinterpret_cast<const float2*>(b1 + 16 * j);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      uint32_t bh[2], bl[2];
      split_tf32(e ? v0.y : v0.x, bh[0], bl[0]);
      split_tf32(e ? v1.y : v1.x, bh[1], bl[1]);
      float* d = acc[2 * j + e];
      if (kSplitTaps) mma_tf32(d, al, bh);
      mma_tf32(d, ah, bl);
      mma_tf32(d, ah, bh);
    }
  }
}

// K9's flush: the thread's sums of one chunk into the CTA's partials, in a
// fixed order (lanes l and l ^ 16 share channels; then warps 0-7).
__device__ __forceinline__ void flush_sums(float acc[kCPT][2], float* red,
                                           float* part, int C, int chunk) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
#pragma unroll
  for (int i = 0; i < kCPT; ++i)
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float v = __fadd_rn(acc[i][k],
                                __shfl_xor_sync(0xffffffffu, acc[i][k], 16));
      if (lane < 16)
        red[(warp * 2 + k) * kChunk + 2 * lane + 32 * (i >> 1) + (i & 1)] = v;
      acc[i][k] = 0.f;
    }
  __syncthreads();
  if (tid < 2 * kChunk) {
    const int k = tid / kChunk, ch = tid % kChunk, c = chunk * kChunk + ch;
    float s = 0.f;
    for (int w = 0; w < kBwdWarps; ++w)
      s = __fadd_rn(s, red[(w * 2 + k) * kChunk + ch]);
    if (c < C) part[k * C + c] = s;
  }
  __syncthreads();
}

// K10's flush: the warps' accumulators of one chunk summed in a fixed
// order (warps 0-7) into the CTA's partials, through shared memory.
__device__ __forceinline__ void flush_dw(float acc[8][4], float* red,
                                         float* part, int C, int chunk) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane >> 2, t = lane & 3;
  __syncthreads();  // every warp's last pass is done with its buffer
#pragma unroll
  for (int j = 0; j < kChunk / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tap = g + (i >> 1) * 8;
      const int ch = 16 * (j >> 1) + 4 * t + 2 * (i & 1) + (j & 1);
      if (tap < 9) red[(warp * 9 + tap) * kChunk + ch] = acc[j][i];
      acc[j][i] = 0.f;
    }
  __syncthreads();
  for (int o = tid; o < 9 * kChunk; o += kBwdThreads) {
    const int tap = o / kChunk, ch = o % kChunk, c = chunk * kChunk + ch;
    float s = 0.f;
    for (int w = 0; w < kBwdWarps; ++w)
      s = __fadd_rn(s, red[(w * 9 + tap) * kChunk + ch]);
    if (c < C) part[tap * C + c] = s;
  }
}

// Channels c0 + 32 (j / 2) + j % 2 (j < kCPT) of pooled pixel (r, x) of a
// tile whose gradient starts at gt, zeros past the tile (q >= npix) and
// past C.
template <typename T>
__device__ __forceinline__ void load_gv(const T* gt, int q, int npix, int r,
                                        int x, int W2, int C, int c0,
                                        float v[kCPT]) {
  const T* p = gt + ((size_t)r * W2 + x) * C;
#pragma unroll
  for (int j = 0; j < kCPT; ++j) {
    const int o = 32 * (j >> 1) + (j & 1);
    v[j] = q < npix && c0 + o < C ? load_f(p + o) : 0.f;
  }
}

// Thread (slot, cg) of a pass owns pooled pixel q0 + slot and the chunk's
// channel pairs (2 cg + 32 i, + 1), i < 2: its channel j < 4 is
// 2 cg + 32 (j / 2) + j % 2.
template <typename T, bool kFinal>
__global__ void __launch_bounds__(kBwdThreads, 2)
bwd_tile_kernel(const T* __restrict__ img, const T* __restrict__ g,
                const BwdOperands op, float* __restrict__ out, int B, int H,
                int W, int C, int rows, int col_tiles) {
  constexpr int K = kFinal ? 9 : 2;
  extern __shared__ __align__(16) float smem[];
  const Tiling tl(B, H, W, C, rows, col_tiles);
  float* band = smem;
  float* consts = smem + tl.band_floats();
  float* extra = consts + kConstFloats;
  const int tid = threadIdx.x, cg = tid % kTPP, slot = tid / kTPP;

  // the CTA's partials start at zero: a chunk none of its tiles covers
  float* part = out + (size_t)blockIdx.x * K * C;
  for (int i = tid; i < K * C; i += kBwdThreads) part[i] = 0.f;

  float sums[kCPT][2] = {};
  float acc[kChunk / 8][4] = {};  // K10: the product's accumulators
  int chunk = -1;
  for (int ti = blockIdx.x; ti < tl.tiles; ti += gridDim.x) {
    const Tile t(tl, ti);
    __syncthreads();  // the previous tile's reads of band and consts are done
    if (t.chunk != chunk) {
      if (chunk >= 0) {
        if constexpr (kFinal)
          flush_dw(acc, extra, part, C, chunk);
        else
          flush_sums(sums, extra, part, C, chunk);
        __syncthreads();
      }
      chunk = t.chunk;
      load_consts<T, kFinal>(op, consts, C, chunk);
    }
    // stage the band: image rows 2 r0 - 1 .. 2 (r0 + nr), columns
    // 2 c0 - 1 .. 2 (c0 + tw), zero outside the image
    const int bw = 2 * t.tw + 2;
    const T* im = img + (size_t)t.b * H * W;
    const int y0 = 2 * t.r0 - 1, x0 = 2 * t.c0 - 1;
    for (int i = tid; i < (2 * t.nr + 2) * bw; i += kBwdThreads) {
      const int yy = i / bw, y = y0 + yy, x = x0 + i - yy * bw;
      band[i] = (y >= 0 && y < H && x >= 0 && x < W)
                    ? load_f(im + (size_t)y * W + x) : 0.f;
    }
    __syncthreads();

    const int npix = t.nr * t.tw, c0 = chunk * kChunk + 2 * cg;
    const T* gt = g + (((size_t)t.b * tl.H2 + t.r0) * tl.W2 + t.c0) * C + c0;
    // pooled pixel q of the tile at row r, column x (q = r * tw + x); the
    // next pass's pixel q + kPPP at (rn, xn)
    int r = slot / t.tw, x = slot - r * t.tw, rn = r, xn = x;
    float gnext[kCPT];
    load_gv(gt, slot, npix, r, x, tl.W2, C, c0, gnext);
    for (int q0 = 0; q0 < npix; q0 += kPPP) {
      const int q = q0 + slot;
      const bool valid = q < npix;
      r = rn, x = xn;
      for (xn += kPPP; xn >= t.tw; xn -= t.tw) ++rn;
      float gv[kCPT];
#pragma unroll
      for (int i = 0; i < kCPT; ++i) gv[i] = gnext[i];
      // the next pass's, in flight meanwhile
      load_gv(gt, q + kPPP, npix, rn, xn, tl.W2, C, c0, gnext);
      const float* pb = band + (valid ? 2 * r * bw + 2 * x : 0);
      float p[4][4];
#pragma unroll
      for (int dy = 0; dy < 4; ++dy)
#pragma unroll
        for (int dx = 0; dx < 4; ++dx) p[dy][dx] = pb[dy * bw + dx];
      // K10: this warp's buffer, pixel slot & 1 of its two
      float* patches = extra + (tid / 32) * kWarpFloats;
      float* dc = patches + 32;
      const int half = slot & 1;
      float dprev[4];  // K10: d_conv of the pair's first channel
      if constexpr (kFinal) {
        __syncwarp();  // the warp's previous product is done with it
        // a pixel past the tile gets a zero patch, so its d_conv adds 0
        patches[half * 16 + cg] = valid ? pb[(cg >> 2) * bw + (cg & 3)] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kCPT; ++i) {
        const float4* cq = reinterpret_cast<const float4*>(
            consts + (cg + 16 * (i >> 1) + 32 * (i & 1)) * kConstStride);
        const float4 u0 = cq[0], u1 = cq[1], u2 = cq[2];
        const float w[9] = {u0.x, u0.y, u0.z, u0.w, u1.x,
                            u1.y, u1.z, u1.w, u2.x};
        const float mean = u2.y, inv = u2.z, sc = u2.w;
        const float4 u3 = cq[3];  // bias, c1, c2, c3
        float z[4];
        conv_window(p, w, z);
        const int hit = window_hit(z, sc, u3.x);
        if constexpr (!kFinal) {
          // d and d * xhat at the hit only: the other terms are exact zeros
          // (gv is 0 past the tile's pixels and past C)
          const float zh = hit == 1 ? z[1] : hit == 2 ? z[2]
                           : hit == 3 ? z[3] : z[0];
          const float d = hit >= 0 ? gv[i] : 0.f;
          const float xh = __fmul_rn(__fsub_rn(zh, mean), inv);
          sums[i][0] = __fadd_rn(sums[i][0], d);
          sums[i][1] = __fadd_rn(sums[i][1], __fmul_rn(d, xh));
        } else {
          // d - c2: gv - c2 at the hit, exactly -c2 elsewhere
          const float dh = __fsub_rn(gv[i], u3.z), d0 = -u3.z;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float xh = __fmul_rn(__fsub_rn(z[k], mean), inv);
            // c1 * ((d - c2) - xhat * c3)
            const float v = __fmul_rn(
                u3.y, __fsub_rn(k == hit ? dh : d0, __fmul_rn(xh, u3.w)));
            if (i & 1)
              *reinterpret_cast<float2*>(dc + dc_row(4 * half + k) + 2 * cg +
                                         32 * (i >> 1)) =
                  make_float2(dprev[k], v);
            else
              dprev[k] = v;
          }
        }
      }
      if constexpr (kFinal) {
        __syncwarp();  // the warp's patches and d_conv are written
        dw_warp<sizeof(T) == 4>(patches, dc, acc);
      }
    }
  }
  if (chunk >= 0) {
    if constexpr (kFinal)
      flush_dw(acc, extra, part, C, chunk);
    else
      flush_sums(sums, extra, part, C, chunk);
  }
}

template <typename T>
const void* bwd_fn(bool final_pass) {
  return final_pass ? (const void*)bwd_tile_kernel<T, true>
                    : (const void*)bwd_tile_kernel<T, false>;
}

const void* bwd_fn(int bf16, int final_pass) {
  return bf16 ? bwd_fn<__nv_bfloat16>(final_pass) : bwd_fn<float>(final_pass);
}

cudaError_t allow_smem(const void* fn, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// out[j] = sum over r < rows of parts[r][j], r in order: thread (x, y) of
// a (32, 8) block sums rows y, y + 8, ... of column 32 blockIdx.x + x, then
// thread (x, 0) adds the 8 in order.
__global__ void __launch_bounds__(256)
sum_rows_kernel(const float* __restrict__ parts, float* __restrict__ out,
                int rows, int n) {
  __shared__ float red[8][32];
  const int x = threadIdx.x % 32, y = threadIdx.x / 32;
  const int j = blockIdx.x * 32 + x;
  float s = 0.f;
  if (j < n)
    for (int r = y; r < rows; r += 8)
      s = __fadd_rn(s, parts[(size_t)r * n + j]);
  red[y][x] = s;
  __syncthreads();
  if (y == 0 && j < n) {
    float t = red[0][x];
    for (int i = 1; i < 8; ++i) t = __fadd_rn(t, red[i][x]);
    out[j] = t;
  }
}

template <typename T>
cudaError_t launch_bwd(const void* img, const void* g, const BwdOperands& op,
                       float* parts, float* out, int B, int H, int W, int C,
                       bool final_pass, int rows, int col_tiles, int ctas,
                       int smem, cudaStream_t s) {
  const T* im = static_cast<const T*>(img);
  const T* gg = static_cast<const T*>(g);
  if (final_pass)
    bwd_tile_kernel<T, true><<<ctas, kBwdThreads, smem, s>>>(
        im, gg, op, parts, B, H, W, C, rows, col_tiles);
  else
    bwd_tile_kernel<T, false><<<ctas, kBwdThreads, smem, s>>>(
        im, gg, op, parts, B, H, W, C, rows, col_tiles);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int n = (final_pass ? 9 : 2) * C;
  sum_rows_kernel<<<(n + 31) / 32, 256, 0, s>>>(parts, out, ctas, n);
  return cudaGetLastError();
}

// blocks x ceil(C / CB) blocks of (CB, P) threads, CB = min(C, 256),
// P = 256 / CB; K * 256 floats of shared memory for the reduction.
struct RedLaunch {
  dim3 grid, block;
  size_t smem;
  RedLaunch(int blocks, int C, int K) {
    const int CB = min(C, kRedThreads), P = kRedThreads / CB;
    grid = dim3(blocks, (C + CB - 1) / CB);
    block = dim3(CB, P);
    smem = (size_t)K * CB * P * sizeof(float);
  }
};

}  // namespace

// bf16: img and out are bf16 (1) or f32 (0).
extern "C" int crnn_fused_stem_serve(const void* img, const void* params,
                                     void* out, int B, int H, int W, int C,
                                     int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* prm = static_cast<const float*>(params);
  const cudaError_t e =
      bf16 ? launch_stem<__nv_bfloat16>(img, prm, out, B, H, W, C, s)
           : launch_stem<float>(img, prm, out, B, H, W, C, s);
  return (int)e;
}

// K8: out (blocks, 2, C) f32 partial [sum z, sum z^2]. `blocks` along the
// pixels (each block's P slots stride over them).
extern "C" int crnn_stem_stats(const void* img, const void* params, void* out,
                               int B, int H, int W, int C, int bf16,
                               int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RedLaunch L(blocks, C, 2);
  const float* prm = static_cast<const float*>(params);
  float* o = static_cast<float*>(out);
  if (bf16)
    stats_kernel<__nv_bfloat16><<<L.grid, L.block, L.smem, s>>>(
        static_cast<const __nv_bfloat16*>(img), prm, o, B, H, W, C);
  else
    stats_kernel<float><<<L.grid, L.block, L.smem, s>>>(
        static_cast<const float*>(img), prm, o, B, H, W, C);
  return (int)cudaGetLastError();
}

// K9 (final = 0): out (2, C) [sum d, sum d * xhat].
// K10 (final = 1): out (9, C) d_w, rows kh * 3 + kw.
// parts: (ctas, 2 or 9, C) f32 scratch for the CTAs' partials, which a
// second kernel sums in CTA order into out.
// g: the pooled gradient (B, H/2, W/2, C), in the image's dtype. taps: f32,
// tap kh * 3 + kw of channel c at taps[k * tap_k + c * tap_c]; mean, inv,
// scale, bias and (K10) c1, c2, c3: f32 [C] each (c1-c3 null for K9). The
// plan (fused_stem_train.py::bwd_plan): `rows` pooled rows a tile,
// `col_tiles` column tiles, `ctas` CTAs and `smem` bytes of dynamic shared
// memory, which must be what this file computes for that plan (else
// cudaErrorInvalidValue).
extern "C" int crnn_stem_bwd(const void* img, const void* g, const void* taps,
                             int tap_k, int tap_c, const void* mean,
                             const void* inv, const void* scale,
                             const void* bias, const void* c1, const void* c2,
                             const void* c3, void* parts, void* out, int B,
                             int H, int W, int C, int bf16, int final_pass,
                             int rows, int col_tiles, int ctas, int smem,
                             void* stream) {
  const Tiling tl(B, H, W, C, rows, col_tiles);
  if (rows < 1 || col_tiles < 1 || ctas < 1 ||
      (W / 2 + col_tiles - 1) / col_tiles > kColCap ||
      smem != bwd_smem_bytes(tl, final_pass))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(bwd_fn(bf16, final_pass), smem);
  if (e != cudaSuccess) return (int)e;
  const BwdOperands op{static_cast<const float*>(taps), tap_k, tap_c,
                       {static_cast<const float*>(mean),
                        static_cast<const float*>(inv),
                        static_cast<const float*>(scale),
                        static_cast<const float*>(bias),
                        static_cast<const float*>(c1),
                        static_cast<const float*>(c2),
                        static_cast<const float*>(c3)}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(parts);
  float* o = static_cast<float*>(out);
  e = bf16 ? launch_bwd<__nv_bfloat16>(img, g, op, pt, o, B, H, W, C,
                                       final_pass, rows, col_tiles, ctas,
                                       smem, s)
           : launch_bwd<float>(img, g, op, pt, o, B, H, W, C, final_pass,
                               rows, col_tiles, ctas, smem, s);
  return (int)e;
}

// The K9 (final = 0) or K10 CTAs one SM holds at `smem` bytes of dynamic
// shared memory, into *ctas.
extern "C" int crnn_stem_bwd_ctas_per_sm(int bf16, int final_pass, int smem,
                                         int* ctas) {
  const void* fn = bwd_fn(bf16, final_pass);
  cudaError_t e = allow_smem(fn, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, fn, kBwdThreads, smem);
}

extern "C" const char* crnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
