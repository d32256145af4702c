// The stem, serving and training: conv3x3 (1 -> C) + BatchNorm + ReLU +
// maxpool 2x2, without the full-resolution activation in device memory.
//
// K1  maxpool2x2(relu(z * scale + bias)), NHWC out. Replaces
//     crnn_ocr_tpu/kernels/fused_stem.py::fused_stem_serve (_stem_kernel).
//     Serving folds BatchNorm's running statistics into (scale, bias);
//     training feeds it the batch statistics from K8. Two designs:
//     "mma", stem_mma_kernel<bf16, false>, serves bf16; "conv9",
//     stem_kernel, serves f32 and runs the training forward in both dtypes.
// K8  stem_mma_kernel<T, true>: per-channel sums of z and z^2 over the
//     batch. Replaces kernels/fused_stem_train.py::_run_stats
//     (_stats_kernel).
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
// Which call computes z where. K9 and K10 route the pooled gradient to the
// first maximum of the training forward's window by recomputing z, and a
// different sum order could move a tie or a first maximum between passes.
// So K1's training call (stem_kernel, from load_patch) and K9 and K10 (from
// the staged band) compute z with one function, conv9: 9 f32 FMAs,
// kh-major, on the CUDA cores, on the same patch values. Two calls need no
// such bits, and take z from the tensor cores, as the TPU kernels take it
// from the MXU (fused_stem.py:140-142, fused_stem_train.py:104-108): K8,
// whose z enters only its sums (held to 1e-5 of the sum of their terms'
// magnitudes; the mean and var they give reach K1, K9 and K10 as one
// tensor), and K1's bf16 serving call, which feeds no backward pass. K1's
// f32 serving call stays on stem_kernel.
//
// The window tile (K8, K1's serving call): one warp computes z of 8 pooled
// pixels at their four window positions, 8 channels a product, with
// mma.sync m16n8k16 in bf16 (bf16 x bf16 products are exact in f32, the
// accumulator is f32: z differs from conv9's chain only by the rounding of
// the 9-term sum, as the MXU's product does). M is two tiles of 16 rows:
// in m-tile m, rows 0-7 are window position 2m of pixels 0-7, rows 8-15
// position 2m + 1. K is the 9 taps, kh-major, padded to 16 with zeros. N
// is 8 channels, 8 products a 64-channel chunk, whose B fragments (the
// taps, rounded to bf16) load once a chunk and stay in registers. By the
// fragment layouts lane (g, t) then holds z of all four positions of
// pixel g for channels 2t and 2t + 1 of each product, so K1's max-pool and
// K8's sums stay in registers with no shuffle a pixel, and its A fragment
// is taps 2t, 2t + 1 (and 8 for t = 0) of pixel g's patch, read from the
// staged band as bits and paired by a byte permute. In f32 mode (K8 only)
// the same tile runs mma.sync m16n8k8 in TF32 over two k-steps with every
// operand split hi + lo (split_tf32), three products a k-step; the dropped
// terms are < 2^-18 of sum |tap * x|.
//
// Tiles (K1's serving call, K8, K9, K10): a persistent grid of one wave
// (the wrapper's plan, _stem_tiles.py::stem_plan and fused_stem_train.py::
// bwd_plan: min(tiles, the CTAs the card holds)) walks tiles in a static
// order (tile blockIdx.x, + gridDim.x, ...). A tile is one image's band of
// `rows` pooled rows by one column tile (the pooled columns in `col_tiles`
// near-equal runs of at most kColCap) by one chunk of kChunk channels. The
// CTA stages the band's 2 rows + 2 image rows with the SAME zero halo
// written in, so patch reads are shared-memory loads without bounds
// checks: K9 and K10 widened to f32; K1 and K8 as raw image elements by
// cp.async, the next tile's band in flight while the CTA works on this one
// (stage_band_async, two buffers).
//
// K1 (mma): the taps carry the sign of the channel's scale, so the max of
// the four positions comes first (rounding is monotone: the max of the four
// affines is the affine of the max), then the affine by |scale| and the
// bias, the bf16 pack and the ReLU on the pair; the pairs are staged in the
// warp's own shared-memory buffer and stored 16 bytes a lane (8 channels of
// one pixel). K8: z and z^2 added into f32 registers over the CTA's tiles;
// then, in a fixed order, the lane groups by shuffles, the warps through
// shared memory, per-CTA partials (CTAs, 2, C), and a second kernel of the
// C entry (sum_rows_kernel) adds the CTAs in order.
//
// K9 and K10: a thread owns (pooled pixel, kCPT channels) of the tile; the
// chunk's taps and BatchNorm vectors sit in shared memory, 20 floats a
// channel. It reads the 4x4 patch once for its channels (the 16 threads of
// a pixel broadcast), each channel's constants as four 16-byte loads
// without bank conflicts, the pooled gradient with the next pass's loads in
// flight, and recomputes z with conv9. Routing and sums are branch-free.
// K9 adds d and d * xhat at the hit position only (the other three are
// exact zeros), then reduces its sums by warp shuffle and shared memory in
// a fixed order into per-CTA partials (CTAs, 2, C). K10 writes each pass's
// d_conv and patches to its warp's own buffer (no CTA barrier a pass: a
// warp multiplies only its own two pixels' 8 positions) and runs
// d_w[tap][c] += sum tap * d_conv with mma.sync.m16n8k8 in TF32: A the
// taps (M 16 = 9 taps padded, exact in TF32 in bf16 mode), B d_conv split
// into hi (x's low 13 mantissa bits cleared) and lo = x - hi, two products
// (in f32 mode the taps split too, three). The tensor cores read lo as its
// TF32 truncation, so the dropped terms are < 2^-20 of sum |tap * d_conv|
// (2^-18 in f32 mode). The accumulators stay in registers over the CTA's
// tiles and go out as per-CTA partials (CTAs, 9, C), summed in CTA order
// by sum_rows_kernel. No float atomics in K1, K8, K9 or K10: a call run
// twice gives the same bits.
//
// Rounding points (the TPU kernels'): in bf16 mode the image, the weights
// and the gradient are bf16, products and sums f32, every piece of the
// BatchNorm math f32; K10's tap operand is the bf16 image widened to f32.
// In f32 mode everything is f32. Products and sums outside the conv use _rn
// intrinsics, so no FMA contraction changes them against the plain version.
//
// Bounds on the H100. K1 serving fonts-hard (bf16, B 256, 32 x 256, C 64)
// writes 67.1 MB of pooled output: 21 us, set by bytes. Its conv is 1.21 G
// FMAs: >= 41 us on the CUDA cores (~29.6 T f32 lane-ops/s), 2.4 us on the
// tensor cores; on the window tile what remains on the CUDA cores is ~8
// instructions a pooled (pixel, channel): the max, the affine, the pack and
// the ReLU; the band's staging overlaps the previous tile's work.
// K8 at fonts-small's training shape (bf16, B 128, 32 x 128, C 64) reads
// 1.05 MB (0.3 us) and does 0.6 GFLOP of conv (0.6 us on the tensor cores):
// set by operations; on the window tile an add and an FMA remain a
// (position, channel). K9 and K10 read the image (1.05 MB) and the pooled
// gradient (16.8 MB), ~5.3 us each, set by bytes, and are bound by
// instruction issue: a warp's pass (two pooled pixels, 64 channels) is
// conv9's 144 FMAs, the routing and the BatchNorm math, with 16 warps an SM
// (two CTAs, up to 128 registers), 7-11x above their byte bound (PERF.md).
// Moving their z onto the tensor cores moves K1's training call, K9 and
// K10 together. At fonts-hard's bucket 256 every training figure doubles.

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

// ---- K1's bf16 serving call and K8: the window tile on the tensor cores ----
constexpr int kFwdThreads = 256;
constexpr int kFwdWarps = kFwdThreads / 32;
constexpr int kWinPix = 8;            // pooled pixels of a window tile
constexpr int kNTiles = kChunk / 8;   // products (8 channels each) a chunk
// K1's staging of a window tile's output: a pixel's kChunk bf16 channels in
// 32 words plus 4 (pixel g's word 4 n + t sits in bank 4 g + 4 n + t: no
// conflicts)
constexpr int kPixWords = kChunk / 2 + 4;
constexpr int kStageWords = kWinPix * kPixWords;
// shared memory after the band: K1's scale and bias, then the warps'
// staging buffers; K8's warps' sums
constexpr int kServeFloats = 2 * kChunk + kFwdWarps * kStageWords;
constexpr int kStatsFloats = kFwdWarps * 2 * kChunk;

// K1's and K8's bands: two (one tile's and the next one's, in flight),
// each of raw image elements, (2 rows + 2) x (2 columns + 4): one more
// column on each side than K9's and K10's, so that a row starts at an even
// image column (cp.async's 4-byte granules lie wholly in or out of a bf16
// image of even width)
__host__ __device__ inline int fwd_band_elems(const Tiling& t) {
  return (2 * t.rows + 2) * (2 * t.max_cols() + 4);
}

__host__ __device__ inline int fwd_band_bytes(const Tiling& t,
                                              int elem) {
  return (2 * fwd_band_elems(t) * elem + 15) / 16 * 16;
}

inline int fwd_smem_bytes(const Tiling& t, bool stats, int elem) {
  return fwd_band_bytes(t, elem) +
         (stats ? kStatsFloats : kServeFloats) * (int)sizeof(float);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool fill) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(fill ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Puts tile t's band in flight into `band` by cp.async and commits it as
// one group: image rows 2 r0 - 1 .. 2 (r0 + nr), columns 2 c0 - 2 ..
// 2 (c0 + tw) + 1, row stride 2 tw + 4, zeros outside the image (a
// granule's source size 0). Returns the row stride.
template <typename T>
__device__ __forceinline__ int stage_band_async(const T* __restrict__ img,
                                                const Tile& t, int H, int W,
                                                T* band) {
  constexpr int kPer = 4 / sizeof(T);  // elements a 4-byte granule
  const int bw = 2 * t.tw + 4, per_row = bw / kPer;
  const T* im = img + (size_t)t.b * H * W;
  const int y0 = 2 * t.r0 - 1, x0 = 2 * t.c0 - 2;
  for (int i = threadIdx.x; i < (2 * t.nr + 2) * per_row; i += kFwdThreads) {
    const int yy = i / per_row, k = i - yy * per_row;
    const int y = y0 + yy, x = x0 + kPer * k;
    const bool in = y >= 0 && y < H && x >= 0 && x < W;
    cp_async4(band + yy * bw + kPer * k, in ? im + (size_t)y * W + x : img,
              in);
  }
  cp_async_commit();
  return bw;
}

// K8's and K1's operands: tap k = kh * 3 + kw of channel c at taps[k *
// tap_k + c * tap_c], f32 (the HWIO weights, or their OIHW storage seen
// through a permute); K1's folded BatchNorm scale and bias, f32 [C] each.
struct StemOperands {
  const float* taps;
  int tap_k, tap_c;
  const float* scale;
  const float* bias;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two bf16's bits (each in a low half) as a pair: one byte permute.
__device__ __forceinline__ uint32_t pair_bf16(uint32_t lo, uint32_t hi) {
  return __byte_perm(lo, hi, 0x5410);
}

__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The window tile. Lane (g, t) = (lane / 4, lane % 4) of a warp loads, for
// pooled pixel g of the warp's 8, the values of taps ja, jb and (t = 0
// only) 8 at window positions 0-3: v[k][0..2] (window_values). In A, row
// 8 i + g of m-tile m is position 2 m + i of pixel g and the columns are
// the 9 taps padded to 16 with zeros; B's row is a tap and its column one
// of the product's 8 channels. With mma's fragment layouts (PTX ISA:
// A (row g or g + 8, columns by t), B (rows by t, column g), C (g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)) the lane's accumulators are
// z of all four positions of pixel g for channels 2t and 2t + 1 of the
// product: position 2 m + i, channel 2 t + e in d[m][2 i + e].

// bf16 mode: mma.m16n8k16, lane t's A and B columns 2t, 2t + 1, 2t + 8,
// 2t + 9, so its taps 2t, 2t + 1 and 8 (t = 0). The operands are bf16 (the
// image's values, packed as they are; the taps rounded to bf16 as the
// wrappers round them), so every product is exact in f32.
struct WinBf16 {
  static constexpr int kTapA = 2, kTapStep = 1;  // ja = 2t, jb = ja + 1
  uint32_t a[2][4];           // A: m-tile, register
  uint32_t b[kNTiles][2];     // B: product, register
  __device__ __forceinline__ void set_a(const uint32_t v[4][3]) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        a[m][i] = pair_bf16(v[2 * m + i][0], v[2 * m + i][1]);
        a[m][2 + i] = v[2 * m + i][2];
      }
  }
  __device__ __forceinline__ void set_b(int n, float wa, float wb,
                                        float w8) {
    b[n][0] = pack_bf16(wa, wb);
    b[n][1] = pack_bf16(w8, 0.f);
  }
  __device__ __forceinline__ void z(int n, float d[2][4]) const {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      d[m][0] = d[m][1] = d[m][2] = d[m][3] = 0.f;
      mma_bf16(d[m], a[m], b[n]);
    }
  }
};

// f32 mode (K8): mma.m16n8k8 in TF32 over two k-steps, taps 0-7, then 8
// and zeros; lane t's columns t and t + 4, so its taps t, t + 4 and 8
// (t = 0). Every operand is split hi + lo (split_tf32), three products a
// k-step (lo * hi, hi * lo, hi * hi): the dropped terms are < 2^-18 of
// sum |tap * x|.
struct WinTf32 {
  static constexpr int kTapA = 1, kTapStep = 4;  // ja = t, jb = ja + 4
  uint32_t ah[2][2][4], al[2][2][4];  // A: m-tile, k-step, register
  uint32_t bh[kNTiles][3], bl[kNTiles][3];  // B: k-step 0's two, 1's one
  __device__ __forceinline__ void set_a(const uint32_t v[4][3]) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const uint32_t x[2][4] = {
          {v[2 * m][0], v[2 * m + 1][0], v[2 * m][1], v[2 * m + 1][1]},
          {v[2 * m][2], v[2 * m + 1][2], 0u, 0u}};
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split_tf32(__uint_as_float(x[s][r]), ah[m][s][r], al[m][s][r]);
    }
  }
  __device__ __forceinline__ void set_b(int n, float wa, float wb,
                                        float w8) {
    split_tf32(wa, bh[n][0], bl[n][0]);
    split_tf32(wb, bh[n][1], bl[n][1]);
    split_tf32(w8, bh[n][2], bl[n][2]);
  }
  __device__ __forceinline__ void z(int n, float d[2][4]) const {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      d[m][0] = d[m][1] = d[m][2] = d[m][3] = 0.f;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const uint32_t hi[2] = {bh[n][2 * s], s ? 0u : bh[n][1]};
        const uint32_t lo[2] = {bl[n][2 * s], s ? 0u : bl[n][1]};
        mma_tf32(d[m], al[m][s], hi);
        mma_tf32(d[m], ah[m][s], lo);
        mma_tf32(d[m], ah[m][s], hi);
      }
    }
  }
};

template <typename T> struct WinOf { using type = WinTf32; };
template <> struct WinOf<__nv_bfloat16> { using type = WinBf16; };

// The bits of a band element: a bf16's in the low half, an f32's whole.
__device__ __forceinline__ uint32_t bits(__nv_bfloat16 x) {
  return *reinterpret_cast<const unsigned short*>(&x);
}
__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }

// Lane (g, t)'s A values of pooled pixel g, whose patch starts at band + p
// (row stride bw), as bits: taps ja and jb (at offsets oa, ob from a
// position's top-left tap) and 8 (t = 0 only) of window positions k = 0-3,
// position k at (k / 2) * bw + k % 2; zeros for a pixel past the tile
// (z = 0, which adds nothing to K8's sums).
template <typename T>
__device__ __forceinline__ void window_values(const T* p, int bw, int oa,
                                              int ob, bool t0, bool valid,
                                              uint32_t v[4][3]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const T* q = p + (k >> 1) * bw + (k & 1);
    v[k][0] = valid ? bits(q[oa]) : 0u;
    v[k][1] = valid ? bits(q[ob]) : 0u;
    v[k][2] = valid && t0 ? bits(q[2 * bw + 2]) : 0u;
  }
}

// The chunk's B fragments: lane (g, t) takes channel c = chunk * kChunk +
// 8 n + g of product n, zero past C. K1 (kSigned) takes the taps times the
// sign of the channel's scale (exact), so that its z is sign(scale) * z.
template <bool kSigned, class Win>
__device__ __forceinline__ void load_taps(const StemOperands& op, Win& win,
                                          int C, int chunk, int ja, int jb,
                                          bool t0) {
  const int g = (threadIdx.x % 32) >> 2;
#pragma unroll
  for (int n = 0; n < kNTiles; ++n) {
    const int c = min(chunk * kChunk + 8 * n + g, C - 1);
    const float* w = op.taps + (size_t)c * op.tap_c;
    const float m = chunk * kChunk + 8 * n + g >= C ? 0.f
                    : kSigned && op.scale[c] < 0.f ? -1.f : 1.f;
    win.set_b(n, m * w[ja * op.tap_k], m * w[jb * op.tap_k],
              t0 ? m * w[8 * op.tap_k] : 0.f);
  }
}

// K8's flush: a thread's sums of one chunk into the CTA's partials, in a
// fixed order: the 8 lane groups by shuffles (every lane of a column ends
// with the same bits), then warps 0-7 through shared memory.
__device__ __forceinline__ void flush_stats(float acc[kNTiles][2][2],
                                            float* red, float* part, int C,
                                            int chunk) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < kNTiles; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        float v = acc[n][e][k];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == n) red[(warp * 2 + k) * kChunk + 8 * n + 2 * t + e] = v;
        acc[n][e][k] = 0.f;
      }
  __syncthreads();
  if (threadIdx.x < 2 * kChunk) {
    const int k = threadIdx.x / kChunk, ch = threadIdx.x % kChunk;
    const int c = chunk * kChunk + ch;
    float s = 0.f;
    for (int w = 0; w < kFwdWarps; ++w) s += red[(w * 2 + k) * kChunk + ch];
    if (c < C) part[k * C + c] = s;
  }
  __syncthreads();
}

// K1's stores of a warp's window tile from its staging buffer st (pixel
// p's channels 2 j, 2 j + 1 of the chunk in word p * kPixWords + j): 16
// bytes (8 channels) a lane, lane l then l + 32 taking pixel l / 8 and the
// chunk's channels 8 (l % 8) .. + 7. pix: the output offset of lane group
// g's pixel, -1 past the tile. Channels past C are not stored.
__device__ __forceinline__ void store_window(const uint32_t* st,
                                             __nv_bfloat16* out,
                                             long long pix, int C, int c0) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = lane + 32 * h, p = j >> 3, ch = c0 + 8 * (j & 7);
    const long long o = __shfl_sync(0xffffffffu, pix, 4 * p);
    if (o < 0 || ch >= C) continue;
    const uint32_t* src = st + p * kPixWords + 4 * (j & 7);
    __nv_bfloat16* dst = out + o + ch;
    if (C % 8 == 0) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(src);
      for (int i = 0; i < min(8, C - ch); ++i) dst[i] = e[i];
    }
  }
}

// K8 (kStats) and K1's bf16 serving call, on the tiles of stem_plan. A
// pass of warp w takes the tile's pooled pixels q0 .. q0 + 7, q0 = 8 w +
// 64 i, as one window tile a product, all 8 products of the chunk (those
// past C multiply zero taps and are not stored). K8 adds each lane's z and
// z^2 into f32 registers over the CTA's tiles. K1 takes the max of the
// four positions, then the affine (as stem_kernel: __fmul_rn, __fadd_rn)
// and the ReLU: its taps carry the sign of the scale, so the max of
// sign(s) * z times |s| plus b is the max of the four z * s + b (rounding
// is monotone); it packs the pair to bf16 and stages it for
// store_window.
template <typename T, bool kStats>
__global__ void __launch_bounds__(kFwdThreads, 2)
stem_mma_kernel(const T* __restrict__ img, const StemOperands op,
                void* __restrict__ out, int B, int H, int W, int C, int rows,
                int col_tiles) {
  using Win = typename WinOf<T>::type;
  extern __shared__ __align__(16) float smem[];
  const Tiling tl(B, H, W, C, rows, col_tiles);
  T* bands = reinterpret_cast<T*>(smem);  // tile i's in bands + i % 2 * n
  const int band_elems = fwd_band_elems(tl);
  float* extra = smem + fwd_band_bytes(tl, sizeof(T)) / sizeof(float);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane >> 2, t = lane & 3;
  const int ja = Win::kTapA * t, jb = ja + Win::kTapStep;

  // K8: the CTA's partials start at zero (a chunk none of its tiles covers)
  float* part = kStats ? static_cast<float*>(out) + (size_t)blockIdx.x * 2 * C
                       : nullptr;
  if constexpr (kStats)
    for (int i = threadIdx.x; i < 2 * C; i += kFwdThreads) part[i] = 0.f;

  Win win;
  float acc[kNTiles][2][2] = {};  // K8: [product][channel 2t + e][z, z^2]
  int chunk = -1;
  if ((int)blockIdx.x < tl.tiles)
    stage_band_async(img, Tile(tl, blockIdx.x), H, W, bands);
  for (int ti = blockIdx.x, it = 0; ti < tl.tiles; ti += gridDim.x, ++it) {
    const Tile tile(tl, ti);
    __syncthreads();  // the previous tile's reads of shared memory are done
    // the next tile's band in flight into the other buffer meanwhile (an
    // empty group past the last tile), then this tile's band
    T* band = bands + (it & 1) * band_elems;
    if (ti + (int)gridDim.x < tl.tiles)
      stage_band_async(img, Tile(tl, ti + gridDim.x), H, W,
                       bands + (~it & 1) * band_elems);
    else
      cp_async_commit();
    if (tile.chunk != chunk) {
      if constexpr (kStats)
        if (chunk >= 0) flush_stats(acc, extra, part, C, chunk);
      chunk = tile.chunk;
      load_taps<!kStats>(op, win, C, chunk, ja, jb, t == 0);
      if constexpr (!kStats)  // |scale|, then bias
        for (int i = threadIdx.x; i < 2 * kChunk; i += kFwdThreads) {
          const int c = min(chunk * kChunk + i % kChunk, C - 1);
          extra[i] = i < kChunk ? fabsf(op.scale[c]) : op.bias[c];
        }
    }
    cp_async_wait_one();
    __syncthreads();

    const int bw = 2 * tile.tw + 4, npix = tile.nr * tile.tw;
    const int c0 = chunk * kChunk;
    const int oa = ja / 3 * bw + ja % 3, ob = jb / 3 * bw + jb % 3;
    // pooled pixel q = q0 + g of the tile at row r, column x; a pass moves
    // q by kStep, r by dr and x by dx (with a carry)
    constexpr int kStep = kFwdWarps * kWinPix;
    const int dr = kStep / tile.tw, dx = kStep - dr * tile.tw;
    int r = (warp * kWinPix + g) / tile.tw;
    int x = warp * kWinPix + g - r * tile.tw;
    for (int q0 = warp * kWinPix; q0 < npix; q0 += kStep) {
      const int q = q0 + g;
      const bool valid = q < npix;
      uint32_t v[4][3];
      // the patch starts one column into the band
      window_values(band + (valid ? 2 * r * bw + 2 * x + 1 : 0), bw, oa, ob,
                    t == 0, valid, v);
      win.set_a(v);
      // K1: the warp's previous stores are done with its staging buffer
      __syncwarp();
      if constexpr (kStats) {
#pragma unroll
        for (int n = 0; n < kNTiles; ++n) {
          float d[2][4];
          win.z(n, d);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float z0 = d[0][e], z1 = d[0][2 + e];
            const float z2 = d[1][e], z3 = d[1][2 + e];
            acc[n][e][0] += (z0 + z1) + (z2 + z3);
            acc[n][e][1] += fmaf(z0, z0, z1 * z1) + fmaf(z2, z2, z3 * z3);
          }
        }
      } else {
        uint32_t* st = reinterpret_cast<uint32_t*>(extra + 2 * kChunk) +
                       warp * kStageWords;
#pragma unroll
        for (int n = 0; n < kNTiles; ++n) {
          float d[2][4];
          win.z(n, d);
          const float2 s = *reinterpret_cast<const float2*>(extra + 8 * n +
                                                            2 * t);
          const float2 b = *reinterpret_cast<const float2*>(
              extra + kChunk + 8 * n + 2 * t);
          const float m0 = fmaxf(fmaxf(d[0][0], d[0][2]),
                                 fmaxf(d[1][0], d[1][2]));
          const float m1 = fmaxf(fmaxf(d[0][1], d[0][3]),
                                 fmaxf(d[1][1], d[1][3]));
          // the affine, rounded to bf16, then the ReLU on the pair (the
          // rounding is monotone and keeps 0: the same as rounding last)
          const __nv_bfloat162 a = __floats2bfloat162_rn(
              __fadd_rn(__fmul_rn(m0, s.x), b.x),
              __fadd_rn(__fmul_rn(m1, s.y), b.y));
          const __nv_bfloat162 y = __hmax2(a, __float2bfloat162_rn(0.f));
          st[g * kPixWords + 4 * n + t] =
              *reinterpret_cast<const uint32_t*>(&y);
        }
        __syncwarp();
        const long long pix =
            valid ? (((long long)tile.b * tl.H2 + tile.r0 + r) * tl.W2 +
                     tile.c0 + x) * C
                  : -1;
        store_window(st, static_cast<__nv_bfloat16*>(out), pix, C, c0);
      }
      r += dr;
      x += dx;
      if (x >= tile.tw) x -= tile.tw, ++r;
    }
  }
  if constexpr (kStats)
    if (chunk >= 0) flush_stats(acc, extra, part, C, chunk);
}

// K8 (stats) in either dtype and K1's serving call in bf16; null for f32
// serving (stem_kernel's).
const void* fwd_fn(int bf16, int stats) {
  if (stats)
    return bf16 ? (const void*)stem_mma_kernel<__nv_bfloat16, true>
                : (const void*)stem_mma_kernel<float, true>;
  return bf16 ? (const void*)stem_mma_kernel<__nv_bfloat16, false> : nullptr;
}

template <typename T, bool kStats>
cudaError_t launch_fwd(const void* img, const StemOperands& op, void* out,
                       int B, int H, int W, int C, int rows, int col_tiles,
                       int ctas, int smem, cudaStream_t s) {
  stem_mma_kernel<T, kStats><<<ctas, kFwdThreads, smem, s>>>(
      static_cast<const T*>(img), op, out, B, H, W, C, rows, col_tiles);
  return cudaGetLastError();
}

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

// K8 (stats = 1): out (2, C) f32 [sum z, sum z^2]; parts (ctas, 2, C) f32
// scratch for the CTAs' partials, which a second kernel sums in CTA order.
// K1's bf16 serving call (stats = 0, bf16 = 1): out (B, H/2, W/2, C) bf16,
// parts unused. taps: f32, tap kh * 3 + kw of channel c at taps[k * tap_k
// + c * tap_c], rounded to bf16 in bf16 mode; scale, bias (K1): f32 [C].
// The plan (_stem_tiles.py::stem_plan): as crnn_stem_bwd's, its smem
// what this file computes for it; else, and for f32 with stats = 0
// (stem_kernel's call), cudaErrorInvalidValue.
extern "C" int crnn_stem_mma(const void* img, const void* taps, int tap_k,
                             int tap_c, const void* scale, const void* bias,
                             void* parts, void* out, int B, int H, int W,
                             int C, int bf16, int stats, int rows,
                             int col_tiles, int ctas, int smem,
                             void* stream) {
  const Tiling tl(B, H, W, C, rows, col_tiles);
  const void* fn = fwd_fn(bf16, stats);
  if (!fn || rows < 1 || col_tiles < 1 || ctas < 1 ||
      (W / 2 + col_tiles - 1) / col_tiles > kColCap ||
      smem != fwd_smem_bytes(tl, stats, bf16 ? 2 : 4))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(fn, smem);
  if (e != cudaSuccess) return (int)e;
  const StemOperands op{static_cast<const float*>(taps), tap_k, tap_c,
                        static_cast<const float*>(scale),
                        static_cast<const float*>(bias)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!stats)
    return (int)launch_fwd<__nv_bfloat16, false>(
        img, op, out, B, H, W, C, rows, col_tiles, ctas, smem, s);
  e = bf16 ? launch_fwd<__nv_bfloat16, true>(img, op, parts, B, H, W, C,
                                             rows, col_tiles, ctas, smem, s)
           : launch_fwd<float, true>(img, op, parts, B, H, W, C, rows,
                                     col_tiles, ctas, smem, s);
  if (e != cudaSuccess) return (int)e;
  sum_rows_kernel<<<(2 * C + 31) / 32, 256, 0, s>>>(
      static_cast<const float*>(parts), static_cast<float*>(out), ctas,
      2 * C);
  return (int)cudaGetLastError();
}

// The K8 (stats = 1) or K1 serving CTAs one SM holds at `smem` bytes of
// dynamic shared memory, into *ctas.
extern "C" int crnn_stem_mma_ctas_per_sm(int bf16, int stats, int smem,
                                         int* ctas) {
  const void* fn = fwd_fn(bf16, stats);
  if (!fn) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(fn, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, fn, kFwdThreads, smem);
}

extern "C" const char* crnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
