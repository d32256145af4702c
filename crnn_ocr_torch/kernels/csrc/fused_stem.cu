// The stem, serving and training: conv3x3 (1 -> C) + BatchNorm + ReLU +
// maxpool 2x2, without the full-resolution activation in device memory.
//
// Four kernels share one patch loader and one conv function, so that every
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
// K9  bwd_kernel<T, false>: the pooled gradient routed to the first maximum
//     of its window in (h, w) order and masked by the ReLU, then per-channel
//     partial sums of d and d * xhat. Replaces ::_run_bwd_partials
//     (_bwd_partials_kernel).
// K10 bwd_kernel<T, true>: the same routing, the BatchNorm backward
//     d_conv = c1 * (d - c2 - xhat * c3) at every position (dense: c2 and c3
//     couple every position through the batch statistics), and per-block
//     partials of d_w[kh][kw][c] = sum(tap * d_conv). Replaces
//     ::_run_bwd_final (_bwd_final_kernel). No image gradient: the training
//     stem's image is a gradient leaf (non-STN models only).
//
// Design. K1: one thread per (image, pooled pixel, group of 8 channels),
// 8 channels written with one vector store. K8-K10: one thread per
// (pooled pixel, channel) in 256-thread blocks of (CB, P): CB = min(C, 256)
// channels (more channels take more blocks along y), P = 256 / CB pixels;
// a warp's threads share a pixel (its patch loads broadcast through L1) and
// read the NHWC gradient on consecutive channels. Each thread reads the 4x4
// input patch under its 2x2 window (SAME zero padding) and recomputes the
// window's four z. Sums stay in registers over a grid-stride loop, then the
// block reduces them in shared memory in a fixed order and writes its own
// partials (blocks, 2, C) or (blocks, 9, C); the wrapper sums those in fixed
// order. No float atomics: a step run twice gives the same bits.
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
// us each, set by bytes. K1 in training ~5.3 us (its pooled output). The
// conv FMAs here run on the CUDA cores (67 TFLOP/s f32: ~9 us a pass), so
// these kernels sit well above their bf16 bounds; putting the products on
// the tensor cores and sharing patches through shared memory is left for
// later. At fonts-hard's bucket 256 every figure doubles.

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

// The pooled gradient gv routed as max-pool's backward routes it: to the
// first position equal to the window's maximum, and only if its activation
// is > 0 (the ReLU). d[k] = gv or 0.
__device__ __forceinline__ void route(const float z[4], float s, float b,
                                      float gv, float d[4]) {
  float a[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) a[k] = affine_relu(z[k], s, b);
  const float m = fmaxf(fmaxf(a[0], a[1]), fmaxf(a[2], a[3]));
  bool taken = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool hit = (a[k] == m) && !taken;
    taken = taken || hit;
    d[k] = (hit && a[k] > 0.f) ? gv : 0.f;
  }
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

// ---- K8, K9, K10 ----
// Thread (threadIdx.x, slot threadIdx.y) of a (CB, P) block owns channel
// c = blockIdx.y * CB + threadIdx.x (a thread past C reads channel C - 1
// and writes nothing). params, f32, each [C]: taps[9] (rounded to bf16 in
// bf16 mode), then for K9/K10 mean, inv, scale, bias, then for K10 c1, c2,
// c3.
constexpr int kRedThreads = 256;  // K8-K10: threads per block

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

template <typename T, bool kFinal>
__global__ void __launch_bounds__(kRedThreads)
bwd_kernel(const T* __restrict__ img, const T* __restrict__ g,
           const float* __restrict__ params, float* __restrict__ out, int B,
           int H, int W, int C) {
  constexpr int K = kFinal ? 9 : 2;
  const int c = channel(C);
  float w[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) w[k] = params[k * C + c];
  const float mean = params[9 * C + c], inv = params[10 * C + c];
  const float s = params[11 * C + c], bb = params[12 * C + c];
  float c1 = 0.f, c2 = 0.f, c3 = 0.f;
  if (kFinal) {
    c1 = params[13 * C + c];
    c2 = params[14 * C + c];
    c3 = params[15 * C + c];
  }
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.f;
  for (PixIter it(B, H, W); it.more(); it.next()) {
    float p[4][4], z[4], d[4];
    load_patch(img + (long long)it.b() * H * W, it.h2(), it.w2(), H, W, p);
    conv_window(p, w, z);
    route(z, s, bb, load_f(g + (long long)it.pix * C + c), d);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float xh = __fmul_rn(__fsub_rn(z[k], mean), inv);
      if (kFinal) {
        // c1 * ((d - c2) - xhat * c3), spread over the window's taps
        const float dc = __fmul_rn(
            c1, __fsub_rn(__fsub_rn(d[k], c2), __fmul_rn(xh, c3)));
        const int oy = k >> 1, ox = k & 1;
#pragma unroll
        for (int kh = 0; kh < 3; ++kh)
#pragma unroll
          for (int kw = 0; kw < 3; ++kw)
            acc[kh * 3 + kw] = fmaf(p[oy + kh][ox + kw], dc, acc[kh * 3 + kw]);
      } else {
        acc[0] = __fadd_rn(acc[0], d[k]);
        acc[1] = __fadd_rn(acc[1], __fmul_rn(d[k], xh));
      }
    }
  }
  block_partials<K>(acc, out, C);
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

// K9 (final = 0): out (blocks, 2, C) partial [sum d, sum d * xhat].
// K10 (final = 1): out (blocks, 9, C) partial d_w, rows kh * 3 + kw.
// g: the pooled gradient (B, H/2, W/2, C), in the image's dtype.
extern "C" int crnn_stem_bwd(const void* img, const void* g,
                             const void* params, void* out, int B, int H,
                             int W, int C, int bf16, int final_pass,
                             int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RedLaunch L(blocks, C, final_pass ? 9 : 2);
  const dim3 grid = L.grid, block = L.block;
  const size_t smem = L.smem;
  const float* prm = static_cast<const float*>(params);
  float* o = static_cast<float*>(out);
  if (bf16) {
    const auto* im = static_cast<const __nv_bfloat16*>(img);
    const auto* gg = static_cast<const __nv_bfloat16*>(g);
    if (final_pass)
      bwd_kernel<__nv_bfloat16, true><<<grid, block, smem, s>>>(
          im, gg, prm, o, B, H, W, C);
    else
      bwd_kernel<__nv_bfloat16, false><<<grid, block, smem, s>>>(
          im, gg, prm, o, B, H, W, C);
  } else {
    const auto* im = static_cast<const float*>(img);
    const auto* gg = static_cast<const float*>(g);
    if (final_pass)
      bwd_kernel<float, true><<<grid, block, smem, s>>>(im, gg, prm, o, B, H,
                                                        W, C);
    else
      bwd_kernel<float, false><<<grid, block, smem, s>>>(im, gg, prm, o, B,
                                                         H, W, C);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* crnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
