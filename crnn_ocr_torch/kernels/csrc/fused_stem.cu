// Serve stem: maxpool2x2(relu(conv3x3(img) * scale + bias)), NHWC out.
//
// Replaces crnn_ocr_tpu/kernels/fused_stem.py::fused_stem_serve (the Pallas
// body _stem_kernel). BatchNorm's running statistics arrive folded into a
// per-channel (scale, bias); the full-resolution activation is never
// written, only the pooled (B, H/2, W/2, C) result.
//
// Design: one thread per (image, pooled pixel, group of 8 channels). It
// reads the 4x4 input patch under its 2x2 pooling window once (SAME zero
// padding at the border), computes the four 3x3 convolutions for each of
// its channels, applies the affine and ReLU, takes the max and writes its
// 8 channels with one vector store when C % 8 == 0. Consecutive threads
// own consecutive channel groups, then consecutive pixels, so a warp's
// stores cover one contiguous span of the NHWC output. Weights, scale and
// bias sit in shared memory.
//
// The image's type sets the mode, and the output has the same type.
// Rounding points (the TPU kernel's): in bf16 mode the image and the
// weights are bf16, products and the 9-term sums are f32, the affine, ReLU
// and max are f32, and the result is cast once to bf16. In f32 mode
// everything is f32.
//
// Bound on the H100 at the main-path shape (256, 32, 256, 1) -> C = 64,
// bf16: the bytes, 4.2 MB of image read plus 67.1 MB of output written,
// 71.3 MB / 3.35 TB/s = 21.3 us. Its 2.4 GFLOP of conv FMAs are far below
// that at any rate. Left for later: loads through shared-memory tiles
// shared by neighbouring pixels (each input pixel is read by up to four
// threads' patches here, through L1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCG = 8;         // channels per thread
constexpr int kThreads = 256;  // threads per block

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
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

    // 4x4 patch rows 2*h2-1 .. 2*h2+2, cols 2*w2-1 .. 2*w2+2
    float p[4][4];
    const T* base = img + (long long)b * H * W;
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
      float w[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) w[k] = taps[k * C + c];
      const float s = scale[c], bb = bias[c];
      float m = 0.f;  // max(relu(.)) == relu(max(.))
#pragma unroll
      for (int oy = 0; oy < 2; ++oy) {
#pragma unroll
        for (int ox = 0; ox < 2; ++ox) {
          float z = 0.f;
#pragma unroll
          for (int kh = 0; kh < 3; ++kh)
#pragma unroll
            for (int kw = 0; kw < 3; ++kw)
              z = fmaf(p[oy + kh][ox + kw], w[kh * 3 + kw], z);
          m = fmaxf(m, __fadd_rn(__fmul_rn(z, s), bb));  // no FMA: as z*s+b
        }
      }
      res[i] = m;
    }
    T* dst = out + (((long long)b * H2 + h2) * W2 + w2) * C + c0;
    store8(dst, res, vec, n);
  }
}

template <typename T>
cudaError_t launch(const void* img, const float* params, void* out, int B,
                   int H, int W, int C, cudaStream_t stream) {
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

}  // namespace

// bf16: img and out are bf16 (1) or f32 (0).
extern "C" int crnn_fused_stem_serve(const void* img, const void* params,
                                     void* out, int B, int H, int W, int C,
                                     int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* prm = static_cast<const float*>(params);
  const cudaError_t e =
      bf16 ? launch<__nv_bfloat16>(img, prm, out, B, H, W, C, s)
           : launch<float>(img, prm, out, B, H, W, C, s);
  return (int)e;
}

extern "C" const char* crnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
