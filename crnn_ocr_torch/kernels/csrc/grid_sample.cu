// Bilinear sampling at pixel coordinates, border-clamped: K11 forward and
// K12 backward of the STN's warp.
//
// Replaces crnn_ocr_tpu/kernels/grid_sample.py: _sample_pix_fwd_impl (K11,
// Pallas body _fwd_kernel) and _sample_pix_bwd (K12, body _bwd_kernel).
// The TPU kernels build a one-hot (W, CHUNK) corner-weight matrix per chunk
// of samples and run an MXU product: H * W multiply-adds per sample (8,192
// at 32 x 256) for 4 useful terms. Here each sample reads its 4 corners
// directly.
//
// Math (the TPU kernel's _corner_weights and the plain versions in
// kernels/grid_sample.py, in the same order of operations, each step rounded
// on its own with the _rn intrinsics so that no multiply-add is fused):
//   x0f = floor(x), wx1 = x - x0f, x0 = clamp(x0f, 0, W-1),
//   x1 = clamp(x0f + 1, 0, W-1) (likewise y); where x0 == x1 after the clamp,
//   mx0 = (1 - wx1) + wx1 and mx1 = 0, else mx0 = 1 - wx1, mx1 = wx1;
//   s_h = img[h, x0] * mx0 + img[h, x1] * mx1 for h in {y0, y1};
//   out = my0 * s_y0 + my1 * s_y1.
// Backward for an upstream g per sample:
//   dx = g * (my0 * (img[y0,x1] - img[y0,x0]) + my1 * (img[y1,x1] - img[y1,x0]))
//   dy = g * (s_y1 - s_y0)
//   d_img[h, w] += (g * my_h) * mx_w over the distinct corners.
//
// K11 design: one thread per sample, blocks of 256 samples of one image
// (grid: samples / 256 x images). Corners come through L1 from device
// memory: an image is 16 KB in bf16, and neighbouring samples of a
// near-identity warp read neighbouring pixels.
//
// K12 design: one block of 1024 threads per image, looping over its
// samples. dx and dy are written per sample (deterministic). d_img is
// accumulated in an f32 (H, W) tile in shared memory (32 KB at 32 x 256)
// with shared-memory atomics, then written to device memory once; the
// order of the atomics is not fixed, so d_img is held to a tolerance.
//
// Bounds on the H100 (bytes / 3.35 TB/s; the arithmetic, ~20 operations a
// sample, is far below): K11 at the serving shape B 256, 32 x 256, bf16:
// image 4.2 MB + x, y 16.8 MB + out 8.4 MB = 29.4 MB -> 8.8 us. K12 at the
// training shape B 128: image 2.1 MB + x, y, g 12.6 MB + dx, dy 8.4 MB +
// d_img 4.2 MB = 27.3 MB -> 8.1 us.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFwdThreads = 256;
constexpr int kBwdThreads = 1024;

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

struct Corners {
  int x0, x1, y0, y1;
  float mx0, mx1, my0, my1;
};

__device__ __forceinline__ void axis(float v, int n, int& i0, int& i1,
                                     float& m0, float& m1) {
  const float f = floorf(v);
  const float w1 = __fsub_rn(v, f);
  const float w0 = __fsub_rn(1.f, w1);
  // clamping f to [-2, n] first keeps the int conversion in range and
  // changes neither index
  const int i = (int)fminf(fmaxf(f, -2.f), (float)n);
  i0 = min(max(i, 0), n - 1);
  i1 = min(max(i + 1, 0), n - 1);
  const bool same = i0 == i1;
  m0 = same ? __fadd_rn(w0, w1) : w0;
  m1 = same ? 0.f : w1;
}

__device__ __forceinline__ Corners corners(float x, float y, int H, int W) {
  Corners c;
  axis(x, W, c.x0, c.x1, c.mx0, c.mx1);
  axis(y, H, c.y0, c.y1, c.my0, c.my1);
  return c;
}

__device__ __forceinline__ float blend(float a, float wa, float b, float wb) {
  return __fadd_rn(__fmul_rn(a, wa), __fmul_rn(b, wb));
}

template <typename T>
__global__ void __launch_bounds__(kFwdThreads)
sample_fwd(const T* __restrict__ img, const float* __restrict__ xs,
           const float* __restrict__ ys, float* __restrict__ out, int H, int W,
           int N) {
  const int b = blockIdx.y;
  const int n = blockIdx.x * kFwdThreads + threadIdx.x;
  if (n >= N) return;
  const long long o = (long long)b * N + n;
  const Corners c = corners(__ldg(xs + o), __ldg(ys + o), H, W);
  const T* im = img + (long long)b * H * W;
  const T* r0 = im + c.y0 * W;
  const T* r1 = im + c.y1 * W;
  const float s0 = blend(load_f(r0 + c.x0), c.mx0, load_f(r0 + c.x1), c.mx1);
  const float s1 = blend(load_f(r1 + c.x0), c.mx0, load_f(r1 + c.x1), c.mx1);
  out[o] = blend(c.my0, s0, c.my1, s1);
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
sample_bwd(const T* __restrict__ img, const float* __restrict__ xs,
           const float* __restrict__ ys, const float* __restrict__ gs,
           float* __restrict__ dimg, float* __restrict__ dx,
           float* __restrict__ dy, int H, int W, int N) {
  extern __shared__ float acc[];  // H * W f32
  const int b = blockIdx.x;
  const int HW = H * W;
  for (int i = threadIdx.x; i < HW; i += kBwdThreads) acc[i] = 0.f;
  __syncthreads();
  const T* im = img + (long long)b * HW;
  for (int n = threadIdx.x; n < N; n += kBwdThreads) {
    const long long o = (long long)b * N + n;
    const Corners c = corners(__ldg(xs + o), __ldg(ys + o), H, W);
    const T* r0 = im + c.y0 * W;
    const T* r1 = im + c.y1 * W;
    const float v00 = load_f(r0 + c.x0), v01 = load_f(r0 + c.x1);
    const float v10 = load_f(r1 + c.x0), v11 = load_f(r1 + c.x1);
    const float s0 = blend(v00, c.mx0, v01, c.mx1);
    const float s1 = blend(v10, c.mx0, v11, c.mx1);
    const float g = __ldg(gs + o);
    dx[o] = __fmul_rn(g, blend(c.my0, __fsub_rn(v01, v00), c.my1,
                               __fsub_rn(v11, v10)));
    dy[o] = __fmul_rn(g, __fsub_rn(s1, s0));
    const float g0 = __fmul_rn(g, c.my0);
    const float g1 = __fmul_rn(g, c.my1);
    atomicAdd(&acc[c.y0 * W + c.x0], __fmul_rn(g0, c.mx0));
    if (c.x1 != c.x0) atomicAdd(&acc[c.y0 * W + c.x1], __fmul_rn(g0, c.mx1));
    if (c.y1 != c.y0) {
      atomicAdd(&acc[c.y1 * W + c.x0], __fmul_rn(g1, c.mx0));
      if (c.x1 != c.x0)
        atomicAdd(&acc[c.y1 * W + c.x1], __fmul_rn(g1, c.mx1));
    }
  }
  __syncthreads();
  float* dst = dimg + (long long)b * HW;
  for (int i = threadIdx.x; i < HW; i += kBwdThreads) dst[i] = acc[i];
}

template <typename T>
cudaError_t launch_fwd(const void* img, const float* x, const float* y,
                       float* out, int B, int H, int W, int N,
                       cudaStream_t stream) {
  if (B == 0 || N == 0) return cudaSuccess;
  const dim3 grid((N + kFwdThreads - 1) / kFwdThreads, B);
  sample_fwd<T><<<grid, kFwdThreads, 0, stream>>>(static_cast<const T*>(img),
                                                  x, y, out, H, W, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* img, const float* x, const float* y,
                       const float* g, float* dimg, float* dx, float* dy,
                       int B, int H, int W, int N, cudaStream_t stream) {
  if (B == 0) return cudaSuccess;
  const size_t smem = (size_t)H * W * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sample_bwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  sample_bwd<T><<<B, kBwdThreads, smem, stream>>>(
      static_cast<const T*>(img), x, y, g, dimg, dx, dy, H, W, N);
  return cudaGetLastError();
}

}  // namespace

// img (B, H, W) bf16 (bf16 = 1) or f32; x, y (B, N) f32 pixel coordinates;
// out (B, N) f32.
extern "C" int crnn_grid_sample_fwd(const void* img, const void* x,
                                    const void* y, void* out, int B, int H,
                                    int W, int N, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  float* o = static_cast<float*>(out);
  const cudaError_t e =
      bf16 ? launch_fwd<__nv_bfloat16>(img, xf, yf, o, B, H, W, N, s)
           : launch_fwd<float>(img, xf, yf, o, B, H, W, N, s);
  return (int)e;
}

// The same inputs and g (B, N) f32 -> d_img (B, H, W) f32, dx, dy (B, N) f32.
extern "C" int crnn_grid_sample_bwd(const void* img, const void* x,
                                    const void* y, const void* g, void* dimg,
                                    void* dx, void* dy, int B, int H, int W,
                                    int N, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  const float* gf = static_cast<const float*>(g);
  float* di = static_cast<float*>(dimg);
  float* dxf = static_cast<float*>(dx);
  float* dyf = static_cast<float*>(dy);
  const cudaError_t e =
      bf16 ? launch_bwd<__nv_bfloat16>(img, xf, yf, gf, di, dxf, dyf, B, H, W,
                                       N, s)
           : launch_bwd<float>(img, xf, yf, gf, di, dxf, dyf, B, H, W, N, s);
  return (int)e;
}

extern "C" const char* crnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
