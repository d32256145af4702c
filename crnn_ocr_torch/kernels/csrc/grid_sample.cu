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
// K12 has two designs (kernels/grid_sample.py::plan picks the launch from
// the shape):
// - "cluster" (the path's): an image's N samples are split over a thread
//   block cluster of C CTAs (grid B * C, 512 threads a CTA), CTA r taking
//   the contiguous range [r * span, (r + 1) * span). Every load is issued
//   first and none waits in a register: the image is staged in shared
//   memory by 16-byte cp.async (plus a plain-load tail, or plain loads
//   throughout where its rows do not start 16-byte aligned), and the
//   CTA's x, y and g by 4-byte cp.async in a ring of two 1,024-sample
//   chunks, the next chunk's copies in flight while a chunk is worked;
//   each thread copies the samples it works itself, so only its own wait
//   orders them and warps run free of each other. Each CTA
//   adds its terms to its own f32 tile of the whole image in shared
//   memory; after a cluster barrier CTA r sums pixels [r * slice, (r + 1)
//   * slice) (flat ranges, so H = 1 and H * W < C work too) over the
//   cluster's tiles through distributed shared memory, in rank order, and
//   writes them with 16-byte stores: no zero fill of d_img in device
//   memory and no global atomic. Past a CTA's tile (H * W over 51,968
//   pixels beside the ring) each CTA holds only its slice, and a term for
//   another CTA's slice goes there by red.shared::cluster.add.f32 (a
//   generic atomic in the SASS, slow, but no path's shape needs it); where
//   image plus accumulator exceed a CTA's 232,448 bytes (always with
//   slices) the corners come through L1. The card has no shared-memory f32 add: atomicAdd is a
//   compare-and-swap loop (ATOMS.CAST.SPIN), so lanes adding to one pixel
//   in one instruction take a pass each. A warp's lanes hold neighbouring
//   samples of a row, and where a warp runs past the image's left or
//   right border up to all of them clamp to one pixel: such a warp first
//   sums each run of lanes on one pixel into the run's last lane
//   (reduce_clamped; on fonts-warp-stn's frames that run is ~20 lanes).
// - "image" (the first design, kept for comparison): one block of 1024
//   threads per image looping over its samples, d_img accumulated in an
//   f32 (H, W) tile in shared memory and written once; the image read
//   through L1.
// In both, dx and dy are written per sample (deterministic), and the order
// of the atomics is not fixed, so d_img is held to a tolerance.
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
constexpr int kBwdThreads = 1024;   // "image"
constexpr int kClusterThreads = 512;  // "cluster", a CTA
constexpr int kChunk = 1024;        // samples a ring slot holds
constexpr int kPer = kChunk / kClusterThreads;  // a thread's, of a chunk
constexpr int kRing = 2;            // ring slots of x, y, g in shared memory
constexpr int kMaxCluster = 8;      // the portable maximum
constexpr int kSmemMax = 232448;    // a CTA's shared memory, opted in

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
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

// One sample's backward: (dx, dy), and its distinct corner terms handed to
// add(corner, pixel, term), corners 0-3 = (y0, x0), (y0, x1), (y1, x0),
// (y1, x1).
template <typename Pix, typename Add>
__device__ __forceinline__ void sample_backward(Pix pix, float x, float y,
                                                float g, int H, int W,
                                                float& dxo, float& dyo,
                                                Add add) {
  const Corners c = corners(x, y, H, W);
  const int p0 = c.y0 * W, p1 = c.y1 * W;
  const float v00 = pix(p0 + c.x0), v01 = pix(p0 + c.x1);
  const float v10 = pix(p1 + c.x0), v11 = pix(p1 + c.x1);
  const float s0 = blend(v00, c.mx0, v01, c.mx1);
  const float s1 = blend(v10, c.mx0, v11, c.mx1);
  dxo = __fmul_rn(g, blend(c.my0, __fsub_rn(v01, v00), c.my1,
                           __fsub_rn(v11, v10)));
  dyo = __fmul_rn(g, __fsub_rn(s1, s0));
  const float g0 = __fmul_rn(g, c.my0);
  const float g1 = __fmul_rn(g, c.my1);
  add(0, p0 + c.x0, __fmul_rn(g0, c.mx0));
  if (c.x1 != c.x0) add(1, p0 + c.x1, __fmul_rn(g0, c.mx1));
  if (c.y1 != c.y0) {
    add(2, p1 + c.x0, __fmul_rn(g1, c.mx0));
    if (c.x1 != c.x0) add(3, p1 + c.x1, __fmul_rn(g1, c.mx1));
  }
}

// A sample's corner terms: pixel p[k] and term v[k] for corners k = 0-3 as
// in sample_backward; `live` bit k set where corner k is a distinct pixel
// of a sample that exists.
struct Terms {
  int p[4];
  float v[4];
  uint32_t live;
};

template <typename Pix>
__device__ __forceinline__ Terms sample_terms(Pix pix, float x, float y,
                                              float g, int H, int W, bool on,
                                              float& dxo, float& dyo) {
  Terms t;
  t.live = 0;
  sample_backward(pix, x, y, g, H, W, dxo, dyo, [&](int k, int p, float v) {
    t.p[k] = p;
    t.v[k] = v;
    t.live |= (uint32_t)on << k;
  });
  return t;
}

// Sums slot k's terms over each run of neighbouring lanes that add to the
// same pixel into the run's last lane, and drops them from the others. A
// warp's lanes hold neighbouring samples of a row; where the warp is
// clamped at the image's left or right border, up to all 32 lanes add to
// one pixel, and the shared-memory f32 add (a compare-and-swap loop)
// would take one lane a pass. Every lane of the warp calls this.
template <int k>
__device__ __forceinline__ void reduce_runs(Terms& t) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = (int)(threadIdx.x & 31);
  const bool live = t.live >> k & 1;
  const int key = live ? t.p[k] : -1 - lane;  // a dead lane is its own run
  const int before = __shfl_up_sync(kAll, key, 1);
  const unsigned starts = __ballot_sync(kAll, lane == 0 || before != key);
  const unsigned upto = starts & (0xffffffffu >> (31 - lane));
  const int run = __popc(upto);
  float v = t.v[k];
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const float w = __shfl_up_sync(kAll, v, d);
    // lane - d is in this run (runs are contiguous): the same count of
    // run starts up to it
    if (lane >= d &&
        __popc(starts & (0xffffffffu >> (31 - (lane - d)))) == run)
      v = __fadd_rn(w, v);
  }
  const unsigned ends = starts >> 1 | 0x80000000u;
  if (live) {
    t.v[k] = v;
    if (!(ends >> lane & 1)) t.live &= ~(1u << k);
  }
}

// Slots 0 and 2 (the left column) repeat along a run of lanes clamped at
// the left or right border (x0 == x1); a warp reduces them only where it
// has such a lane.
__device__ __forceinline__ void reduce_clamped(Terms& t) {
  const bool clamped = (t.live & 1) && !(t.live & 2);
  if (__any_sync(0xffffffffu, clamped)) {
    reduce_runs<0>(t);
    reduce_runs<2>(t);
  }
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
sample_bwd_image(const T* __restrict__ img, const float* __restrict__ xs,
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
    sample_backward([&](int i) { return load_f(im + i); }, __ldg(xs + o),
                    __ldg(ys + o), __ldg(gs + o), H, W, dx[o], dy[o],
                    [&](int, int i, float v) { atomicAdd(&acc[i], v); });
  }
  __syncthreads();
  float* dst = dimg + (long long)b * HW;
  for (int i = threadIdx.x; i < HW; i += kBwdThreads) dst[i] = acc[i];
}

// ---- the cluster's means (PTX for sm_90) ----

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
__device__ __forceinline__ void red_cluster(uint32_t addr, float v) {
  asm volatile("red.shared::cluster.add.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}
__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__host__ __device__ __forceinline__ int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// The image's HW elements into shared memory: 16-byte cp.async where the
// image starts 16-byte aligned, the tail (and a misaligned image) by plain
// loads. The caller commits, waits and syncs before reading.
template <typename T>
__device__ __forceinline__ void stage_image(T* tile, const T* im, int HW) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(im) & 15) == 0) {
    const int chunks = (int)(HW * sizeof(T) / 16);
    for (int c = threadIdx.x; c < chunks; c += kClusterThreads)
      cp_async16(reinterpret_cast<char*>(tile) + c * 16,
                 reinterpret_cast<const char*>(im) + c * 16);
    done = chunks * (int)(16 / sizeof(T));
  }
  for (int i = done + threadIdx.x; i < HW; i += kClusterThreads)
    tile[i] = im[i];
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every committed group but the newest has landed (this thread's copies)
__device__ __forceinline__ void cp_async_wait_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Sample k (0 to kPer - 1) of this thread in chunk c: k * 512 + ((tid +
// 32 (k + kPer c)) mod 512). A warp's lanes take neighbouring samples, and
// the warp's block of 32 moves by 32 from one k and chunk to the next, so
// the blocks a row's border clamps (the slow ones) fall to every warp in
// turn.
__device__ __forceinline__ int chunk_sample(int k, int c) {
  return k * kClusterThreads +
         (((int)threadIdx.x + 32 * (k + kPer * c)) & (kClusterThreads - 1));
}

// This thread's samples of chunk c of the CTA's [n0, n1) into ring slot
// c % kRing (x, y, g, kChunk floats each) by 4-byte cp.async, sample k at
// k * 512 + tid whichever sample it is: each thread copies what it reads
// itself into places no other thread reads or writes, so its own wait
// orders them and no block barrier is needed.
__device__ __forceinline__ void stage_chunk(float* ring, const float* xs,
                                            const float* ys, const float* gs,
                                            int n0, int n1, int c) {
  float* slot = ring + (c % kRing) * 3 * kChunk;
  const int base = n0 + c * kChunk;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int n = base + chunk_sample(k, c);
    const int j = k * kClusterThreads + (int)threadIdx.x;
    if (n < n1) {
      cp_async4(slot + j, xs + n);
      cp_async4(slot + kChunk + j, ys + n);
      cp_async4(slot + 2 * kChunk + j, gs + n);
    }
  }
}

// d_img over a cluster of C = gridDim.x / B CTAs per image (see the header).
// kTile: each CTA accumulates its samples' terms over the whole image in
// its shared memory, and after a cluster barrier sums its pixel slice over
// the cluster's tiles (distributed shared memory, in rank order). Else each
// CTA holds only its slice, and a term for another CTA's slice goes there
// by red.shared::cluster.
template <typename T, bool kStaged, bool kTile>
__global__ void __launch_bounds__(kClusterThreads)
sample_bwd_cluster(const T* __restrict__ img, const float* __restrict__ xs,
                   const float* __restrict__ ys, const float* __restrict__ gs,
                   float* __restrict__ dimg, float* __restrict__ dx,
                   float* __restrict__ dy, int H, int W, int N, int slice,
                   int span) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int HW = H * W;
  const int acc_len = kTile ? round_up(HW, 4) : slice;
  float* acc = reinterpret_cast<float*>(smem);
  float* ring = acc + acc_len;
  T* tile = reinterpret_cast<T*>(ring + kRing * 3 * kChunk);
  const int C = (int)cluster_size();
  const int r = (int)cluster_rank();
  const int b = blockIdx.x / C;
  const T* im = img + (long long)b * HW;
  const long long row = (long long)b * N;
  xs += row, ys += row, gs += row, dx += row, dy += row;
  const int n0 = r * span;
  const int n1 = min(n0 + span, N);
  const int chunks = n1 > n0 ? (n1 - n0 + kChunk - 1) / kChunk : 0;
  // every load issued first: the image, then the first kRing chunks
  if (kStaged) stage_image(tile, im, HW);
  for (int c = 0; c < kRing; ++c) {
    if (c < chunks) stage_chunk(ring, xs, ys, gs, n0, n1, c);
    cp_async_commit();
  }
  for (int i = threadIdx.x * 4; i < acc_len; i += kClusterThreads * 4)
    *reinterpret_cast<float4*>(acc + i) = make_float4(0.f, 0.f, 0.f, 0.f);
  if (!kTile) {
    cluster_arrive();
    cluster_wait();  // every slice of the cluster is zero
  }

  const T* src = kStaged ? tile : im;
  auto pix = [&](int i) {
    return kStaged ? to_f(src[i]) : load_f(src + i);
  };
  const int lo = r * slice;
  const uint32_t acc_s = smem_addr(acc);
  auto add = [&](int p, float v) {
    const int q = kTile ? p : p - lo;
    if (kTile || (unsigned)q < (unsigned)slice) {
      atomicAdd(&acc[q], v);
    } else {
      const int o = p / slice;
      red_cluster(map_rank(acc_s + (uint32_t)(p - o * slice) * 4, o), v);
    }
  };
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait_but_one();  // this thread's chunk c (and image part) landed
    if (c == 0) __syncthreads();  // the whole image
    const float* slot = ring + (c % kRing) * 3 * kChunk;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int n = n0 + c * kChunk + chunk_sample(k, c);
      const int j = k * kClusterThreads + (int)threadIdx.x;
      const bool on = n < n1;
      float ox, oy;
      Terms t = sample_terms(pix, on ? slot[j] : 0.f,
                             on ? slot[kChunk + j] : 0.f,
                             on ? slot[2 * kChunk + j] : 0.f, H, W, on, ox,
                             oy);
      if (on) dx[n] = ox, dy[n] = oy;
      reduce_clamped(t);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (t.live >> q & 1) add(t.p[q], t.v[q]);
    }
    // this thread's part of slot c % kRing is free
    if (c + kRing < chunks) stage_chunk(ring, xs, ys, gs, n0, n1, c + kRing);
    cp_async_commit();
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");  // none left in flight
  cluster_arrive();
  cluster_wait();  // every term is in its accumulator

  float* out = dimg + (long long)b * HW + lo;
  const int count = min(slice, HW - lo);
  for (int i = threadIdx.x * 4; i < count; i += kClusterThreads * 4) {
    float4 s;
    if (kTile) {
      // the slice over the cluster's tiles: every load issued, then summed
      // in rank order
      const uint32_t a = acc_s + (uint32_t)(lo + i) * 4;
      float4 part[kMaxCluster];
#pragma unroll
      for (int o = 0; o < kMaxCluster; ++o)
        if (o < C) part[o] = ld_cluster4(map_rank(a, o));
      s = part[0];
#pragma unroll
      for (int o = 1; o < kMaxCluster; ++o)
        if (o < C) s = add4(s, part[o]);
    } else {
      s = *reinterpret_cast<const float4*>(acc + i);
    }
    if (HW % 4 == 0) {
      *reinterpret_cast<float4*>(out + i) = s;
    } else {
      const float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (i + k < count) out[i + k] = v[k];
    }
  }
  if (kTile) {
    cluster_arrive();
    cluster_wait();  // no CTA leaves while another reads its tile
  }
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
cudaError_t launch_bwd_image(const void* img, const float* x, const float* y,
                             const float* g, float* dimg, float* dx,
                             float* dy, int B, int H, int W, int N,
                             cudaStream_t stream) {
  const size_t smem = (size_t)H * W * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sample_bwd_image<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  sample_bwd_image<T><<<B, kBwdThreads, smem, stream>>>(
      static_cast<const T*>(img), x, y, g, dimg, dx, dy, H, W, N);
  return cudaGetLastError();
}

// info[0..2]: registers a thread, local memory bytes a thread, and the
// clusters of C CTAs with `smem` bytes each that the card holds at once.
template <typename T, bool kStaged, bool kTile>
cudaError_t cluster_info(int C, int smem, int* info) {
  const auto kernel = sample_bwd_cluster<T, kStaged, kTile>;
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, (const void*)kernel);
  if (e != cudaSuccess) return e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute((const void*)kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg);
  if (e != cudaSuccess) return e;
  info[0] = fa.numRegs;
  info[1] = (int)fa.localSizeBytes;
  info[2] = clusters;
  return cudaSuccess;
}

template <typename T, bool kStaged, bool kTile>
cudaError_t launch_bwd_cluster(const void* img, const float* x,
                               const float* y, const float* g, float* dimg,
                               float* dx, float* dy, int B, int H, int W,
                               int N, int C, int slice, int span, int smem,
                               cudaStream_t stream) {
  const auto kernel = sample_bwd_cluster<T, kStaged, kTile>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(img), x, y, g, dimg, dx, dy, H, W,
      N, slice, span);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The cluster design's shared memory: the accumulator (the whole image's
// with `tile`, else the slice), the ring of x, y, g and, when staged, the
// image in 16-byte units.
int cluster_smem(int HW, int elt, int tile, int slice, int staged) {
  return (tile ? round_up(HW, 4) : slice) * 4 + kRing * 3 * kChunk * 4 +
         (staged ? round_up(HW * elt, 16) : 0);
}

template <typename T>
cudaError_t launch_bwd(const void* img, const float* x, const float* y,
                       const float* g, float* dimg, float* dx, float* dy,
                       int B, int H, int W, int N, int design, int C,
                       int tile, int slice, int span, int staged, int smem,
                       cudaStream_t stream) {
  const int HW = H * W;
  if (design == 0) {  // "image"
    if (C != 1 || staged || smem != HW * 4 || smem > kSmemMax)
      return cudaErrorInvalidValue;
    return launch_bwd_image<T>(img, x, y, g, dimg, dx, dy, B, H, W, N,
                               stream);
  }
  // the plan (kernels/grid_sample.py::plan) must be the kernel's own
  if (design != 1 || C < 1 || C > kMaxCluster || slice % 4 ||
      (long long)slice * C < HW || span % 4 || (long long)span * C < N ||
      smem != cluster_smem(HW, (int)sizeof(T), tile, slice, staged) ||
      smem > kSmemMax || (staged && !tile))
    return cudaErrorInvalidValue;
#define CRNN_LAUNCH(kS, kT)                                                 \
  launch_bwd_cluster<T, kS, kT>(img, x, y, g, dimg, dx, dy, B, H, W, N, C,  \
                                slice, span, smem, stream)
  if (tile)
    return staged ? CRNN_LAUNCH(true, true) : CRNN_LAUNCH(false, true);
  return CRNN_LAUNCH(false, false);
#undef CRNN_LAUNCH
}

template <typename T>
cudaError_t info_of(int tile, int staged, int C, int smem, int* info) {
  if (tile)
    return staged ? cluster_info<T, true, true>(C, smem, info)
                  : cluster_info<T, false, true>(C, smem, info);
  return cluster_info<T, false, false>(C, smem, info);
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

// The same inputs and g (B, N) f32 -> d_img (B, H, W) f32, dx, dy (B, N) f32,
// on the launch kernels/grid_sample.py::plan gives: design 0 "image" (C 1,
// smem H * W * 4) or 1 "cluster": C CTAs an image, each accumulating the
// whole image (tile 1) or its slice (tile 0), `slice` pixels and `span`
// samples a CTA, the image staged in shared memory or not, `smem` bytes a
// CTA. A plan the kernel does not take returns cudaErrorInvalidValue.
extern "C" int crnn_grid_sample_bwd(const void* img, const void* x,
                                    const void* y, const void* g, void* dimg,
                                    void* dx, void* dy, int B, int H, int W,
                                    int N, int bf16, int design, int cluster,
                                    int tile, int slice, int span, int staged,
                                    int smem, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  const float* gf = static_cast<const float*>(g);
  float* di = static_cast<float*>(dimg);
  float* dxf = static_cast<float*>(dx);
  float* dyf = static_cast<float*>(dy);
  const cudaError_t e =
      bf16 ? launch_bwd<__nv_bfloat16>(img, xf, yf, gf, di, dxf, dyf, B, H,
                                       W, N, design, cluster, tile, slice,
                                       span, staged, smem, s)
           : launch_bwd<float>(img, xf, yf, gf, di, dxf, dyf, B, H, W, N,
                               design, cluster, tile, slice, span, staged,
                               smem, s);
  return (int)e;
}

// A cluster design's instance (the image's dtype, tile or slice, staged or
// not) at C CTAs of `smem` bytes: info[0] registers a thread, info[1] local
// memory bytes a thread, info[2] the clusters the card holds at once.
extern "C" int crnn_grid_sample_bwd_info(int bf16, int tile, int staged,
                                         int cluster, int smem, int* info) {
  if (staged && !tile) return (int)cudaErrorInvalidValue;
  return (int)(bf16 ? info_of<__nv_bfloat16>(tile, staged, cluster, smem,
                                             info)
                    : info_of<float>(tile, staged, cluster, smem, info));
}

extern "C" const char* crnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
