// CTC alpha and beta recursions over the extended label sequence.
//
// Replaces crnn_ocr_tpu/kernels/ctc_loss.py::_run_fwd (K6, the alpha
// recursion _fwd_kernel) and ::_run_bwd (K7, the beta recursion
// _bwd_kernel). Blank is C - 1; the extended sequence of a label of length
// L is blank, l1, blank, l2, ..., blank: S = 2L + 1 states. Per sample b,
// with emits e[b][t][s] = log_probs[b][t][ext[b][s]] gathered by the caller:
//
//   alpha[0][s]  = e[0][s] on the init states (s < 2, s < 1 for an empty
//                  label), NEG elsewhere
//   alpha[t][s]  = lse(alpha[t-1][s], alpha[t-1][s-1],
//                      skip[s] ? alpha[t-1][s-2] : NEG) + e[t][s]
//                  on valid states (s < 2 * label_length + 1), NEG elsewhere;
//                  frozen (alpha[t] = alpha[t-1]) once t >= input_length
//   beta[t][s]   excludes the emission at t: seeded to 0 on the two end
//                  states at t == input_length - 1, then
//   beta[t-1][s] = lse(be[s], be[s+1], skip[s+2] ? be[s+2] : NEG),
//                  be[s] = valid[s] ? beta[t][s] + e[t][s] : NEG,
//                  and frozen while t > input_length - 1.
//
// lse is the TPU kernel's _lse3: max-shifted, with NEG = -1e30 standing for
// log 0 and a result of NEG wherever the max is below NEG / 2. The per-state
// flags (bit 0 valid, 1 init, 2 skip, 3 end) come from the caller.
//
// Layout: (B, T, S) for emits, alphas and betas, so one sample is one
// contiguous T x S slab; not the TPU's (T, S, B) with the batch on the
// 128 lanes and T padded to its CHUNK.
//
// Two designs, chosen by the caller's plan (kernels/ctc_loss.py::plan):
//
// "pipelined" (the path's): one CTA a sample, thread s holds state s, so
// W = ceil(S / 32) warps. What stays on chip: the states in registers; the
// neighbours s - 1, s - 2 (alpha) or s + 1, s + 2 (beta) in another lane
// of the warp by two shuffles; at a warp's edge, the two states the next
// warp needs handed over through shared-memory slots, one pair a frame,
// written once (a signalling NaN marks a slot empty), so the warps run
// the chain as a pipeline, each a frame behind the one it takes from, with
// no block barrier a frame; the emissions staged by 4-byte cp.async (a
// slab starts at b * T * S floats, 16-byte aligned only when T * S is a
// multiple of 4) in each warp's ring of two 16-frame chunks, the next
// chunk in flight, each thread copying what it reads itself. Outputs are
// stored from registers (a warp's row is coalesced) and nothing on the
// chain reads them. The log-sum-exps run in log2 units on the MUFU's ex2
// and lg2 (emissions scaled as they are read, outputs as they are stored;
// NEG stays NEG exactly): expf and logf are longer dependent sequences,
// and every frame waits on them. The chain
// stops at the sample's own input length: alpha's later frames are copies
// of its frozen value and beta's are NEG, written without it.
//
// "block" (the first design): one block a sample, one thread a state, neighbours
// through a double-buffered shared row and one __syncthreads a frame; each
// thread loads its emission from device memory inside the frame; expf and
// logf, as the TPU kernel computes them. Kept for comparison and for the
// shapes whose hand-over slots do not fit a CTA's shared memory.
//
// Bound on the H100 at the training path (B = 128, T = 62, S = 65): bytes,
// emits 2.06 MB in + alphas (or betas) 2.06 MB out, about 1.24 us per
// kernel at 3.35 TB/s; the operations are negligible. The real limit is the
// chain of dependent frames (T - 1 for alpha, T for beta), each a shuffle,
// three ex2, a lg2 and a few adds, maxes and selects, and the pipeline's
// fill: measured there (tools/time_ctc_designs.py; NVIDIA H100 80GB HBM3,
// 700 W) K6 takes 7.7 us (block 13.2) and K7 8.0 us (block 22.3), about
// 0.095 us a frame at the margin (T 124 against T 62) and 2 us besides.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kValid = 1, kInit = 2, kSkip = 4, kEnd = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlock = 0, kPipelined = 1;  // design codes
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;
// a CTA's shared memory without the opt-in attribute, and with it
constexpr int kDefaultSmem = 48 * 1024, kMaxSmem = 232448;

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const float ms = fmaxf(m, kNeg);
  const float out = ms + logf(expf(a - ms) + expf(b - ms) + expf(c - ms));
  return m > kNeg / 2 ? out : kNeg;
}

__global__ void ctc_alpha_kernel(const float* __restrict__ emits,
                                 const int* __restrict__ flags,
                                 const int* __restrict__ lens,
                                 float* __restrict__ alphas, int T, int S) {
  extern __shared__ float sh[];  // 2 buffers of S + 2, states at [2, S + 2)
  float* buf[2] = {sh, sh + S + 2};
  const int b = blockIdx.x, s = threadIdx.x;
  const bool on = s < S;
  const int f = on ? flags[b * S + s] : 0;
  const int len = lens[b];
  if (s < 2) buf[0][s] = buf[1][s] = kNeg;
  const float* e = emits + (size_t)b * T * S + s;
  float* out = alphas + (size_t)b * T * S + s;
  float a = kNeg;
  if (on) {
    a = (f & kInit) ? e[0] : kNeg;
    out[0] = a;
    buf[0][s + 2] = a;
  }
  for (int t = 1; t < T; ++t) {
    const float em = on ? e[(size_t)t * S] : 0.f;
    __syncthreads();
    const float* prev = buf[(t - 1) & 1];
    if (on) {
      const float a1 = prev[s + 1];
      const float a2 = (f & kSkip) ? prev[s] : kNeg;
      float n = lse3(a, a1, a2) + em;
      n = (f & kValid) ? n : kNeg;
      if (t < len) a = n;
      buf[t & 1][s + 2] = a;
      out[(size_t)t * S] = a;
    }
  }
}

__global__ void ctc_beta_kernel(const float* __restrict__ emits,
                                const int* __restrict__ flags,
                                const int* __restrict__ lens,
                                float* __restrict__ betas, int T, int S) {
  extern __shared__ float sh[];  // 2 buffers of S + 2, pads at [S, S + 2)
  float* buf[2] = {sh, sh + S + 2};
  const int b = blockIdx.x, s = threadIdx.x;
  const bool on = s < S;
  const int f = on ? flags[b * S + s] : 0;
  const bool skip2 = s + 2 < S && (flags[b * S + s + 2] & kSkip);
  const int len = lens[b];
  if (s < 2) buf[0][S + s] = buf[1][S + s] = kNeg;
  const float* e = emits + (size_t)b * T * S + s;
  float* out = betas + (size_t)b * T * S + s;
  float beta = kNeg;
  for (int t = T - 1; t >= 0; --t) {
    const float em = on ? e[(size_t)t * S] : 0.f;
    if (t == len - 1 && (f & kEnd)) beta = 0.f;
    float* cur = buf[t & 1];
    const float be = (f & kValid) ? beta + em : kNeg;
    if (on) {
      out[(size_t)t * S] = beta;
      cur[s] = be;
    }
    __syncthreads();
    if (on && t <= len - 1) {
      const float up1 = cur[s + 1];
      const float up2 = skip2 ? cur[s + 2] : kNeg;
      beta = lse3(be, up1, up2);
    }
  }
}

int block_threads(int S) { return (S + 31) / 32 * 32; }

// ----------------------------------------------------------- pipelined

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// lse3's parts on values in log2 units (x * log2 e), on the MUFU's ex2 and
// lg2, with lse3's max shift: the shift ms (a, the lane's own value, is
// known before the neighbours arrive, so only two maxes wait for them) and
// lg2 of the shifted exponentials' sum. lse3 is NEG unless ms > NEG / 2.
__device__ __forceinline__ float shift3(float a_neg, float b, float c) {
  return fmaxf(a_neg, fmaxf(b, c));  // a_neg = fmaxf(a, NEG)
}

__device__ __forceinline__ float lg2_sum3(float a, float b, float c,
                                          float ms) {
  return lg2(ex2(a - ms) + ex2(b - ms) + ex2(c - ms));
}

// A value in log2 units back to the natural log; NEG stays NEG exactly
__device__ __forceinline__ float to_ln(float y) {
  return y > kNeg / 2 ? y * kLn2 : kNeg;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every committed group but the newest has landed
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// A thread's emissions, staged by cp.async in a ring of two chunks of
// kChunk frames in its warp's shared memory ([2][kChunk][32], a lane its
// own column: no bank conflict). Chunk c holds the chain's frames i in
// [c kChunk, c kChunk + kChunk), frame i at t = t0 + dir * i. Each thread
// copies what it reads itself, so only cp.async's groups order them: the
// frame loop runs a chunk at a time, and between two chunks the buffer
// just read takes the chunk after next (after a __syncwarp) and the next
// chunk is waited for. Nothing on the chain of frames waits on device
// memory, and no frame tests for a chunk's end.
constexpr int kChunk = 16;

struct Ring {
  float* buf;      // this warp's [2][kChunk][32], at the lane's column
  const float* e;  // the sample's slab, at the thread's state
  bool on;         // the state is one of the sample's S
  int n, S, t0, dir;  // n frames staged

  __device__ __forceinline__ void stage(int c) const {
    float* dst = buf + (c & 1) * kChunk * 32;
    const int i0 = c * kChunk, i1 = min(i0 + kChunk, n);
    if (on)
      for (int i = i0; i < i1; ++i)
        cp_async4(dst + (i - i0) * 32, e + (size_t)(t0 + dir * i) * S);
    cp_async_commit();  // an empty group past the last chunk keeps the count
  }

  // chunk c's frames, landed (the first two chunks staged by the caller)
  __device__ __forceinline__ const float* chunk(int c) const {
    if (c > 0) {
      __syncwarp();  // chunk c - 1's reads before its buffer's refill
      stage(c + 1);
    }
    cp_async_wait_all_but_one();
    return buf + (c & 1) * kChunk * 32;
  }
};

// A hand-over slot: written once by a lane of one warp, read by the lanes
// of the neighbouring warp once it holds a value (a signalling NaN, which
// no arithmetic produces, marks it empty; 4-byte accesses are single-copy
// atomic, so the value is the flag). A frame's two slots are adjacent and
// read by one 8-byte load.
constexpr unsigned kEmpty = 0x7fbadbadu;

__device__ __forceinline__ void hand_over(float* slot, float v) {
  *reinterpret_cast<volatile float*>(slot) = v;
}

__device__ __forceinline__ float2 peek(const float* slot) {
  float2 v;
  asm volatile("ld.volatile.shared.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(slot))));
  return v;
}

__device__ __forceinline__ bool empty(float2 v) {
  return __float_as_uint(v.x) == kEmpty || __float_as_uint(v.y) == kEmpty;
}

// the slots' values, once written (the whole warp spins together)
__device__ __forceinline__ float2 take(const float* slot) {
  float2 v = peek(slot);
  while (__any_sync(kFull, empty(v))) v = peek(slot);
  return v;
}

// The values a warp takes, read a frame ahead: a taking warp starts its
// chain only once the warp it takes from has finished frame 1 (alpha) or
// handed over frame n - 2 (beta), so it runs a frame behind, and each
// frame, once it has used its slots' values, reads the next frame's: their
// load is off the chain. The rare frame that finds them empty (the warp
// taken from fell behind) waits for them.
template <bool kTakes>
struct Taken {
  const float* from;  // the slots of the warp taken from, [T][2]
  float2 v;           // a frame's values, maybe still empty

  // frame f0's values, once frame f1's are there too
  __device__ __forceinline__ void start(int f0, int f1) {
    v = make_float2(kNeg, kNeg);
    if (kTakes) {
      take(from + f1 * 2);
      v = take(from + f0 * 2);
    }
  }

  // frame f's values, read a frame ago
  __device__ __forceinline__ float2 at(int f) {
    if (kTakes && __any_sync(kFull, empty(v))) v = take(from + f * 2);
    return v;
  }

  // read frame f's values, for the next frame
  __device__ __forceinline__ void read(int f) {
    if (kTakes) v = peek(from + f * 2);
  }
};

// Shared memory: the hand-over slots [W - 1][T][2], then the warps' rings.
__device__ __forceinline__ float* warp_ring(float* smem, int W, int T, int w,
                                           int lane) {
  return smem + (W - 1) * T * 2 + w * 2 * kChunk * 32 + lane;
}

// every slot empty, before any is written or read (K6 clears them after
// its ring's first loads are issued, so their latency covers it)
__device__ __forceinline__ void clear_slots(float* smem, int W, int T) {
  for (int i = threadIdx.x; i < (W - 1) * T * 2; i += blockDim.x)
    smem[i] = __uint_as_float(kEmpty);
  __syncthreads();  // the kernel's one block-wide barrier
}

// K6's frames 1..n-1 for one thread (state s, lane of its warp). A frame:
// two shuffles of the previous frame's alphas, with s - 1 and s - 2 of
// lanes 0 and 1 from lanes 30 and 31 of the warp below (kTakes: its
// slots, read a frame ahead); the previous frame's store and this frame's
// emission; then the log-sum-exp, which lanes 30 and 31 hand over.
template <bool kTakes>
__device__ __forceinline__ float alpha_frames(const Ring& ring,
                                              const float* em, float a,
                                              float* out, int f, int lane,
                                              int S, int n, bool on,
                                              bool gives, float* give,
                                              const float* from) {
  const bool skip = f & kSkip, valid = f & kValid;
  Taken<kTakes> h{from};
  h.start(0, min(1, n - 1));
  for (int c = 0, t = 1;;) {
    // frames t of chunk c: t - c kChunk is the emission's slot
#pragma unroll 2
    for (const int end = min(c * kChunk + kChunk, n); t < end; ++t) {
      const float r1 = __shfl_sync(kFull, a, (lane + 31) & 31);
      const float r2 = __shfl_sync(kFull, a, (lane + 30) & 31);
      const float2 h1 = h.at(t - 1);  // warp w - 1's lanes 30, 31 at t - 1
      const float prev = to_ln(a);
      if (on) *out = prev;  // frame t - 1
      out += S;
      const float e = em[(t - c * kChunk) * 32] * kLog2e;
      const float m1 = lane >= 1 ? r1 : h1.y;
      const float m2 = !skip          ? kNeg
                       : lane >= 2    ? r2
                       : lane == 1    ? h1.y
                                      : h1.x;
      h.read(t);
      const float ms = shift3(fmaxf(a, kNeg), m1, m2);
      const float nx = (ms + e) + lg2_sum3(a, m1, m2, ms);
      a = valid && ms > kNeg / 2 ? nx : kNeg;
      if (gives) hand_over(give + t * 2, a);
    }
    if (t >= n) break;
    em = ring.chunk(++c);
  }
  return a;
}

// K6. Thread s of the CTA holds state s; the CTA's warps run the chain as
// a pipeline, warp w a frame behind warp w - 1.
__global__ void ctc_alpha_pipelined_kernel(const float* __restrict__ emits,
                                           const int* __restrict__ flags,
                                           const int* __restrict__ lens,
                                           float* __restrict__ alphas, int T,
                                           int S) {
  extern __shared__ float smem[];
  const int W = blockDim.x / 32, b = blockIdx.x, s = threadIdx.x;
  const int w = s / 32, lane = s % 32;
  const bool on = s < S;
  const int f = on ? flags[b * S + s] : 0;
  const int n = min(max(lens[b], 1), T);  // frames 0..n-1 run the chain
  // the ring stages frames up to T, not n: its first loads need not wait
  // for the input length's
  const Ring ring{warp_ring(smem, W, T, w, lane),
                  emits + (size_t)b * T * S + s, on, T, S, 0, 1};
  ring.stage(0);
  ring.stage(1);
  clear_slots(smem, W, T);
  // where this warp hands over (lanes 30, 31) and takes (lanes 0, 1)
  const bool gives = w < W - 1 && lane >= 30;
  float* give = smem + (size_t)(gives ? w : 0) * T * 2 + (lane & 1);
  const float* from = smem + (size_t)(w > 0 ? w - 1 : 0) * T * 2;
  float* out = alphas + (size_t)b * T * S + s;
  const float* em = ring.chunk(0);
  float a = (f & kInit) ? em[0] * kLog2e : kNeg;  // log2 units
  if (gives) hand_over(give, a);
  a = w > 0 ? alpha_frames<true>(ring, em, a, out, f, lane, S, n, on, gives,
                                 give, from)
            : alpha_frames<false>(ring, em, a, out, f, lane, S, n, on,
                                  gives, give, from);
  const float last = to_ln(a);
  if (on)  // the last frame, then frozen
    for (int t = n - 1; t < T; ++t) out[(size_t)t * S] = last;
}

// K7's chain steps for one thread: step i takes frame t = n - 1 - i from
// beta and be = beta + e at t to beta at t - 1 and be with the emission of
// frame t - 1 (chain frame i + 1, its slot i + 1 - c kChunk); frame 0's
// step would only feed beta at -1. Mirrored: lanes 0 and 1 hand over be,
// lanes 30 and 31 take s + 1 and s + 2 from the warp above.
template <bool kTakes>
__device__ __forceinline__ void beta_frames(const Ring& ring, const float* em,
                                            float beta, float be, float* out,
                                            int f,
                                             bool skip2, int lane, int S,
                                             int n, bool on, bool gives,
                                             float* give, const float* from) {
  const bool valid = f & kValid;
  Taken<kTakes> h{from};
  if (n > 1) h.start(n - 1, max(n - 2, 1));  // slots n - 1..1 are handed over
  for (int c = 0, i = 0;;) {
#pragma unroll 2
    for (const int end = min(c * kChunk + kChunk, n) - 1; i < end; ++i) {
      const int t = n - 1 - i;
      if (gives) hand_over(give + t * 2, be);
      const float r1 = __shfl_sync(kFull, be, (lane + 1) & 31);
      const float r2 = __shfl_sync(kFull, be, (lane + 2) & 31);
      const float2 h1 = h.at(t);  // warp w + 1's lanes 0, 1 at t
      const float cur = to_ln(beta);
      if (on) *out = cur;  // frame t
      out -= S;
      const float e = em[(i + 1 - c * kChunk) * 32] * kLog2e;
      const float p1 = lane <= 30 ? r1 : h1.x;
      const float p2 = !skip2         ? kNeg
                       : lane <= 29   ? r2
                       : lane == 30   ? h1.x
                                      : h1.y;
      h.read(t - 1);
      const float ms = shift3(fmaxf(be, kNeg), p1, p2);
      const float l = lg2_sum3(be, p1, p2, ms);
      const bool live = ms > kNeg / 2;
      beta = live ? ms + l : kNeg;
      be = valid && live ? (ms + e) + l : kNeg;
    }
    if (i >= n - 1) break;
    em = ring.chunk(++c);
  }
  if (on) *out = to_ln(beta);  // frame 0
}

// K7, mirrored: the warps run the chain from the top warp down.
__global__ void ctc_beta_pipelined_kernel(const float* __restrict__ emits,
                                          const int* __restrict__ flags,
                                          const int* __restrict__ lens,
                                          float* __restrict__ betas, int T,
                                          int S) {
  extern __shared__ float smem[];
  const int W = blockDim.x / 32, b = blockIdx.x, s = threadIdx.x;
  const int w = s / 32, lane = s % 32;
  clear_slots(smem, W, T);
  const bool on = s < S;
  const int f = on ? flags[b * S + s] : 0;
  const bool skip2 = s + 2 < S && (flags[b * S + s + 2] & kSkip);
  const int len = lens[b];
  const int n = max(min(len, T), 0);  // frames n-1..0 run the chain
  float* out = betas + (size_t)b * T * S + s;
  if (on)  // NEG past the input length
    for (int t = n; t < T; ++t) out[(size_t)t * S] = kNeg;
  if (n == 0) return;
  const Ring ring{warp_ring(smem, W, T, w, lane),
                  emits + (size_t)b * T * S + s, on, n, S, n - 1, -1};
  ring.stage(0);
  ring.stage(1);
  // where this warp hands over (lanes 0, 1) and takes (lanes 30, 31)
  const bool gives = w > 0 && lane < 2;
  float* give = smem + (size_t)(gives ? w - 1 : 0) * T * 2 + (lane & 1);
  const float* from = smem + (size_t)(w < W - 1 ? w : 0) * T * 2;
  // beta at frame n - 1: 0 on the end states where the input length ends
  const float* em = ring.chunk(0);
  const float beta = n == len && (f & kEnd) ? 0.f : kNeg;  // log2 units
  const float be = (f & kValid) ? beta + em[0] * kLog2e : kNeg;
  out += (size_t)(n - 1) * S;
  if (w < W - 1)
    beta_frames<true>(ring, em, beta, be, out, f, skip2, lane, S, n, on,
                      gives, give, from);
  else
    beta_frames<false>(ring, em, beta, be, out, f, skip2, lane, S, n, on,
                       gives, give, from);
}

// The plan's shared memory: the hand-over slots and the warps' rings
size_t pipelined_smem(int W, int T) {
  return ((size_t)(W - 1) * T * 2 + (size_t)W * 2 * kChunk * 32) *
         sizeof(float);
}

int run(bool beta, const void* emits, const void* flags, const void* lens,
        void* out, int B, int T, int S, int design, int warps,
        int ring_frames, int smem_bytes, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* e = static_cast<const float*>(emits);
  const auto* fl = static_cast<const int*>(flags);
  const auto* ln = static_cast<const int*>(lens);
  auto* o = static_cast<float*>(out);
  if (B < 1 || T < 1 || S < 1 || S > 1024 || warps != (S + 31) / 32)
    return (int)cudaErrorInvalidValue;
  if (design == kBlock) {
    // the plan's bytes: 2 rows of S + 2 floats
    if (smem_bytes != 2 * (S + 2) * (int)sizeof(float))
      return (int)cudaErrorInvalidValue;
    if (beta)
      ctc_beta_kernel<<<B, block_threads(S), smem_bytes, st>>>(e, fl, ln, o,
                                                               T, S);
    else
      ctc_alpha_kernel<<<B, block_threads(S), smem_bytes, st>>>(e, fl, ln, o,
                                                                T, S);
    return (int)cudaGetLastError();
  }
  if (design != kPipelined || ring_frames != kChunk ||
      (size_t)smem_bytes != pipelined_smem(warps, T) ||
      smem_bytes > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  auto kernel = beta ? ctc_beta_pipelined_kernel : ctc_alpha_pipelined_kernel;
  if (smem_bytes > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<B, 32 * warps, smem_bytes, st>>>(e, fl, ln, o, T, S);
  return (int)cudaGetLastError();
}

}  // namespace

// K6: emits (B, T, S) f32, flags (B, S) int32, lens (B,) int32 ->
// alphas (B, T, S) f32. S <= 1024. The design (0 block, 1 warp), the
// states a lane, the ring's frames and the shared-memory bytes are the
// plan's (kernels/ctc_loss.py::plan); a plan this file does not compute
// the same way is refused with cudaErrorInvalidValue.
extern "C" int crnn_ctc_alpha(const void* emits, const void* flags,
                              const void* lens, void* alphas, int B, int T,
                              int S, int design, int warps,
                              int ring_frames, int smem_bytes, void* stream) {
  return run(false, emits, flags, lens, alphas, B, T, S, design, warps,
             ring_frames, smem_bytes, stream);
}

// K7: the same inputs -> betas (B, T, S) f32.
extern "C" int crnn_ctc_beta(const void* emits, const void* flags,
                             const void* lens, void* betas, int B, int T,
                             int S, int design, int warps,
                             int ring_frames, int smem_bytes, void* stream) {
  return run(true, emits, flags, lens, betas, B, T, S, design, warps,
             ring_frames, smem_bytes, stream);
}

extern "C" const char* crnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
