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
// Design: one block per sample, one thread per extended state. A thread
// keeps its own alpha (or beta) in a register; the previous frame's values
// of its neighbours come through shared memory, double-buffered so one
// __syncthreads per frame suffices (a buffer is rewritten two frames later,
// after every thread has passed the barrier between). Each thread loads its
// emission for the frame before the barrier, so the load's latency overlaps
// the wait. Two NEG pads in front of the alpha buffer (behind the beta
// buffer) make the shifted reads branch-free.
//
// Bound on the H100 at the training path (B = 128, T = 62, S = 65): bytes,
// emits 4.1 MB in + alphas (or betas) 4.1 MB out, ~8.3 MB for the pair,
// about 1.2 us per kernel at 3.35 TB/s; the operations are negligible. The
// real limit is the chain of T - 1 dependent frames, each a barrier plus
// three exps and a log: the grid (128 blocks of 96 threads) cannot hide
// that latency, which is why one block carries a whole sample and no
// frame waits on device memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kValid = 1, kInit = 2, kSkip = 4, kEnd = 8;

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

}  // namespace

// K6: emits (B, T, S) f32, flags (B, S) int32, lens (B,) int32 ->
// alphas (B, T, S) f32. S <= 1024.
extern "C" int crnn_ctc_alpha(const void* emits, const void* flags,
                              const void* lens, void* alphas, int B, int T,
                              int S, void* stream) {
  const size_t smem = 2 * (size_t)(S + 2) * sizeof(float);
  ctc_alpha_kernel<<<B, block_threads(S), smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(emits), static_cast<const int*>(flags),
      static_cast<const int*>(lens), static_cast<float*>(alphas), T, S);
  return (int)cudaGetLastError();
}

// K7: the same inputs -> betas (B, T, S) f32.
extern "C" int crnn_ctc_beta(const void* emits, const void* flags,
                             const void* lens, void* betas, int B, int T,
                             int S, void* stream) {
  const size_t smem = 2 * (size_t)(S + 2) * sizeof(float);
  ctc_beta_kernel<<<B, block_threads(S), smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(emits), static_cast<const int*>(flags),
      static_cast<const int*>(lens), static_cast<float*>(betas), T, S);
  return (int)cudaGetLastError();
}

extern "C" const char* crnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
