// CTC forward-backward, hand-written for Hopper (sm_90a).
//
// Replaces: handwriting_line_generation_tpu/ops/ctc_pallas.py:_kernel, the
// Pallas TPU kernel behind ctc_loss_pallas.  For each sample b, over the
// blank-interleaved label ext = (0, l1, 0, l2, ..., 0) of S = 2L + 1 states,
// of which the first Sv = 2 * len + 1 are valid:
//
//   emit(t, s)  = logp[b, t, ext[s]]
//   alpha(0, s) = emit(0, s) for s < 2, else NEG
//   alpha(t, s) = emit(t, s) + lse(alpha(t-1, s), alpha(t-1, s-1),
//                                 alpha(t-1, s-2) if can_skip[s])
//   ll          = lse(alpha(T-1, send), alpha(T-1, send-1) if len > 0),
//                 send = 2 * len;  nll[b] = -ll
//   beta(T-1, s) = 0 for s in {send, max(send-1, 0)}, else NEG
//   beta(t, s)  = lse(g(s), g(s+1), g(s+2) if can_skip[s+2]),
//                 g = beta(t+1, .) + emit(t+1, .)
//   grad[b, t, c] = -sum_{s < Sv, ext[s] == c} exp(clip(alpha + beta - ll,
//                                                       -60, 60))
//
// with lse(a, b, c) = m + log(exp(a - m) + exp(b - m) + exp(c - m)) for the
// largest m, invalid states and absent moves at NEG = -1e30 (never -inf), as
// the JAX scan (ops/ctc.py) and the Pallas kernel compute it.  expf / logf
// (not the __expf / __logf intrinsics) keep it within a few float32 ulps of
// the plain PyTorch version (ops/ctc.py:ctc_loss).  The gradient is taken
// with respect to log_probs.  Samples that are impossible come out with a
// huge nll; the caller zeroes their loss and gradient.
//
// Bound: bytes.  The function must read logp once and write grad once:
// 2 * B * T * C * 4 bytes, about 2.6 MB (under a microsecond at 3.35 TB/s)
// for B = 16, T = 256, C = 80; its ~40 float operations per (t, s) cell
// are far less.  What really sets the time is the chain of 2T dependent
// steps, each a log-sum-exp over neighbouring states that must wait for the
// whole previous row.
//
// Design.  One block per sample, one thread per state s (blockDim = S
// rounded up to a warp, at least 64).  The TPU kernel turns the emission
// gather into a one-hot matmul because gathers are slow there; here each
// thread gathers its logp[t, ext[s]] directly (a 320-byte row, cached), and
// loads the next step's emission (and, going backward, its own alpha) while
// it computes this one, so the load latency stays off the chain.  The alpha
// row is double-buffered in shared memory, so each step costs one
// __syncthreads().  Alphas go to a caller-allocated float32 scratch
// [B, T, S] (a few MB, resident in L2) when the gradient is asked for; the
// beta pass runs backward in the same launch
// with the same one-sync-per-step double buffering, writing each state's
// occupancy to shared memory.  Each gradient row is then summed per class in
// a fixed order with no atomics, so runs repeat bit for bit: warp 0 reduces
// the even (blank) states with a fixed shuffle tree, and every other class
// walks the list of label positions that hold it (built once per sample), so
// a class absent from the label writes 0.  The grid has only B blocks, so at
// B = 16 most of the card's 132 SMs idle: the kernel is latency-bound by
// design; batching several samples per SM or splitting the state axis over
// a cluster is later work.

#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kClip = 60.0f;
constexpr int kMaxThreads = 1024;

// m + log(exp(a - m) + exp(b - m) + exp(c - m)) for m the largest of the
// three, as the Pallas kernel's beta step computes it
__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  return m + logf((expf(a - m) + expf(b - m)) + expf(c - m));
}

__global__ void ctc_kernel(const float* __restrict__ logp,
                           const int* __restrict__ labels,
                           const int* __restrict__ label_lengths,
                           float* __restrict__ nll, float* __restrict__ grad,
                           float* __restrict__ alpha_scr, int T, int L, int C,
                           int compute_grad) {
  extern __shared__ float smem[];
  const int S = 2 * L + 1;
  float* abuf = smem;              // [2][S]  alpha, then g = beta + emit
  float* obuf = abuf + 2 * S;      // [2][S]  occupancy
  int* first = reinterpret_cast<int*>(obuf + 2 * S);  // [C] first label pos
  int* next = first + C;           // [L]     next label pos of one class
  __shared__ float ll_sh;

  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const float* lp = logp + (size_t)b * T * C;
  const int* lab = labels + (size_t)b * L;
  int len = label_lengths[b];
  len = len < 0 ? 0 : (len > L ? L : len);
  const int sv = 2 * len + 1;      // valid states
  const int send = 2 * len;

  // this thread's state: class, validity, skip moves into s and into s + 2
  auto ext_at = [&](int i) -> int { return (i & 1) ? lab[i >> 1] : 0; };
  const bool valid = s < sv;
  const int ext = valid ? ext_at(s) : 0;
  // a label outside [0, C) makes its states unreachable (never read out of
  // bounds); the sample then comes out impossible
  const bool in_range = ext >= 0 && ext < C;
  const bool skip = valid && s >= 2 && ext != 0 && ext != ext_at(s - 2);
  const bool skip2 = s + 2 < sv && ext_at(s + 2) != 0 &&
                     ext_at(s + 2) != ext_at(s);
  auto emit = [&](int t) -> float {
    return (valid && in_range) ? lp[(size_t)t * C + ext] : kNeg;
  };

  // ---- alpha ----
  float e_next = T > 1 ? emit(1) : 0.0f;
  float a = (s < 2 && valid) ? emit(0) : kNeg;
  if (s < S) {
    abuf[s] = a;
    if (compute_grad) alpha_scr[((size_t)b * T) * S + s] = a;
  }
  __syncthreads();
  for (int t = 1; t < T; ++t) {
    const float e = e_next;
    if (t + 1 < T) e_next = emit(t + 1);
    const float* prev = abuf + ((t - 1) & 1) * S;
    float* cur = abuf + (t & 1) * S;
    if (s < S) {
      float na = kNeg;
      if (valid) {
        const float a0 = prev[s];
        const float a1 = s >= 1 ? prev[s - 1] : kNeg;
        const float a2 = skip ? prev[s - 2] : kNeg;
        // m clamped at NEG, as the scan does
        const float ms = fmaxf(fmaxf(fmaxf(a0, a1), a2), kNeg);
        const float tot = (expf(a0 - ms) + expf(a1 - ms)) + expf(a2 - ms);
        na = (e + ms) + logf(tot);
      }
      cur[s] = na;
      if (compute_grad) alpha_scr[((size_t)b * T + t) * S + s] = na;
    }
    __syncthreads();
  }

  // ---- negative log-likelihood ----
  if (s == 0) {
    const float* last = abuf + ((T - 1) & 1) * S;
    const float ab = last[send];
    const float al = len > 0 ? last[send - 1] : kNeg;
    const float m = fmaxf(ab, al);
    const float ll = m + logf(expf(ab - m) + expf(al - m));
    ll_sh = ll;
    nll[b] = -ll;
  }
  if (!compute_grad) return;
  // per-class lists of label positions, in increasing order
  for (int c = s; c < C; c += blockDim.x) first[c] = -1;
  __syncthreads();
  if (s == 0) {
    for (int j = len - 1; j >= 0; --j) {
      const int c = lab[j];
      if (c >= 1 && c < C) {
        next[j] = first[c];
        first[c] = j;
      }
    }
  }
  __syncthreads();
  const float ll = ll_sh;
  const float* arow = alpha_scr + (size_t)b * T * S;
  float* grow = grad + (size_t)b * T * C;

  // ---- beta, fused with the gradient ----
  const bool pick = s == send || s == (send > 0 ? send - 1 : 0);
  float beta = (valid && pick) ? 0.0f : kNeg;
  e_next = T > 1 ? emit(T - 2) : 0.0f;
  float e = emit(T - 1);
  // this thread's own alphas, read back one step ahead
  float a_cur = valid ? arow[(size_t)(T - 1) * S + s] : kNeg;
  for (int t = T - 1; t >= 0; --t) {
    float* gcur = abuf + (t & 1) * S;
    float* ocur = obuf + (t & 1) * S;
    if (t < T - 1 && s < S) {
      const float* gprev = abuf + ((t + 1) & 1) * S;
      beta = kNeg;
      if (valid) {
        const float g0 = gprev[s];
        const float g1 = s + 1 < sv ? gprev[s + 1] : kNeg;
        const float g2 = skip2 ? gprev[s + 2] : kNeg;
        beta = lse3(g0, g1, g2);
      }
    }
    if (t < T - 1) {
      e = e_next;
      if (t >= 1) e_next = emit(t - 1);
    }
    if (s < S) {
      float occ = 0.0f;
      if (valid) {
        const float x = a_cur + beta - ll;
        occ = expf(fminf(fmaxf(x, -kClip), kClip));
        if (t >= 1) a_cur = arow[(size_t)(t - 1) * S + s];
      }
      ocur[s] = occ;
      gcur[s] = beta + e;
    }
    __syncthreads();
    float* gr = grow + (size_t)t * C;
    if (threadIdx.x < 32) {                 // blank: the even states
      const int lane = threadIdx.x;
      float acc = 0.0f;
      for (int i = 2 * lane; i <= send; i += 64) acc += ocur[i];
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) gr[0] = -acc;
    } else {                                // labels: their odd states
      for (int c = threadIdx.x - 31; c < C; c += blockDim.x - 32) {
        float acc = 0.0f;
        for (int j = first[c]; j >= 0; j = next[j]) acc += ocur[2 * j + 1];
        gr[c] = -acc;
      }
    }
  }
}

}  // namespace

// logp: [B, T, C] float32; labels: [B, L] int32, 0-padded, classes in
// [1, C); label_lengths: [B] int32 -- all contiguous.  nll: [B] float32.
// With compute_grad != 0, grad: [B, T, C] float32 and alpha_scr: [B, T, S]
// float32 scratch (S = 2L + 1); otherwise both may be null.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int ctc_forward_backward(const void* logp, const void* labels,
                                    const void* label_lengths, void* nll,
                                    void* grad, void* alpha_scr, int B, int T,
                                    int L, int C, int compute_grad,
                                    void* stream) {
  const int S = 2 * L + 1;
  if (B <= 0 || T <= 0 || L < 0 || C <= 0 || B > 65535 || S > kMaxThreads ||
      (compute_grad && (grad == nullptr || alpha_scr == nullptr)))
    return (int)cudaErrorInvalidValue;
  int threads = ((S + 31) / 32) * 32;
  if (threads < 64) threads = 64;
  // two alpha/g rows and two occupancy rows, then the label lists
  const int smem = 4 * S * (int)sizeof(float) + (C + L) * (int)sizeof(int);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  ctc_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logp), static_cast<const int*>(labels),
      static_cast<const int*>(label_lengths), static_cast<float*>(nll),
      static_cast<float*>(grad), static_cast<float*>(alpha_scr), T, L, C,
      compute_grad);
  return (int)cudaGetLastError();
}
