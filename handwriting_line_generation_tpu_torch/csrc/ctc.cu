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
//   grad[b, t, c] = -sum_{s < Sv, ext[s] == c} exp(clip(alpha + beta - z_t,
//                                                       -60, 60)),
//   z_t         = lse_{s < Sv}(alpha(t, s) + beta(t, s))
//
// z_t equals ll for every t (each row's occupancies sum to 1), but alpha and
// beta reach |1e3| at T = 500, where a float32 ulp is 6e-5, and both
// recursions round at that size every step: alpha + beta - ll is then off
// by up to 2e-3 in a way common to the whole row, so the row summed to
// 1 +- 2e-3 and the gradient through log_softmax (softmax * sum - occupancy,
// which nearly cancels) lost three digits.  Each row's own z cancels that
// common error: the gradient stays within 2.5e-4 of a float64 recursion at
// (4, 500, 96), as close as the plain float32 recursion's autograd.
//
// with lse(a, b, c) = m + log(exp(a - m) + exp(b - m) + exp(c - m)) for the
// largest m, invalid states and absent moves at NEG = -1e30 (never -inf), as
// the JAX scan (ops/ctc.py) and the Pallas kernel compute it; the alpha
// step clamps m at NEG as the scan does.  expf / logf (not the __expf /
// __logf intrinsics) keep it within a few float32 ulps of the plain PyTorch
// version (ops/ctc.py:ctc_loss); the alpha arithmetic is the scan's op for
// op, so the NLLs match it exactly.  The gradient is taken with respect to
// log_probs.  Samples that are impossible come out with a huge nll; the
// caller zeroes their loss and gradient.
//
// Bound: bytes.  The function must read logp once and write grad once:
// 2 * B * T * C * 4 bytes, about 2.6 MB (under a microsecond at 3.35 TB/s)
// for B = 16, T = 256, C = 80; its ~40 float operations per (t, s) cell
// are far less.  What really sets the time is the chain of dependent
// steps, each a log-sum-exp over neighbouring states that must wait for the
// whole previous row.
//
// Design.  One block per sample.  Beta does not depend on alpha, so the two
// recursions run at the same time, alpha forward and beta backward, and the
// chain is T steps, not 2T.  Each recursion holds its state row in the
// registers of nw = min(8, ceil(S / 64)) warps, P = max(2, ceil(S /
// (32 nw))) consecutive states per lane (P is a template parameter: 2 at
// every default bucket, nw = 1, 3, 4 at L = 24, 72, 96).  Forward only,
// the alpha chain alone takes P = 1 over ceil(S / 32) warps where S <=
// 256 (2, 5, 7 warps at those buckets): half the instructions a warp a
// step: 0.074 against 0.097 ms for P = 2 at B = 16, T = 256, L = 72 on
// an H100.  The neighbours s-1 and s-2 (s+1 and s+2 going backward)
// across a lane boundary come by
// __shfl_up_sync / __shfl_down_sync; across a warp boundary, by two floats
// in a double-buffered shared slot and one named barrier of the nw warps
// a step (none when nw = 1) -- no __syncthreads().  One warp alone
// (P = 5 at L = 72) was measured to be limited by its single instruction
// stream: a step is ~600 instructions issued one a cycle, slower than one
// thread per state over five warps with a block barrier; spreading the row
// over nw warps gives each step nw streams.  Each step's P chains are
// written stage by stage and branch-free (an invalid state is clamped to
// NEG, not selected), so they overlap.  Each lane gathers the next step's
// emissions from device memory while it computes this one, so the
// gather's latency stays off the chain.  The two recursions write their
// rows to a caller-allocated float32 scratch [2][B, T, S] (a few MB,
// resident in L2).  Meanwhile the last warp builds, per class, the list
// of label positions that hold it.  After one __syncthreads() all 16
// warps form the gradient, one row t at a time per
// warp, loading the next row's alpha and beta while it sums this one: the
// warp reduces the row's z by two shuffle trees, and each lane turns its
// states' alpha + beta - z into occupancies in shared memory; the blank (even) states are summed by a fixed shuffle tree
// and every other class along its list of positions, so a class absent from
// the label writes 0 and runs repeat bit for bit (no float atomics).
// Forward only (no gradient) launches the alpha warps alone and writes no
// scratch.  The grid has only B blocks, so at B = 16 most of the card's
// 132 SMs idle: the kernel is latency-bound by design.

#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kClip = 60.0f;
constexpr int kWarps = 16;             // warps of a block with the gradient
constexpr int kMaxDirWarps = kWarps / 2;   // warps of one recursion
constexpr int kTargetP = 2;            // states a lane with beta beside
constexpr int kMaxStates = 1024;       // 8 warps x 32 lanes x 4 states
constexpr size_t kSmemLimit = 232448;  // 227 KB of dynamic shared memory
constexpr unsigned kFull = 0xffffffffu;

template <int P>
__global__ void __launch_bounds__(kWarps * 32)
    ctc_kernel(const float* __restrict__ logp, const int* __restrict__ labels,
               const int* __restrict__ label_lengths, float* __restrict__ nll,
               float* __restrict__ grad, float* alpha_scr, float* beta_scr,
               int T, int L, int C, int compute_grad, int nw) {
  extern __shared__ __align__(16) float smem[];
  const int S = 2 * L + 1;
  int* first = reinterpret_cast<int*>(smem);   // [C] first pos of a class
  int* next = first + C;                       // [L] next pos of one class
  float* occ = reinterpret_cast<float*>(next + L);   // [kWarps][S]
  __shared__ float llp[2];
  // boundary states between the warps of one recursion: [alpha, beta]
  // [step parity][warp][2]
  __shared__ float xch[2][2][kMaxDirWarps][2];

  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const float* lp = logp + (size_t)b * T * C;
  const int* lab = labels + (size_t)b * L;
  int len = label_lengths[b];
  len = len < 0 ? 0 : (len > L ? L : len);
  const int sv = 2 * len + 1;      // valid states
  const int send = 2 * len;

  if (compute_grad) {
    for (int c = tid; c < C; c += blockDim.x) first[c] = -1;
    __syncthreads();
  }

  auto ext_at = [&](int i) -> int { return (i & 1) ? lab[i >> 1] : 0; };
  // the nw warps of one recursion meet once a step (named barrier 1 for
  // alpha, 2 for beta), after the boundary states are written
  auto dir_sync = [&](int id) {
    if (nw > 1) asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(nw * 32)
                             : "memory");
  };
  if (warp < 2 * nw) {
    const int k = warp < nw ? warp : warp - nw;   // warp of its recursion
    const int gl = k * 32 + lane;                 // lane of its recursion
    // this lane's states s = gl * P + j: class, validity, skip moves into
    // s (alpha) and into s + 2 (beta)
    int ext[P];
    bool valid[P], gather[P], skip[P], skip2[P];
    // an invalid state's value is NEG: fmaxf(fminf(x, hi), lo) with
    // (hi, lo) = (+inf, -inf) keeps any x, (NEG, NEG) gives NEG.  A select
    // `valid ? x : NEG` would let the compiler branch around x per state,
    // and lanes that diverge there run the P states one after another
    float hi[P], lo[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int s = gl * P + j;
      valid[j] = s < sv;
      hi[j] = valid[j] ? __int_as_float(0x7f800000) : kNeg;
      lo[j] = valid[j] ? -__int_as_float(0x7f800000) : kNeg;
      ext[j] = valid[j] ? ext_at(s) : 0;
      // a label outside [0, C) makes its states unreachable (never read out
      // of bounds); the sample then comes out impossible
      gather[j] = valid[j] && ext[j] >= 0 && ext[j] < C;
      skip[j] = valid[j] && s >= 2 && ext[j] != 0 && ext[j] != ext_at(s - 2);
      skip2[j] = s + 2 < sv && ext_at(s + 2) != 0 &&
                 ext_at(s + 2) != ext[j];
    }
    auto emit = [&](int t, float* e) {
#pragma unroll
      for (int j = 0; j < P; ++j)
        e[j] = gather[j] ? lp[(size_t)t * C + ext[j]] : kNeg;
    };
    auto store = [&](float* scr, int t, const float* v) {
      float* row = scr + ((size_t)b * T + t) * S;
#pragma unroll
      for (int j = 0; j < P; ++j)
        if (gl * P + j < S) row[gl * P + j] = v[j];
    };

    if (warp < nw) {
      // ---- alpha ----
      float a[P], e[P], e_next[P];
      // this warp's last two states, for the next warp's first lanes: both
      // from lane 31, or from lanes 31 and 30 when P = 1
      auto send_up = [&](int t) {
        if (nw > 1) {
          if constexpr (P >= 2) {
            if (lane == 31) {
              xch[0][t & 1][k][0] = a[P - 1];
              xch[0][t & 1][k][1] = a[P - 2];
            }
          } else if (lane >= 30) {
            xch[0][t & 1][k][31 - lane] = a[0];
          }
        }
        dir_sync(1);
      };
      emit(0, e);
#pragma unroll
      for (int j = 0; j < P; ++j)
        a[j] = (gl * P + j < 2 && valid[j]) ? e[j] : kNeg;
      if (compute_grad) store(alpha_scr, 0, a);
      send_up(0);
      if (T > 1) emit(1, e_next);
      for (int t = 1; t < T; ++t) {
#pragma unroll
        for (int j = 0; j < P; ++j) e[j] = e_next[j];
        if (t + 1 < T) emit(t + 1, e_next);
        // the two states before this lane's first
        float up1 = __shfl_up_sync(kFull, a[P - 1], 1);
        float up2;
        if constexpr (P >= 2) {
          up2 = __shfl_up_sync(kFull, a[P - 2], 1);
        } else {
          up2 = __shfl_up_sync(kFull, a[0], 2);
          if (lane == 1) up2 = k == 0 ? kNeg : xch[0][(t - 1) & 1][k - 1][0];
        }
        if (lane == 0) {
          const bool first_warp = k == 0;
          up1 = first_warp ? kNeg : xch[0][(t - 1) & 1][k - 1][0];
          up2 = first_warp ? kNeg : xch[0][(t - 1) & 1][k - 1][1];
        }
        // each stage over all P states before the next, without branches,
        // so the P independent chains overlap
        float ms[P], x0[P], x1[P], x2[P];
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const float a0 = a[j];
          const float a1 = j >= 1 ? a[j - 1] : up1;
          const float a2m = j >= 2 ? a[j - 2] : (j == 1 ? up1 : up2);
          const float a2 = skip[j] ? a2m : kNeg;
          // m clamped at NEG, as the scan does
          ms[j] = fmaxf(fmaxf(fmaxf(a0, a1), a2), kNeg);
          x0[j] = a0 - ms[j];
          x1[j] = a1 - ms[j];
          x2[j] = a2 - ms[j];
        }
#pragma unroll
        for (int j = 0; j < P; ++j) x0[j] = expf(x0[j]);
#pragma unroll
        for (int j = 0; j < P; ++j) x1[j] = expf(x1[j]);
#pragma unroll
        for (int j = 0; j < P; ++j) x2[j] = expf(x2[j]);
#pragma unroll
        for (int j = 0; j < P; ++j) x0[j] = logf((x0[j] + x1[j]) + x2[j]);
#pragma unroll
        for (int j = 0; j < P; ++j)
          a[j] = fmaxf(fminf((e[j] + ms[j]) + x0[j], hi[j]), lo[j]);
        if (compute_grad) store(alpha_scr, t, a);
        send_up(t);
      }
      // ---- negative log-likelihood ----
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int s = gl * P + j;
        if (s == send) llp[0] = a[j];
        if (len > 0 && s == send - 1) llp[1] = a[j];
      }
      __syncwarp();
      dir_sync(1);
      if (gl == 0) {
        const float ab = llp[0];
        const float al = len > 0 ? llp[1] : kNeg;
        const float m = fmaxf(ab, al);
        const float ll = m + logf(expf(ab - m) + expf(al - m));
        nll[b] = -ll;
      }
    } else if constexpr (P >= 2) {   // P = 1 runs forward only
      // ---- beta ----
      float be[P], e[P], e_next[P];
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int s = gl * P + j;
        const bool end = s == send || s == (send > 0 ? send - 1 : 0);
        be[j] = (valid[j] && end) ? 0.0f : kNeg;
      }
      store(beta_scr, T - 1, be);
      emit(T - 1, e);
      if (T > 1) emit(T - 2, e_next);
      for (int t = T - 2; t >= 0; --t) {
        float g[P];                // g(t + 1) = beta(t + 1) + emit(t + 1)
#pragma unroll
        for (int j = 0; j < P; ++j) {
          g[j] = be[j] + e[j];
          e[j] = e_next[j];
        }
        if (t >= 1) emit(t - 1, e_next);
        // this warp's first two states, for the previous warp's last lane
        if (nw > 1 && lane == 0) {
          xch[1][t & 1][k][0] = g[0];
          xch[1][t & 1][k][1] = g[1];
        }
        dir_sync(2);
        // the next lane's first two states
        float dn1 = __shfl_down_sync(kFull, g[0], 1);
        float dn2 = __shfl_down_sync(kFull, g[1], 1);
        if (lane == 31) {
          const bool last_warp = k == nw - 1;
          dn1 = last_warp ? kNeg : xch[1][t & 1][k + 1][0];
          dn2 = last_warp ? kNeg : xch[1][t & 1][k + 1][1];
        }
        // lse3 of each state, stage by stage over all P (see alpha)
        float ms[P], x0[P], x1[P], x2[P];
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const int s = gl * P + j;
          const float g1m = j + 1 < P ? g[j + 1] : dn1;
          const float g2m = j + 2 < P ? g[j + 2] : (j + 2 == P ? dn1 : dn2);
          const float g1 = s + 1 < sv ? g1m : kNeg;
          const float g2 = skip2[j] ? g2m : kNeg;
          ms[j] = fmaxf(fmaxf(g[j], g1), g2);
          x0[j] = g[j] - ms[j];
          x1[j] = g1 - ms[j];
          x2[j] = g2 - ms[j];
        }
#pragma unroll
        for (int j = 0; j < P; ++j) x0[j] = expf(x0[j]);
#pragma unroll
        for (int j = 0; j < P; ++j) x1[j] = expf(x1[j]);
#pragma unroll
        for (int j = 0; j < P; ++j) x2[j] = expf(x2[j]);
#pragma unroll
        for (int j = 0; j < P; ++j)
          be[j] = fmaxf(fminf(ms[j] + logf((x0[j] + x1[j]) + x2[j]), hi[j]),
                        lo[j]);
        store(beta_scr, t, be);
      }
    }
  }
  if (compute_grad && tid == kWarps * 32 - 1) {
    // per-class lists of label positions, in increasing order (the last
    // warp, once it is free)
    for (int j = len - 1; j >= 0; --j) {
      const int c = lab[j];
      if (c >= 1 && c < C) {
        next[j] = first[c];
        first[c] = j;
      }
    }
  }
  if (!compute_grad) return;
  __syncthreads();

  // ---- gradient: one row t per warp at a time ----
  const float* arow = alpha_scr + (size_t)b * T * S;
  const float* brow = beta_scr + (size_t)b * T * S;
  float* orow = occ + warp * S;
  // lane's states s = lane + 32 k (GP covers S); the next row's alpha and
  // beta are loaded while this row is summed
  constexpr int GP = kMaxDirWarps * P;
  float an[GP], bn[GP];
  auto fetch = [&](int t) {
#pragma unroll
    for (int k = 0; k < GP; ++k) {
      const int s = lane + 32 * k;
      if (t < T && s < sv) {
        an[k] = arow[(size_t)t * S + s];
        bn[k] = brow[(size_t)t * S + s];
      }
    }
  };
  fetch(warp);
  for (int t = warp; t < T; t += kWarps) {
    float ac[GP], bc[GP];
#pragma unroll
    for (int k = 0; k < GP; ++k) {
      ac[k] = an[k];
      bc[k] = bn[k];
    }
    fetch(t + kWarps);
    // the row's own log-sum-exp z, by two fixed shuffle trees
    float m = kNeg;
#pragma unroll
    for (int k = 0; k < GP; ++k) {
      ac[k] += bc[k];
      if (lane + 32 * k < sv) m = fmaxf(m, ac[k]);
    }
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    float sum = 0.0f;
#pragma unroll
    for (int k = 0; k < GP; ++k)
      if (lane + 32 * k < sv) sum += expf(ac[k] - m);
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(kFull, sum, off);
    const float z = m + logf(sum);
#pragma unroll
    for (int k = 0; k < GP; ++k) {
      const int s = lane + 32 * k;
      if (s < sv) orow[s] = expf(fminf(fmaxf(ac[k] - z, -kClip), kClip));
    }
    __syncwarp();
    float* gr = grad + ((size_t)b * T + t) * C;
    float acc = 0.0f;              // blank: the even states
    for (int i = 2 * lane; i <= send; i += 64) acc += orow[i];
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(kFull, acc, off);
    if (lane == 0) gr[0] = -acc;
    for (int c = 1 + lane; c < C; c += 32) {   // labels: their odd states
      float a = 0.0f;
      for (int j = first[c]; j >= 0; j = next[j]) a += orow[2 * j + 1];
      gr[c] = -a;
    }
    __syncwarp();                  // before the next row overwrites orow
  }
}

template <int P>
cudaError_t launch(int threads, int smem, cudaStream_t stream, int B,
                   const float* logp, const int* labels, const int* lens,
                   float* nll, float* grad, float* ascr, float* bscr, int T,
                   int L, int C, int compute_grad, int nw) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ctc_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  ctc_kernel<P><<<B, threads, smem, stream>>>(logp, labels, lens, nll, grad,
                                              ascr, bscr, T, L, C,
                                              compute_grad, nw);
  return cudaGetLastError();
}

}  // namespace

// logp: [B, T, C] float32; labels: [B, L] int32, 0-padded, classes in
// [1, C); label_lengths: [B] int32 -- all contiguous.  nll: [B] float32.
// With compute_grad != 0, grad: [B, T, C] float32 and scratch: [2, B, T, S]
// float32 (alpha rows, then beta rows; S = 2L + 1); otherwise both may be
// null.  Launches on `stream` and returns cudaGetLastError().
extern "C" int ctc_forward_backward(const void* logp, const void* labels,
                                    const void* label_lengths, void* nll,
                                    void* grad, void* scratch, int B, int T,
                                    int L, int C, int compute_grad,
                                    void* stream) {
  const int S = 2 * L + 1;
  if (B <= 0 || T <= 0 || L < 0 || C <= 0 || B > 65535 || S > kMaxStates ||
      (compute_grad && (grad == nullptr || scratch == nullptr)))
    return (int)cudaErrorInvalidValue;
  // warps per recursion and states per lane
  int nw, need;
  if (!compute_grad && S <= 32 * kMaxDirWarps) {
    nw = (S + 31) / 32;                  // the alpha chain alone
    need = 1;
  } else {
    nw = (S + 32 * kTargetP - 1) / (32 * kTargetP);
    if (nw > kMaxDirWarps) nw = kMaxDirWarps;
    need = (S + 32 * nw - 1) / (32 * nw);
    if (need < kTargetP) need = kTargetP;
  }
  const int threads = compute_grad ? kWarps * 32 : nw * 32;
  // the label lists, then one occupancy row per warp
  const size_t smem = compute_grad ? (size_t)(C + L) * sizeof(int) +
                                         (size_t)kWarps * S * sizeof(float)
                                   : 0;
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(logp);
  const int* lab = static_cast<const int*>(labels);
  const int* len = static_cast<const int*>(label_lengths);
  float* nl = static_cast<float*>(nll);
  float* gr = static_cast<float*>(grad);
  float* ascr = static_cast<float*>(scratch);
  float* bscr = ascr ? ascr + (size_t)B * T * S : nullptr;
#define CTC_CASE(P)                                                       \
  if (need <= P)                                                          \
    return (int)launch<P>(threads, (int)smem, st, B, lp, lab, len, nl,    \
                          gr, ascr, bscr, T, L, C, compute_grad, nw);
  CTC_CASE(1) CTC_CASE(2) CTC_CASE(3) CTC_CASE(4)
#undef CTC_CASE
  return (int)cudaErrorInvalidValue;
}
