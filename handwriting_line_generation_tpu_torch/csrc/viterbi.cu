// CTC forced alignment (the Viterbi path), hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: handwriting_line_generation_tpu/ops/align.py:
// viterbi_align is a lax.scan, which XLA runs as one loop on the device.
// The port's plain version (ops/align.py: viterbi_moves + viterbi_backtrace)
// is a Python loop of ~9 launches a frame, ~2,300 at T = 256, through which
// the card waits on the host.  This kernel runs the recursion and the
// backtrace in one launch.  For each line b, over the blank-interleaved
// label ext = (0, l1, 0, l2, ..., 0) of S = 2L + 1 states, of which the
// first sv = 2 len + 1 are valid:
//
//   emit(t, s)  = logp[b, t, ext[s]]
//   alpha(0, s) = emit(0, s) for s < min(2, sv), else NEG
//   a0 = alpha(t-1, s), a1 = alpha(t-1, s-1),
//   a2 = alpha(t-1, s-2) if can_skip[s] else NEG   (states below 0 read NEG)
//   move(t, s)  = 2 if a2 > max(a0, a1), else 1 if a1 > a0, else 0
//   alpha(t, s) = emit(t, s) + max(max(a0, a1), a2)
//   final state = 2 len if alpha(T-1, 2 len) >= alpha(T-1, max(2 len - 1, 0)),
//                 else 2 len - 1
//   aligned[b, t] = ext[state(t)],  state(t-1) = state(t) - move(t, state(t))
//
// with can_skip[s] = ext[s] != 0 and ext[s] != ext[s-2] (0 below state 0) and
// NEG = -1e30 in the log-probs' dtype.  The arithmetic is the plain
// version's op for op, so the path is the same bit for bit: max propagates a
// NaN as torch.maximum does (PTX max.NaN), the comparisons are strict, a
// forbidden skip is a NEG candidate (it wins where every real one is below
// NEG), and in bf16 each sum is rounded to bf16, to nearest even, as
// torch.add rounds it.  A state reads only the states before it, so the
// states past sv never reach a valid one: a line's warps past its sv skip
// the recursion (a third of the lattice at the reconstruction's labels).
//
// Bound: the chain of T - 1 dependent steps, each waiting for the whole
// previous row, then the backtrace's T - 1 dependent reads.  The bytes are
// few: B * T * sv gathered emissions, 6.4 MB at B = 64, T = 256, mean sv =
// 97 in float32 (1.9 us at 3.35 TB/s), and the [B, T] output; the work is
// ~6 operations a lattice cell.  The grid has B blocks, so most SMs idle:
// the kernel is latency-bound by design, and what it removes is the
// host's ~2,300 launches.
//
// Design.  One block per line.  The row of alpha lives in the registers of
// nw = ceil(S / 64) warps (at most 8), P = ceil(S / (32 nw)) <= 4
// consecutive states a lane (P a template parameter; nw = 3, P = 2 at
// L = 72).  A step's time is its instruction chain: at B = 64, T = 256,
// L = 72 on an H100, P = 2 over three warps took 42 us a call in float32
// against 63 us for P = 1 over five.  The states s-1 and s-2 across a lane
// boundary come by __shfl_up_sync; across a warp boundary by two floats in a
// double-buffered shared slot and one named barrier of the line's warps a
// step (none for a single warp), as in csrc/ctc.cu.  Each lane gathers its
// emissions kAhead frames ahead into a register ring, kept in the
// log-probs' dtype until used: a bf16 value widened at the load made the
// warp wait on every load (bf16 then took 102 us a call against float32's
// 70; now 41 and 42).  Each state's move
// is one byte of shared memory, [T-1][32 nw P] (48 KB at T = 256, L = 72);
// where they do not fit, a global scratch [B][T-1][32 nw P] from the
// wrapper holds them.  After one __syncthreads() a single thread follows
// the moves back from the final state, a chain of one shared read and a
// subtraction a frame, writing each frame's state to the output; after a
// second, every thread turns states into label values.  No [T-1, B, S]
// moves tensor leaves the kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;
constexpr int kTargetP = 2;             // states a lane while warps remain
constexpr int kMaxP = 4;
constexpr int kMaxStates = kMaxWarps * 32 * kMaxP;   // 1024
constexpr int kAhead = 8;               // frames of emissions in flight
// dynamic shared memory: 227 KB, less room for the static arrays
constexpr size_t kSmemLimit = 232448 - 1024;
constexpr unsigned kFull = 0xffffffffu;

// torch.maximum: a NaN in either operand gives NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

template <typename F>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float f(float x) { return x; }
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float neg() { return -1e30f; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float f(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  // torch.add of two bf16 tensors: the float sum, rounded to bf16
  static __device__ __forceinline__ float add(float a, float b) {
    return __bfloat162float(__float2bfloat16_rn(__fadd_rn(a, b)));
  }
  static __device__ __forceinline__ __nv_bfloat16 neg() {
    return __float2bfloat16_rn(-1e30f);
  }
};

template <typename F, int P>
__global__ void __launch_bounds__(kMaxWarps * 32)
    viterbi_kernel(const F* __restrict__ logp, const int* __restrict__ labels,
                   const int* __restrict__ lengths, int* __restrict__ out,
                   uint8_t* __restrict__ scratch, int T, int L, int C,
                   int nw) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float xch[2][kMaxWarps][2];   // [step parity][warp][s-1, s-2]
  __shared__ float fin[2];                 // alpha(T-1) at 2 len, 2 len - 1
  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int W = nw * 32 * P;               // states of a row: a byte each
  int* lab = reinterpret_cast<int*>(smem);                       // [L]
  uint8_t* bp = scratch ? scratch + (size_t)b * (T - 1) * W
                        : smem + (size_t)L * sizeof(int);        // [T-1][W]
  const F* lp = logp + (size_t)b * T * C;
  const F negf = Num<F>::neg();
  const float NEG = Num<F>::f(negf);

  const int n = lengths[b];
  const int len = n < 0 ? 0 : (n > L ? L : n);
  const int sv = 2 * len + 1, send = 2 * len;
  const int slab = send > 0 ? send - 1 : 0;
  for (int i = tid; i < L; i += blockDim.x) lab[i] = labels[(size_t)b * L + i];
  __syncthreads();
  auto ext_at = [&](int s) -> int { return (s & 1) ? lab[s >> 1] : 0; };

  // the warps this line needs; the rest wait at the block barrier below
  const int nwb = min(nw, (sv + 32 * P - 1) / (32 * P));
  if (warp < nwb) {
    int ext[P];
    bool gather[P], skip[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int s = tid * P + j;
      const bool valid = s < sv;
      ext[j] = valid ? ext_at(s) : 0;
      // a label outside [0, C) is never read out of bounds: its state
      // emits NEG
      gather[j] = valid && ext[j] >= 0 && ext[j] < C;
      skip[j] = valid && ext[j] != 0 && ext[j] != (s >= 2 ? ext_at(s - 2) : 0);
    }
    // the emissions stay in the log-probs' dtype until used, so a load's
    // result is first needed kAhead steps later
    auto emit = [&](int t, F* e) {
#pragma unroll
      for (int j = 0; j < P; ++j)
        e[j] = gather[j] ? lp[(size_t)t * C + ext[j]] : negf;
    };
    float a[P];
    // lane 31's last two states, for the next warp's lane 0.  A line has
    // several warps only where S > 64, and then P >= 2 (plan() below)
    auto send_up = [&](int t) {
      if constexpr (P >= 2) {
        if (nwb > 1) {
          if (lane == 31) {
            xch[t & 1][warp][0] = a[P - 1];
            xch[t & 1][warp][1] = a[P - 2];
          }
          asm volatile("bar.sync 1, %0;" ::"r"(nwb * 32) : "memory");
        }
      }
    };
    {
      F e0[P];
      emit(0, e0);
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int s = tid * P + j;
        a[j] = (s < 2 && s < sv) ? Num<F>::f(e0[j]) : NEG;
      }
    }
    send_up(0);

    F ring[kAhead][P];
#pragma unroll
    for (int d = 0; d < kAhead; ++d)
      if (1 + d < T) emit(1 + d, ring[d]);
    for (int t0 = 1; t0 < T; t0 += kAhead) {
#pragma unroll
      for (int d = 0; d < kAhead; ++d) {
        const int t = t0 + d;
        if (t >= T) break;
        float e[P];
#pragma unroll
        for (int j = 0; j < P; ++j) e[j] = Num<F>::f(ring[d][j]);
        if (t + kAhead < T) emit(t + kAhead, ring[d]);
        // the two states before this lane's first
        const float* prev = xch[(t - 1) & 1][warp > 0 ? warp - 1 : 0];
        float up1 = __shfl_up_sync(kFull, a[P - 1], 1);
        float up2;
        if constexpr (P >= 2) {
          up2 = __shfl_up_sync(kFull, a[P - 2], 1);
        } else {                   // one warp: lane 1's s-2 is below 0
          up2 = __shfl_up_sync(kFull, a[0], 2);
          if (lane == 1) up2 = NEG;
        }
        if (lane == 0) {
          up1 = warp == 0 ? NEG : prev[0];
          up2 = warp == 0 ? NEG : prev[1];
        }
        float na[P];
        uint8_t* row = bp + (size_t)(t - 1) * W + tid * P;
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const float a0 = a[j];
          const float a1 = j >= 1 ? a[j - 1] : up1;
          const float a2 =
              skip[j] ? (j >= 2 ? a[j - 2] : (j == 1 ? up1 : up2)) : NEG;
          const float m01 = max_nan(a0, a1);
          row[j] = a2 > m01 ? 2 : (a1 > a0 ? 1 : 0);
          na[j] = Num<F>::add(e[j], max_nan(m01, a2));
        }
#pragma unroll
        for (int j = 0; j < P; ++j) a[j] = na[j];
        send_up(t);
      }
    }
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int s = tid * P + j;
      if (s == send) fin[0] = a[j];
      if (s == slab) fin[1] = a[j];
    }
  }
  __syncthreads();

  // ---- backtrace: one thread follows the moves from the final state,
  // writing each frame's state; then every thread turns states into labels
  int* row_out = out + (size_t)b * T;
  if (tid == 0) {
    int s = fin[0] >= fin[1] ? send : slab;
    const uint8_t* row = bp + (size_t)(T - 1) * W;
    for (int t = T - 1; t >= 1; --t) {
      row_out[t] = s;
      row -= W;
      // a move below state 0 would need alpha(t-1, 0) < NEG, which no
      // log-probability reaches; the clamp only keeps the reads in bounds
      s = max(s - row[s], 0);
    }
    row_out[0] = s;
  }
  __syncthreads();
  for (int t = tid; t < T; t += blockDim.x) row_out[t] = ext_at(row_out[t]);
}

struct Plan {
  int nw, P;
  size_t smem, scratch;   // dynamic shared bytes; global scratch bytes
};

Plan plan(int B, int T, int L) {
  const int S = 2 * L + 1;
  Plan p;
  p.nw = (S + 32 * kTargetP - 1) / (32 * kTargetP);
  if (p.nw > kMaxWarps) p.nw = kMaxWarps;
  p.P = (S + 32 * p.nw - 1) / (32 * p.nw);
  const size_t moves = (size_t)(T - 1) * p.nw * 32 * p.P;
  const size_t lab = (size_t)L * sizeof(int);
  const bool shared = lab + moves <= kSmemLimit;
  p.smem = lab + (shared ? moves : 0);
  p.scratch = shared ? 0 : moves * B;
  return p;
}

template <typename F, int P>
cudaError_t launch(const Plan& p, cudaStream_t stream, int B, const void* lp,
                   const int* labels, const int* lens, int* out,
                   void* scratch, int T, int L, int C) {
  if (p.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        viterbi_kernel<F, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)p.smem);
    if (err != cudaSuccess) return err;
  }
  viterbi_kernel<F, P><<<B, p.nw * 32, p.smem, stream>>>(
      static_cast<const F*>(lp), labels, lens, out,
      static_cast<uint8_t*>(scratch), T, L, C, p.nw);
  return cudaGetLastError();
}

template <typename F>
cudaError_t dispatch(const Plan& p, cudaStream_t st, int B, const void* lp,
                     const int* labels, const int* lens, int* out,
                     void* scratch, int T, int L, int C) {
#define VITERBI_CASE(N) \
  if (p.P == N)         \
    return launch<F, N>(p, st, B, lp, labels, lens, out, scratch, T, L, C);
  VITERBI_CASE(1) VITERBI_CASE(2) VITERBI_CASE(3) VITERBI_CASE(4)
#undef VITERBI_CASE
  return cudaErrorInvalidValue;
}

bool bad_shape(int B, int T, int L, int C) {
  return B <= 0 || T <= 0 || L < 0 || C <= 0 || 2 * L + 1 > kMaxStates;
}

}  // namespace

// Bytes of global scratch viterbi_align needs for the backpointers: 0 when
// they fit in shared memory; -1 for a shape it does not take.
extern "C" long long viterbi_scratch_bytes(int B, int T, int L) {
  if (bad_shape(B, T, L, 1)) return -1;
  return (long long)plan(B, T, L).scratch;
}

// logp: [B, T, C] float32 (dtype 0) or bfloat16 (dtype 1); labels: [B, L]
// int32; lengths: [B] int32; out: [B, T] int32; scratch:
// viterbi_scratch_bytes(B, T, L) bytes, or null when that is 0.  All
// contiguous on one device.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int viterbi_align(const void* logp, const int* labels,
                             const int* lengths, int* out, void* scratch,
                             int B, int T, int L, int C, int dtype,
                             void* stream) {
  if (bad_shape(B, T, L, C)) return (int)cudaErrorInvalidValue;
  const Plan p = plan(B, T, L);
  if (p.scratch > 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(p, st, B, logp, labels, lengths, out, scratch,
                                T, L, C);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(p, st, B, logp, labels, lengths, out,
                                        scratch, T, L, C);
  return (int)cudaErrorInvalidValue;
}
