// Generator block epilogue, hand-written for Hopper (sm_90a).
//
// Replaces: handwriting_line_generation_tpu/ops/gen_epilogue.py:_kernel, the
// Pallas TPU kernel behind block_epilogue.  For each sample b and channel c
// of an NHWC conv output z [B, H, W, C]:
//
//   y   = leaky_relu_0.2( [blur3x3](z) + round(noise[b,h,w] * nw[c]) )
//   out = gamma[b,c] * round((y - mean[b,c]) * rstd[b,c]) + beta[b,c]
//
// where blur3x3 is the zero-padded separable (1,2,1)/4 binomial (rows, then
// columns), nw is the NoiseInjection weight already scaled by sqrt(2) and
// rounded to z's type, and mean / rstd are one-pass float32 instance
// statistics over H*W: var = max(E[y^2] - E[y]^2, 0), rstd =
// 1.0f / sqrtf(var + eps) (both correctly rounded; rsqrtf is not used).
// All arithmetic is float32.  For bfloat16, values round to bf16
// (__float2bfloat16_rn, nearest even, like astype) at the JAX kernel's
// points: after the blur, after noise * nw, after leaky_relu, after the
// normalisation, and at the output.
//
// Bound: bytes.  The function must read z and the noise plane once and write
// out once; it does ~20 float operations per element with the blur, far below
// the H100's float32 ridge of ~20 operations per byte, so its floor is those
// bytes over the memory rate (3.35 TB/s).
//
// Design.  The TPU kernel holds one whole sample in VMEM and reads and writes
// it once.  Here one sample is up to 64 x 768 x 16 values (1.5 MB in bf16),
// far more than a block's 227 KB of shared memory, so the statistics are a
// reduction across blocks, made in three launches:
//   1. stats:    grid (chunk, b).  Each block computes y over a chunk of
//                pixels and writes float32 partial sums of y and y^2 per
//                (b, chunk, c).  No float atomics: runs repeat bit for bit.
//   2. finalize: grid (b).  Sums the partials in a fixed order -> mean, rstd.
//   3. apply:    grid (chunk, b).  Recomputes y and writes gamma * x^ + beta.
// So z is read twice and out written once: 1.5x the bound's bytes, plus the
// 3x3 neighbourhood re-reads of the blur, which L1/L2 mostly absorb.  Each
// thread moves 16 bytes per access (8 bf16 or 4 f32 channels of one pixel),
// neighbouring threads on neighbouring addresses; at C = 16 in bf16 one warp
// covers 16 pixels.  A later design can keep a sample in a thread-block
// cluster's distributed shared memory and reach one read and one write.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kTargetThreads = 256;
constexpr size_t kMaxStaticSmem = 48 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round a float32 value to T and back (the identity for float).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

struct Dims {
  int H, W, C;
  int lanes;          // threads per pixel: C / VEC
  int pix_per_chunk;  // pixels of one sample per block
  int nchunks;        // ceil(H * W / pix_per_chunk)
};

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float* out) {
  const Vec<T, VEC> v = *reinterpret_cast<const Vec<T, VEC>*>(p);
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_f32(v.v[i]);
}

// y for channels c0 .. c0+VEC-1 of pixel (h, w); zb and nb point at sample b.
template <typename T, int VEC, bool BLUR>
__device__ __forceinline__ void pre_norm(const T* __restrict__ zb,
                                         const T* __restrict__ nb,
                                         const float* nwf, int h, int w,
                                         int c0, const Dims& d, float* y) {
  if (BLUR) {
    float cols[3][VEC];
#pragma unroll
    for (int dw = 0; dw < 3; ++dw) {
      const int ww = w + dw - 1;
      float r[3][VEC];
#pragma unroll
      for (int dh = 0; dh < 3; ++dh) {
        const int hh = h + dh - 1;
        if (ww >= 0 && ww < d.W && hh >= 0 && hh < d.H) {
          load_vec<T, VEC>(zb + ((size_t)hh * d.W + ww) * d.C + c0, r[dh]);
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) r[dh][i] = 0.0f;
        }
      }
      // rows first, in the JAX kernel's order: (a + 2b + c) * 0.25
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        cols[dw][i] = (r[0][i] + 2.0f * r[1][i] + r[2][i]) * 0.25f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      y[i] = round_to<T>((cols[0][i] + 2.0f * cols[1][i] + cols[2][i]) *
                         0.25f);
  } else {
    load_vec<T, VEC>(zb + ((size_t)h * d.W + w) * d.C + c0, y);
  }
  const float n = to_f32(nb[(size_t)h * d.W + w]);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float t = __fadd_rn(y[i], round_to<T>(__fmul_rn(n, nwf[i])));
    y[i] = round_to<T>(fmaxf(t, 0.2f * t));
  }
}

template <typename T, int VEC, bool BLUR>
__global__ void stats_kernel(const T* __restrict__ z,
                             const T* __restrict__ noise,
                             const T* __restrict__ nw,
                             float* __restrict__ psum,
                             float* __restrict__ psq, Dims d) {
  extern __shared__ float smem[];
  const int chunk = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int rows = blockDim.x / d.lanes;
  const int row = tid / d.lanes, c0 = (tid % d.lanes) * VEC;
  const int P = d.H * d.W;
  const T* zb = z + (size_t)b * P * d.C;
  const T* nb = noise + (size_t)b * P;
  float nwf[VEC], s1[VEC], s2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    nwf[i] = to_f32(nw[c0 + i]);
    s1[i] = 0.0f;
    s2[i] = 0.0f;
  }
  const int p0 = chunk * d.pix_per_chunk;
  const int p1 = min(P, p0 + d.pix_per_chunk);
  for (int p = p0 + row; p < p1; p += rows) {
    float y[VEC];
    pre_norm<T, VEC, BLUR>(zb, nb, nwf, p / d.W, p % d.W, c0, d, y);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      s1[i] += y[i];
      s2[i] += y[i] * y[i];
    }
  }
  float* sh1 = smem;
  float* sh2 = smem + blockDim.x * VEC;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    sh1[tid * VEC + i] = s1[i];
    sh2[tid * VEC + i] = s2[i];
  }
  __syncthreads();
  // channel c of row r sits at slot (r * lanes + c / VEC) * VEC + c % VEC
  for (int c = tid; c < d.C; c += blockDim.x) {
    float a = 0.0f, q = 0.0f;
    for (int r = 0; r < rows; ++r) {
      const int s = (r * d.lanes + c / VEC) * VEC + c % VEC;
      a += sh1[s];
      q += sh2[s];
    }
    const size_t o = ((size_t)b * d.nchunks + chunk) * d.C + c;
    psum[o] = a;
    psq[o] = q;
  }
}

__global__ void finalize_kernel(const float* __restrict__ psum,
                                const float* __restrict__ psq,
                                float* __restrict__ mean,
                                float* __restrict__ rstd, int C, int nchunks,
                                float n, float eps) {
  const int b = blockIdx.x;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float a = 0.0f, q = 0.0f;
    for (int k = 0; k < nchunks; ++k) {
      const size_t o = ((size_t)b * nchunks + k) * C + c;
      a += psum[o];
      q += psq[o];
    }
    const float m = a / n, m2 = q / n;
    const float var = fmaxf(__fsub_rn(m2, __fmul_rn(m, m)), 0.0f);
    mean[(size_t)b * C + c] = m;
    rstd[(size_t)b * C + c] = 1.0f / sqrtf(var + eps);
  }
}

template <typename T, int VEC, bool BLUR>
__global__ void apply_kernel(const T* __restrict__ z,
                             const T* __restrict__ noise,
                             const T* __restrict__ nw,
                             const T* __restrict__ gamma,
                             const T* __restrict__ beta,
                             const float* __restrict__ mean,
                             const float* __restrict__ rstd,
                             T* __restrict__ out, Dims d) {
  const int chunk = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int rows = blockDim.x / d.lanes;
  const int row = tid / d.lanes, c0 = (tid % d.lanes) * VEC;
  const int P = d.H * d.W;
  const T* zb = z + (size_t)b * P * d.C;
  const T* nb = noise + (size_t)b * P;
  T* ob = out + (size_t)b * P * d.C;
  float nwf[VEC], m[VEC], r[VEC], ga[VEC], be[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const size_t bc = (size_t)b * d.C + c0 + i;
    nwf[i] = to_f32(nw[c0 + i]);
    m[i] = mean[bc];
    r[i] = rstd[bc];
    ga[i] = to_f32(gamma[bc]);
    be[i] = to_f32(beta[bc]);
  }
  const int p0 = chunk * d.pix_per_chunk;
  const int p1 = min(P, p0 + d.pix_per_chunk);
  for (int p = p0 + row; p < p1; p += rows) {
    float y[VEC];
    pre_norm<T, VEC, BLUR>(zb, nb, nwf, p / d.W, p % d.W, c0, d, y);
    Vec<T, VEC> o;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float zn = round_to<T>(__fmul_rn(__fsub_rn(y[i], m[i]), r[i]));
      o.v[i] = from_f32<T>(__fadd_rn(__fmul_rn(ga[i], zn), be[i]));
    }
    *reinterpret_cast<Vec<T, VEC>*>(ob + (size_t)p * d.C + c0) = o;
  }
}

template <typename T, int VEC, bool BLUR>
cudaError_t run(const void* z, const void* noise, const void* nw,
                const void* gamma, const void* beta, void* out, float* scratch,
                int B, Dims d, float eps, cudaStream_t stream) {
  d.lanes = d.C / VEC;
  const int rows = d.lanes >= kTargetThreads ? 1 : kTargetThreads / d.lanes;
  const int threads = rows * d.lanes;
  const size_t smem = 2 * (size_t)threads * VEC * sizeof(float);
  if (threads > 1024 || smem > kMaxStaticSmem) return cudaErrorInvalidValue;
  const size_t partial = (size_t)B * d.nchunks * d.C;
  float* psum = scratch;
  float* psq = psum + partial;
  float* mean = psq + partial;
  float* rstd = mean + (size_t)B * d.C;
  const dim3 grid(d.nchunks, B);
  stats_kernel<T, VEC, BLUR><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(z), static_cast<const T*>(noise),
      static_cast<const T*>(nw), psum, psq, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int fthreads = d.C < kTargetThreads ? ((d.C + 31) / 32) * 32
                                            : kTargetThreads;
  finalize_kernel<<<B, fthreads, 0, stream>>>(
      psum, psq, mean, rstd, d.C, d.nchunks, (float)d.H * (float)d.W, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  apply_kernel<T, VEC, BLUR><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(z), static_cast<const T*>(noise),
      static_cast<const T*>(nw), static_cast<const T*>(gamma),
      static_cast<const T*>(beta), mean, rstd, static_cast<T*>(out), d);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t run_blur(bool blur, const void* z, const void* noise,
                     const void* nw, const void* gamma, const void* beta,
                     void* out, float* scratch, int B, Dims d, float eps,
                     cudaStream_t stream) {
  return blur ? run<T, VEC, true>(z, noise, nw, gamma, beta, out, scratch, B,
                                  d, eps, stream)
              : run<T, VEC, false>(z, noise, nw, gamma, beta, out, scratch, B,
                                   d, eps, stream);
}

}  // namespace

// z, out: [B, H, W, C]; noise: [B, H, W]; nw: [C] (sqrt(2)-scaled); gamma,
// beta: [B, C] -- all contiguous, of one type (float32 if is_bf16 == 0, else
// bfloat16), z and out 16-byte aligned.  scratch: float32, 2 * B * nchunks * C
// + 2 * B * C values.  Launches on `stream` and returns cudaGetLastError().
extern "C" int gen_epilogue_forward(const void* z, const void* noise,
                                    const void* nw, const void* gamma,
                                    const void* beta, void* out, void* scratch,
                                    int B, int H, int W, int C, int is_bf16,
                                    int apply_blur, float eps,
                                    int pix_per_chunk, int nchunks,
                                    void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || pix_per_chunk <= 0 ||
      B > 65535 || nchunks != (H * W + pix_per_chunk - 1) / pix_per_chunk)
    return (int)cudaErrorInvalidValue;
  Dims d{H, W, C, 0, pix_per_chunk, nchunks};
  float* s = static_cast<float*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool blur = apply_blur != 0;
  if (is_bf16) {
    using T = __nv_bfloat16;
    if (C % 8 == 0)
      return (int)run_blur<T, 8>(blur, z, noise, nw, gamma, beta, out, s, B,
                                 d, eps, st);
    if (C % 4 == 0)
      return (int)run_blur<T, 4>(blur, z, noise, nw, gamma, beta, out, s, B,
                                 d, eps, st);
    if (C % 2 == 0)
      return (int)run_blur<T, 2>(blur, z, noise, nw, gamma, beta, out, s, B,
                                 d, eps, st);
    return (int)run_blur<T, 1>(blur, z, noise, nw, gamma, beta, out, s, B, d,
                               eps, st);
  }
  if (C % 4 == 0)
    return (int)run_blur<float, 4>(blur, z, noise, nw, gamma, beta, out, s, B,
                                   d, eps, st);
  if (C % 2 == 0)
    return (int)run_blur<float, 2>(blur, z, noise, nw, gamma, beta, out, s, B,
                                   d, eps, st);
  return (int)run_blur<float, 1>(blur, z, noise, nw, gamma, beta, out, s, B,
                                 d, eps, st);
}
