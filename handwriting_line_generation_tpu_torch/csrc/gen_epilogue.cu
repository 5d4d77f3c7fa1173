// Generator block epilogue, hand-written for Hopper (sm_90a).
//
// Replaces: handwriting_line_generation_tpu/ops/gen_epilogue.py:_kernel, the
// Pallas TPU kernel behind block_epilogue.  For each sample b and channel c
// of an NHWC conv output z [B, H, W, C] (the conv run without its bias):
//
//   x   = round(z + bias[c])                      (only when a bias is given)
//   y   = leaky_relu_0.2( [blur3x3](x) + round(noise[b,h,w] * nw[c]) )
//   out = gamma[b,c] * round((y - mean[b,c]) * rstd[b,c]) + beta[b,c]
//
// where blur3x3 is the zero-padded separable (1,2,1)/4 binomial (rows, then
// columns), nw is the NoiseInjection weight already scaled by sqrt(2) and
// rounded to z's type, and mean / rstd are one-pass float32 instance
// statistics over H*W: var = max(E[y^2] - E[y]^2, 0), rstd =
// 1.0f / sqrtf(var + eps) (both correctly rounded; rsqrtf is not used).
// All arithmetic is float32.  For bfloat16, values round to bf16
// (__float2bfloat16_rn, nearest even, like astype) at the JAX kernel's
// points: after the bias add (one rounding, as the separate add after the
// conv would do), after the blur, after noise * nw, after leaky_relu, after
// the normalisation, and at the output.
//
// Bound: bytes.  The function must read z and the noise plane once and write
// out once; it does ~30 float operations per element with the blur, far
// below the H100's float32 ridge of ~20 operations per byte, so its floor is
// those bytes over the memory rate (3.35 TB/s).
//
// Design: one launch per call, z read from device memory once.
//  * A thread-block cluster of K <= 8 blocks owns one sample at a time
//    (cluster (K, 1, 1)); rank k takes the k-th band of the sample's pixels
//    (whole rows with the blur, so the halo is a neighbour's edge row).
//    The clusters are persistent: as many as fit on the card at once
//    (cudaOccupancyMaxActiveClusters), each looping over samples.  Blocks
//    have 256 threads where two fit on one SM (128 registers a thread and
//    at most ~113 KB of shared memory each), else 512.
//  * Phase 1 computes y over the band and accumulates per-thread float32
//    sums of y and y^2 (each thread owns one fixed channel vector).  The
//    block reduces them per channel in a fixed order (a shuffle tree within
//    each warp, then the warps in shared memory); the
//    cluster then sums the K blocks' results through distributed shared
//    memory (map_shared_rank) in rank order, so every block gets the same
//    mean and rstd and two runs are bit-equal.  No float atomics, no HBM
//    scratch, no second launch.
//  * Phase 2 normalises and writes out.  Where it gets y is picked per call
//    shape by make_plan():
//      resident ("smem"): the band of z, loaded in one burst of 16-byte
//        cp.async copies (the whole band and its noise in flight at
//        once), stays in the block's shared memory.  Without the blur, phase 1 turns it into y
//        in place (y is rounded to z's type, so this is exact) and phase 2
//        reads y back.  With the blur, the band is first turned into
//        x = round(z + bias) in place, and the 3x3 neighbourhood of x is
//        read from shared memory -- the halo rows above and below the band
//        from the neighbouring ranks' bands, through distributed shared
//        memory.  Phase 1 keeps y beside the band where that still lets
//        two blocks share an SM (keep_y), else phase 2 blurs again.  Every
//        bf16 call of the main path is resident (block 4's band is 192 KB
//        of the 227 KB, so it blurs twice).
//      "L2": where the band does not fit (f32 at the last block, 3 MB a
//        sample), both phases walk the band reading z from device memory;
//        phase 2 re-reads it right after the statistics, while it is still
//        in the 50 MB L2.  For the blur, a column tile of the band's rows
//        plus a one-row halo streams through a ring of 4 row slots by
//        cp.async, one row ahead, so each z value costs one global load per
//        pass instead of nine.
//  * Positions outside the image are zero (masked, never read), so the bias
//    is added only inside.  The next sample's band is loaded while the
//    previous sample's stores drain.  Interior pixels take a blur path
//    without the edge checks.  Each thread moves 16 bytes per access
//    (8 bf16 or 4 f32 channels of one pixel), neighbouring threads on
//    neighbouring addresses.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 8;          // the portable cluster size
constexpr int kMaxThreads = 512;        // 128 registers a thread
constexpr size_t kSmemLimit = 232448;   // 227 KB of dynamic shared memory
constexpr size_t kSmemHalf = 115712;    // two blocks on one SM
constexpr int kRing = 4;                // row slots of the blur's ring

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}

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

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  const Vec<T, VEC> v = *reinterpret_cast<const Vec<T, VEC>*>(p);
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_f32(v.v[i]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float* in) {
  Vec<T, VEC> v;
#pragma unroll
  for (int i = 0; i < VEC; ++i) v.v[i] = from_f32<T>(in[i]);
  *reinterpret_cast<Vec<T, VEC>*>(p) = v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// How one call is cut up; the same on the host and in the kernel.
struct Plan {
  int H, W, C;
  int lanes;      // threads per pixel: C / VEC
  int prow;       // pixels one pass of the block covers
  int threads;    // prow * lanes
  int wred;       // 1: the per-thread sums are first reduced in each warp
  int K;          // cluster size: ranks per sample
  int rows_per;   // with the blur: rows of the sample per rank
  int band_pix;   // pixels of the sample per rank (whole rows with the blur)
  int resident;   // 1: the band stays in shared memory; 0: "L2" mode
  int keep_y;     // resident with the blur: y kept beside the band
  int wt;         // L2 mode with the blur: columns of one ring tile
  int ring_row;   // elements of one ring slot, a 16-byte multiple
  size_t scratch_off, band_off, noise_off, y_off, smem;
};

// Fills p for one call with `threads` threads a block; returns false if
// no plan fits in shared memory.
bool plan_for(int H, int W, int C, size_t tsize, int vec, bool blur,
              int threads, bool keep_y, Plan* p) {
  p->H = H;
  p->W = W;
  p->C = C;
  p->lanes = C / vec;
  if (p->lanes > threads) return false;
  p->prow = threads / p->lanes;
  p->threads = p->prow * p->lanes;
  // threads of one channel vector share a warp when lanes is a power of two
  // up to 32: a shuffle tree sums them first, so the block's partial sums
  // take one row per warp instead of one per pass-row
  p->wred = p->lanes <= 32 && (p->lanes & (p->lanes - 1)) == 0;
  const int rows = p->wred ? p->threads / 32 : p->prow;
  const size_t P = (size_t)H * W;
  if (blur) {
    // whole rows, so that the halo is a neighbour's first or last row
    const int k = H < kMaxCluster ? H : kMaxCluster;
    p->rows_per = (H + k - 1) / k;
    p->K = (H + p->rows_per - 1) / p->rows_per;
    p->band_pix = p->rows_per * W;
  } else {
    const int k = P < (size_t)kMaxCluster ? (int)P : kMaxCluster;
    p->band_pix = (int)((P + k - 1) / k);
    p->K = (int)((P + p->band_pix - 1) / p->band_pix);
    p->rows_per = 0;
  }
  // [0, scratch_off): stat and mr, [2][C] floats each
  p->scratch_off = align16(4 * (size_t)C * sizeof(float));
  const size_t partials = align16(2 * (size_t)rows * C * sizeof(float));
  const size_t band = align16((size_t)p->band_pix * C * tsize);
  const size_t nband = align16((size_t)p->band_pix * tsize);
  p->wt = 0;
  p->ring_row = 0;
  p->keep_y = keep_y && blur;
  const size_t ybuf = p->keep_y ? band : 0;
  if (p->scratch_off + partials + band + nband + ybuf <= kSmemLimit) {
    p->resident = 1;
    p->band_off = p->scratch_off + partials;
    p->noise_off = p->band_off + band;
    p->y_off = p->noise_off + nband;
    p->smem = p->y_off + ybuf;
    return true;
  }
  if (p->keep_y) return false;
  p->resident = 0;
  p->band_off = p->noise_off = 0;
  size_t scratch = partials;
  if (blur) {
    // the widest ring tile that fits, cut to whole passes of pixels where
    // it is narrower than the row
    const size_t slot = (kSmemLimit - p->scratch_off) / kRing / 16 * 16;
    const size_t px = slot / ((size_t)C * tsize);
    if (px < 3) return false;
    int wt = px - 2 < (size_t)W ? (int)(px - 2) : W;
    if (wt < W && wt >= p->prow) wt = wt / p->prow * p->prow;
    p->wt = wt;
    p->ring_row = (int)(align16((size_t)(wt + 2) * C * tsize) / tsize);
    if ((size_t)kRing * p->ring_row * tsize > scratch)
      scratch = (size_t)kRing * p->ring_row * tsize;
  }
  p->smem = p->scratch_off + scratch;
  return p->smem <= kSmemLimit;
}

// 256 threads where two blocks then fit on one SM (registers and shared
// memory), else 512: an SM overlaps one block's loads with the other's
// arithmetic and stores.  With the blur, y is kept in shared memory (so
// phase 2 does not blur again) where that costs no such overlap.  (Writing
// y over the band one row behind, for the calls where it does not fit
// beside it, measured slower than blurring again: it needs a barrier a row
// and registers for the halo rows' y.)
bool make_plan(int H, int W, int C, size_t tsize, int vec, bool blur,
               Plan* p) {
  const int half = kMaxThreads / 2;
  for (bool keep : {true, false}) {
    if (plan_for(H, W, C, tsize, vec, blur, half, keep, p) && p->resident &&
        p->smem <= kSmemHalf)
      return true;
  }
  return plan_for(H, W, C, tsize, vec, blur, kMaxThreads, false, p);
}

template <typename T, int VEC, bool BLUR, bool RESIDENT>
__global__ void __launch_bounds__(kMaxThreads)
    epilogue_kernel(const T* __restrict__ z, const T* __restrict__ noise,
                    const T* __restrict__ nw, const T* __restrict__ bias,
                    const T* __restrict__ gamma, const T* __restrict__ beta,
                    T* __restrict__ out, int B, Plan d, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int H = d.H, W = d.W, C = d.C;
  const int pix = tid / d.lanes, c0 = (tid % d.lanes) * VEC;
  const size_t P = (size_t)H * W;
  const size_t band0 = (size_t)rank * d.band_pix;     // the band's pixels
  const size_t band1 = min(P, band0 + d.band_pix);
  const int r0 = rank * d.rows_per;                   // and rows (blur)
  const int r1 = min(H, r0 + d.rows_per);

  float* stat = reinterpret_cast<float*>(smem);                // [2][C]
  float* mr = stat + 2 * C;                                    // [2][C]
  unsigned char* scratch = smem + d.scratch_off;
  T* ring = reinterpret_cast<T*>(scratch);
  T* band = reinterpret_cast<T*>(smem + d.band_off);
  T* nband = reinterpret_cast<T*>(smem + d.noise_off);   // its noise
  T* ybuf = reinterpret_cast<T*>(smem + d.y_off);        // keep_y: its y

  const bool has_bias = bias != nullptr;
  float nwf[VEC], bf[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    nwf[i] = to_f32(nw[c0 + i]);
    bf[i] = has_bias ? to_f32(bias[c0 + i]) : 0.0f;
  }
  const T* zb = nullptr;           // the current sample
  const T* nb = nullptr;
  T* ob = nullptr;

  // x = round(z + bias) of one channel vector, already in float
  auto add_bias = [&](float* v) {
    if (has_bias) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = round_to<T>(__fadd_rn(v[i], bf[i]));
    }
  };
  // y from the (blurred) x and the noise value of its pixel
  auto finish_y = [&](float n, float* y) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float t = __fadd_rn(y[i], round_to<T>(__fmul_rn(n, nwf[i])));
      y[i] = round_to<T>(fmaxf(t, 0.2f * t));
    }
  };
  // The blurred x of image column w; rN holds image row h + N - 1 (null
  // outside the image), in which w sits at column col.  Positions outside
  // the image are zero and take no bias; `edge` is false where none is
  // (the compiler drops the checks there).  The resident band holds x
  // already; the ring holds z.
  auto blur_y = [&](const T* r0p, const T* r1p, const T* r2p, int col,
                    int w, bool edge, float* y) {
    float cols[3][VEC];
#pragma unroll
    for (int dw = 0; dw < 3; ++dw) {
      const int ww = w + dw - 1;
      const bool okw = !edge || (ww >= 0 && ww < W);
      const size_t at = (size_t)(col + dw - 1) * C + c0;
      float r[3][VEC];
#pragma unroll
      for (int dh = 0; dh < 3; ++dh) {
        const T* row = dh == 0 ? r0p : (dh == 1 ? r1p : r2p);
        if (okw && (!edge || row != nullptr)) {
          load_vec<T, VEC>(row + at, r[dh]);
          if constexpr (!RESIDENT) add_bias(r[dh]);
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
  };

  // L2 mode: calls f(q, y) for every pixel q = h * W + w of the band with
  // its y, reading z from device memory (through the ring for the blur)
  auto walk = [&](auto&& f) {
    if constexpr (BLUR) {
      const int rs = d.ring_row;
      auto slot = [&](int hh) { return ring + ((hh - r0 + 1) & 3) * rs; };
      for (int w0 = 0; w0 < W; w0 += d.wt) {
        const int ncols = min(d.wt, W - w0);
        const int cs = max(w0 - 1, 0), ce = min(w0 + ncols + 1, W);
        // stage columns [cs, ce) of row hh into its slot: cp.async where
        // both ends are 16-byte aligned, else plain copies
        auto stage = [&](int hh) {
          if (hh < 0 || hh >= H) return;
          const T* src = zb + ((size_t)hh * W + cs) * C;
          T* dst = slot(hh) + (size_t)(cs - w0 + 1) * C;
          const size_t n = (size_t)(ce - cs) * C;
          if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
              (reinterpret_cast<uintptr_t>(dst) & 15) == 0 &&
              (n * sizeof(T)) % 16 == 0) {
            constexpr int per = 16 / sizeof(T);
            for (size_t i = (size_t)tid * per; i < n;
                 i += (size_t)blockDim.x * per)
              cp_async16(dst + i, src + i);
          } else {
            for (size_t i = tid; i < n; i += blockDim.x) dst[i] = src[i];
          }
        };
        stage(r0 - 1);
        stage(r0);
        cp_async_commit();
        stage(r0 + 1);
        cp_async_commit();
        for (int h = r0; h < r1; ++h) {
          if (h + 2 <= r1) stage(h + 2);   // into row h - 2's slot
          cp_async_commit();
          cp_async_wait<1>();      // rows up to h + 1 have landed
          __syncthreads();
          const T* up = h > 0 ? slot(h - 1) : nullptr;
          const T* dn = h + 1 < H ? slot(h + 1) : nullptr;
          for (int p = pix; p < ncols; p += d.prow) {
            const int w = w0 + p;
            float y[VEC];
            blur_y(up, slot(h), dn, p + 1, w, true, y);
            const size_t q = (size_t)h * W + w;
            finish_y(to_f32(nb[q]), y);
            f(q, y);
          }
          __syncthreads();         // before the next step refills a slot
        }
        cp_async_wait<0>();        // the groups of rows past the band
        __syncthreads();
      }
    } else {
      // no neighbourhood: straight from device memory, four pixels' loads
      // in flight per thread
      constexpr int U = 4;
      const size_t qe = band1;
      for (size_t q = band0 + pix; q < qe; q += U * d.prow) {
        float y[U][VEC], n[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const size_t qq = q + (size_t)u * d.prow;
          if (qq < qe) {
            load_vec<T, VEC>(zb + qq * C + c0, y[u]);
            n[u] = to_f32(nb[qq]);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const size_t qq = q + (size_t)u * d.prow;
          if (qq < qe) {
            add_bias(y[u]);
            finish_y(n[u], y[u]);
            f(qq, y[u]);
          }
        }
      }
    }
  };

  // Calls f(q, y) for every pixel of the band.  Resident: phase 1 computes
  // y from the band of z (the blur reads the halo rows from the
  // neighbouring ranks' bands); without the blur it stores y in place,
  // where phase 2 (again) reads it back.  With the blur, phase 2 reads y
  // back from beside the band (keep_y), else blurs again.  L2 mode: walk()
  // in both phases.
  auto for_each_y = [&](bool again, auto&& f) {
    if constexpr (RESIDENT && BLUR) {
      // row hh of the image: in this band or a neighbour's (null outside)
      auto row_at = [&](int hh) -> const T* {
        if (hh < 0 || hh >= H) return nullptr;
        const int owner = hh / d.rows_per;
        T* base = owner == rank ? band : cluster.map_shared_rank(band, owner);
        return base + (size_t)(hh - owner * d.rows_per) * W * C;
      };
      for (int h = r0; h < r1; ++h) {
        const T* up = row_at(h - 1);
        const T* mid = band + (size_t)(h - r0) * W * C;
        const T* dn = row_at(h + 1);
        const bool inner_rows = up != nullptr && dn != nullptr;
        for (int w = pix; w < W; w += d.prow) {
          const size_t q = (size_t)h * W + w;
          T* kept = ybuf + (q - band0) * C + c0;
          float y[VEC];
          if (again && d.keep_y) {
            load_vec<T, VEC>(kept, y);
          } else {
            if (inner_rows && w > 0 && w + 1 < W) {
              blur_y(up, mid, dn, w, w, false, y);
            } else {
              blur_y(up, mid, dn, w, w, true, y);
            }
            finish_y(to_f32(nband[q - band0]), y);
            if (d.keep_y) store_vec<T, VEC>(kept, y);
          }
          f(q, y);
        }
      }
    } else if constexpr (RESIDENT) {
      for (size_t q = band0 + pix; q < band1; q += d.prow) {
        T* at = band + (q - band0) * C + c0;
        float y[VEC];
        load_vec<T, VEC>(at, y);
        if (!again) {
          add_bias(y);
          finish_y(to_f32(nband[q - band0]), y);
          store_vec<T, VEC>(at, y);
        }
        f(q, y);
      }
    } else {
      walk(f);
    }
  };

  // a persistent cluster: one sample after another
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    zb = z + (size_t)b * P * C;
    nb = noise + (size_t)b * P;
    ob = out + (size_t)b * P * C;
    if constexpr (RESIDENT) {
      // the whole band and its noise in one burst of 16-byte copies
      auto fetch = [&](T* dst, const T* src, size_t n) {
        if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
            (n * sizeof(T)) % 16 == 0) {
          constexpr int per = 16 / sizeof(T);
          for (size_t i = (size_t)tid * per; i < n;
               i += (size_t)blockDim.x * per)
            cp_async16(dst + i, src + i);
        } else {
          for (size_t i = tid; i < n; i += blockDim.x) dst[i] = src[i];
        }
      };
      fetch(band, zb + band0 * C, (band1 - band0) * C);
      fetch(nband, nb + band0, band1 - band0);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if constexpr (BLUR) {
        // x = round(z + bias) once per value, in place, so that the blur
        // (here and in the neighbours' halos) reads x nine times for free
        if (has_bias) {
          for (size_t q = band0 + pix; q < band1; q += d.prow) {
            T* at = band + (q - band0) * C + c0;
            float v[VEC];
            load_vec<T, VEC>(at, v);
            add_bias(v);
            store_vec<T, VEC>(at, v);
          }
        }
        cluster.sync();            // the neighbours' bands, for the halo
      }
    }

    // ---- phase 1: y and its per-thread sums ----
    float s1[VEC], s2[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      s1[i] = 0.0f;
      s2[i] = 0.0f;
    }
    for_each_y(false, [&](size_t, const float* y) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        s1[i] += y[i];
        s2[i] += y[i] * y[i];
      }
    });

    // ---- statistics: block, then cluster, in a fixed order ----
    const int lane = tid & 31;
    if (d.wred) {                  // the warp's pass-rows, by a fixed tree
      for (int off = d.lanes; off < 32; off <<= 1) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], off);
          s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], off);
        }
      }
    }
    __syncthreads();               // the ring's last readers are done
    float* part1 = reinterpret_cast<float*>(scratch);
    const int nrows = d.wred ? d.threads / 32 : d.prow;
    float* part2 = part1 + nrows * C;
    if (!d.wred || lane < d.lanes) {
      const int slot = ((d.wred ? tid / 32 : pix) * d.lanes +
                        tid % d.lanes) * VEC;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        part1[slot + i] = s1[i];
        part2[slot + i] = s2[i];
      }
    }
    __syncthreads();
    // channel c of row r sits at slot (r * lanes + c / VEC) * VEC + c % VEC
    for (int c = tid; c < C; c += blockDim.x) {
      float a = 0.0f, sq = 0.0f;
      for (int r = 0; r < nrows; ++r) {
        const int s = (r * d.lanes + c / VEC) * VEC + c % VEC;
        a += part1[s];
        sq += part2[s];
      }
      stat[c] = a;
      stat[C + c] = sq;
    }
    cluster.sync();                // every rank's stat is complete
    const float n = (float)H * (float)W;
    for (int c = tid; c < C; c += blockDim.x) {
      float a = 0.0f, sq = 0.0f;
      for (int k = 0; k < d.K; ++k) {
        const float* rs = cluster.map_shared_rank(stat, k);
        a += rs[c];
        sq += rs[C + c];
      }
      const float m = a / n, m2 = sq / n;
      const float var = fmaxf(__fsub_rn(m2, __fmul_rn(m, m)), 0.0f);
      mr[c] = m;
      mr[C + c] = 1.0f / sqrtf(var + eps);
    }
    cluster.sync();                // no rank's stat is read after this

    // ---- phase 2: normalise, affine, write ----
    float m[VEC], r[VEC], ga[VEC], be[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const size_t bc = (size_t)b * C + c0 + i;
      m[i] = mr[c0 + i];
      r[i] = mr[C + c0 + i];
      ga[i] = to_f32(gamma[bc]);
      be[i] = to_f32(beta[bc]);
    }
    for_each_y(true, [&](size_t q, const float* y) {
      float o[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float zn =
            round_to<T>(__fmul_rn(__fsub_rn(y[i], m[i]), r[i]));
        o[i] = __fadd_rn(__fmul_rn(ga[i], zn), be[i]);
      }
      store_vec<T, VEC>(ob + q * C + c0, o);
    });
    // before the next sample refills the band, which the neighbours read
    if constexpr (RESIDENT && BLUR) {
      cluster.sync();
    } else {
      __syncthreads();
    }
  }
}

template <typename T, int VEC, bool BLUR, bool RESIDENT>
cudaError_t launch(const Plan& p, int B, const void* z, const void* noise,
                   const void* nw, const void* bias, const void* gamma,
                   const void* beta, void* out, float eps,
                   cudaStream_t stream) {
  auto kernel = epilogue_kernel<T, VEC, BLUR, RESIDENT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.K, B, 1);
  cfg.blockDim = dim3(p.threads, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // as many clusters as fit on the card at once, each looping over samples
  int fit = 0;
  err = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (fit <= 0) return cudaErrorInvalidConfiguration;
  cfg.gridDim.y = fit < B ? fit : B;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(z), static_cast<const T*>(noise),
      static_cast<const T*>(nw), static_cast<const T*>(bias),
      static_cast<const T*>(gamma), static_cast<const T*>(beta),
      static_cast<T*>(out), B, p, eps);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t run(bool blur, int B, int H, int W, int C, const void* z,
                const void* noise, const void* nw, const void* bias,
                const void* gamma, const void* beta, void* out, float eps,
                cudaStream_t stream) {
  Plan p;
  if (!make_plan(H, W, C, sizeof(T), VEC, blur, &p))
    return cudaErrorInvalidValue;
  if (blur)
    return p.resident
               ? launch<T, VEC, true, true>(p, B, z, noise, nw, bias, gamma,
                                            beta, out, eps, stream)
               : launch<T, VEC, true, false>(p, B, z, noise, nw, bias, gamma,
                                             beta, out, eps, stream);
  return p.resident
             ? launch<T, VEC, false, true>(p, B, z, noise, nw, bias, gamma,
                                           beta, out, eps, stream)
             : launch<T, VEC, false, false>(p, B, z, noise, nw, bias, gamma,
                                            beta, out, eps, stream);
}

int vec_width(int C, bool bf16) {
  if (bf16 && C % 8 == 0) return 8;
  if (C % 4 == 0) return 4;
  return C % 2 == 0 ? 2 : 1;
}

}  // namespace

// How a call of this shape is cut up, for reports: out[0..6] = cluster size
// K, pixels per rank, threads per block, ring tile width (L2 mode with the
// blur, else 0), resident (1: the band stays in shared memory, 0: phase 2
// re-reads z from L2), dynamic shared memory bytes per block.  Returns 0, or cudaErrorInvalidValue if no plan
// fits.
extern "C" int gen_epilogue_plan(int H, int W, int C, int is_bf16,
                                 int apply_blur, long long* out) {
  Plan p;
  if (H <= 0 || W <= 0 || C <= 0 ||
      !make_plan(H, W, C, is_bf16 ? 2 : 4, vec_width(C, is_bf16 != 0),
                 apply_blur != 0, &p))
    return (int)cudaErrorInvalidValue;
  out[0] = p.K;
  out[1] = p.band_pix;
  out[2] = p.threads;
  out[3] = p.wt;
  out[4] = p.resident;
  out[5] = (long long)p.smem;
  return 0;
}

// z, out: [B, H, W, C]; noise: [B, H, W]; nw: [C] (sqrt(2)-scaled); bias: [C]
// or null; gamma, beta: [B, C] -- all contiguous, of one type (float32 if
// is_bf16 == 0, else bfloat16), z and out 16-byte aligned.  One launch on
// `stream`; returns its error (cudaGetLastError() after the launch).
extern "C" int gen_epilogue_forward(const void* z, const void* noise,
                                    const void* nw, const void* bias,
                                    const void* gamma, const void* beta,
                                    void* out, int B, int H, int W, int C,
                                    int is_bf16, int apply_blur, float eps,
                                    void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool blur = apply_blur != 0;
  const int vec = vec_width(C, is_bf16 != 0);
  if (is_bf16) {
    using T = __nv_bfloat16;
    switch (vec) {
      case 8: return (int)run<T, 8>(blur, B, H, W, C, z, noise, nw, bias,
                                    gamma, beta, out, eps, st);
      case 4: return (int)run<T, 4>(blur, B, H, W, C, z, noise, nw, bias,
                                    gamma, beta, out, eps, st);
      case 2: return (int)run<T, 2>(blur, B, H, W, C, z, noise, nw, bias,
                                    gamma, beta, out, eps, st);
      default: return (int)run<T, 1>(blur, B, H, W, C, z, noise, nw, bias,
                                     gamma, beta, out, eps, st);
    }
  }
  switch (vec) {
    case 4: return (int)run<float, 4>(blur, B, H, W, C, z, noise, nw, bias,
                                      gamma, beta, out, eps, st);
    case 2: return (int)run<float, 2>(blur, B, H, W, C, z, noise, nw, bias,
                                      gamma, beta, out, eps, st);
    default: return (int)run<float, 1>(blur, B, H, W, C, z, noise, nw, bias,
                                       gamma, beta, out, eps, st);
  }
}
