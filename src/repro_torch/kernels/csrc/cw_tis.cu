// K4: the CW-TiS integral histogram for Hopper (sm_90a), two launches.
// Replaces repro/kernels/cw_tis.py::_hscan_kernel and ::_vscan_kernel.
//
//   hscan:  hh[f, b, r, c] = #{c' <= c : idx[f, r, c'] == b}
//   vscan:  H[f, b, r, c]  = carry[f, b, c] + sum_{r' <= r} hh[f, b, r', c]
//
// What bounds it: bytes.  The paper's CW-TiS makes four passes over the
// b-fold H-sized data (hscan writes hh, vscan reads it and writes H)
// where WF-TiS makes two; the passes stay separate here on purpose, since
// fusing them is WF-TiS (K1).
//
// hscan: one CTA per (frame, block of BB bins, group of kRowsPerCta rows),
//   all three folded into grid x (no 65535 cap on the rows).  Thread t
//   owns 4*Q contiguous columns of a slab of every row of its group; the
//   one-hot is formed from the bin id in registers, and each slab is
//   scanned across with the CTA-wide scan of wf_tis_scan.cuh (warp
//   shuffles, then the per-warp totals): one __syncthreads per slab for
//   all BB bins.  A row no wider than threads * 4 * Q (16,384 columns) is
//   one slab; a wider one is walked slab by slab (SLABS), each bin's
//   total carried from slab to slab, as fused_rows.cu's pass A does.  The
//   TPU kernel's row carry between column tiles is that scan and that
//   carry.  Rows are independent, so groups of rows go to different CTAs.
//   hh is written once, 16 bytes a thread where rows are aligned.
//
// vscan: one thread per (frame, bin, 4 contiguous columns), walking the
//   rows top to bottom with a running sum seeded from the carry-in (zeros
//   if none): the TPU kernel's column carry between row tiles becomes this
//   loop's carry.  Neighbouring threads take neighbouring columns of the
//   same plane, so each row's loads and stores are coalesced; the row loop
//   is unrolled so several rows' loads are in flight per thread.
//
// Every value is an integer below 2^24, so the fp32 adds are exact in any
// order: H equals the plain version, and K1, bit for bit.

#include "wf_tis_scan.cuh"

namespace {

using wf_tis_scan::cta_exclusive_scan;
using wf_tis_scan::load_ids;

constexpr int kRowsPerCta = 8;    // hscan rows per CTA
constexpr int kVThreads = 256;    // vscan threads per CTA

template <int BB, int Q, bool SLABS>
__global__ void __launch_bounds__(1024)
hscan_kernel(const int* __restrict__ idx,    // (n, h, w) bin ids
             float* __restrict__ hh,         // (n, nb, h, w)
             int n, int h, int w, int nb, int slab_cols) {
  __shared__ float warp_tot[2 * BB * 32];
  const int threads = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int blocks = (nb + BB - 1) / BB;
  int x = blockIdx.x;                        // (group, bin block, frame)
  const int f = x % n;
  x /= n;
  const int b0 = (x % blocks) * BB;
  const int r_begin = (x / blocks) * kRowsPerCta;
  const int r_end = min(h, r_begin + kRowsPerCta);
  const bool vec_in =
      (w & 3) == 0 && (reinterpret_cast<uintptr_t>(idx) & 15) == 0;
  const bool vec_out =
      (w & 3) == 0 && (reinterpret_cast<uintptr_t>(hh) & 15) == 0;
  const int* frame = idx + (size_t)f * h * w;

  int calls = 0;                             // scans so far: the wt parity
  for (int r = r_begin; r < r_end; ++r) {
    float before[BB];                        // SLABS: the slabs to the left
#pragma unroll
    for (int j = 0; j < BB; ++j) before[j] = 0.f;
    for (int c_lo = 0; c_lo < w; c_lo += slab_cols) {
      const int c_hi = min(w, c_lo + slab_cols);
      const int c_first = c_lo + tid * 4 * Q;
      int4 ids[Q];
      load_ids<Q>(frame + (size_t)r * w, c_first, c_hi, vec_in, ids);

      float tot[BB];
#pragma unroll
      for (int j = 0; j < BB; ++j) {
        const int b = b0 + j;
        float t = 0.f;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          t += (ids[q].x == b ? 1.f : 0.f) + (ids[q].y == b ? 1.f : 0.f) +
               (ids[q].z == b ? 1.f : 0.f) + (ids[q].w == b ? 1.f : 0.f);
        }
        tot[j] = t;
      }
      float excl[BB];
      float* wt = warp_tot + (calls++ & 1) * BB * 32;
      cta_exclusive_scan<BB>(tot, excl, wt, lane, warp);

#pragma unroll
      for (int j = 0; j < BB; ++j) {
        const int b = b0 + j;
        if (b >= nb) continue;
        float run = excl[j];
        if constexpr (SLABS) run += before[j];
        float* orow = hh + (((size_t)f * nb + b) * h + r) * w;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int c = c_first + 4 * q;
          float4 o;
          o.x = run + (ids[q].x == b ? 1.f : 0.f);
          o.y = o.x + (ids[q].y == b ? 1.f : 0.f);
          o.z = o.y + (ids[q].z == b ? 1.f : 0.f);
          o.w = o.z + (ids[q].w == b ? 1.f : 0.f);
          run = o.w;
          if (vec_out) {
            if (c < c_hi) *reinterpret_cast<float4*>(orow + c) = o;
          } else {
            if (c < c_hi) orow[c] = o.x;
            if (c + 1 < c_hi) orow[c + 1] = o.y;
            if (c + 2 < c_hi) orow[c + 2] = o.z;
            if (c + 3 < c_hi) orow[c + 3] = o.w;
          }
        }
      }

      // Each bin's total over this slab (the per-warp totals in `wt`,
      // which no thread rewrites before the next scan's barrier), for the
      // slabs to the right.
      if constexpr (SLABS) {
        if (c_hi < w) {
#pragma unroll
          for (int j = 0; j < BB; ++j)
            for (int k = 0; k < (threads >> 5); ++k) before[j] += wt[j * 32 + k];
        }
      }
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kVThreads)
vscan_kernel(const float* __restrict__ hh,     // (planes, h, w)
             const float* __restrict__ carry,  // (planes, w) or nullptr
             float* __restrict__ out,          // (planes, h, w)
             long long planes, int h, int w) {
  const long long ncol = (w + 3) / 4;
  const long long total = planes * ncol;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(t % ncol) * 4;
    const long long p = t / ncol;
    const float* src = hh + p * h * w + c;
    float* dst = out + p * h * w + c;
    if (VEC) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      if (carry != nullptr)
        acc = __ldg(reinterpret_cast<const float4*>(carry + p * w + c));
#pragma unroll 4
      for (int r = 0; r < h; ++r) {
        const float4 v =
            __ldg(reinterpret_cast<const float4*>(src + (long long)r * w));
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
        *reinterpret_cast<float4*>(dst + (long long)r * w) = acc;
      }
    } else {
      float acc[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[e] = (carry != nullptr && c + e < w) ? __ldg(carry + p * w + c + e)
                                                 : 0.f;
#pragma unroll 4
      for (int r = 0; r < h; ++r) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (c + e < w) {
            acc[e] += __ldg(src + (long long)r * w + e);
            dst[(long long)r * w + e] = acc[e];
          }
        }
      }
    }
  }
}

template <int BB, int Q, bool SLABS>
cudaError_t launch_hscan_bbq(const int* idx, float* hh, int n, int h, int w,
                             int nb, int threads, int slab_cols,
                             cudaStream_t stream) {
  const long long grid = (long long)n * ((nb + BB - 1) / BB) *
                         ((h + kRowsPerCta - 1) / kRowsPerCta);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  hscan_kernel<BB, Q, SLABS><<<(unsigned)grid, threads, 0, stream>>>(
      idx, hh, n, h, w, nb, slab_cols);
  return cudaGetLastError();
}

// Slabs narrower than the row are wider than 8,192 columns, so 4 columns
// a chunk.
template <int BB>
cudaError_t launch_hscan_bb(const int* idx, float* hh, int n, int h, int w,
                            int nb, int threads, int q, int slab_cols,
                            cudaStream_t stream) {
  if (slab_cols < w)
    return q == 4 ? launch_hscan_bbq<BB, 4, true>(idx, hh, n, h, w, nb,
                                                  threads, slab_cols, stream)
                  : cudaErrorInvalidValue;
  switch (q) {
    case 1: return launch_hscan_bbq<BB, 1, false>(idx, hh, n, h, w, nb, threads, w, stream);
    case 2: return launch_hscan_bbq<BB, 2, false>(idx, hh, n, h, w, nb, threads, w, stream);
    case 4: return launch_hscan_bbq<BB, 4, false>(idx, hh, n, h, w, nb, threads, w, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Plain C interface for ctypes; each returns the cudaError_t of its launch.
extern "C" int cw_tis_hscan_launch(const int* idx, float* hh, int n, int h,
                                   int w, int num_bins, int bin_block,
                                   int threads, int q, int slab_cols,
                                   void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || num_bins <= 0) return (int)cudaSuccess;
  if (threads <= 0 || threads > 1024 || (threads & 31) != 0 ||
      slab_cols <= 0 || (long long)threads * 4 * q < slab_cols ||
      slab_cols > w)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (bin_block) {
    case 1: return (int)launch_hscan_bb<1>(idx, hh, n, h, w, num_bins, threads, q, slab_cols, s);
    case 2: return (int)launch_hscan_bb<2>(idx, hh, n, h, w, num_bins, threads, q, slab_cols, s);
    case 4: return (int)launch_hscan_bb<4>(idx, hh, n, h, w, num_bins, threads, q, slab_cols, s);
    case 8: return (int)launch_hscan_bb<8>(idx, hh, n, h, w, num_bins, threads, q, slab_cols, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int cw_tis_vscan_launch(const float* hh, const float* carry,
                                   float* out, long long planes, int h, int w,
                                   int max_blocks, void* stream) {
  if (planes <= 0 || h <= 0 || w <= 0) return (int)cudaSuccess;
  if (max_blocks <= 0) return (int)cudaErrorInvalidValue;
  const long long items = planes * ((w + 3) / 4);
  long long blocks = (items + kVThreads - 1) / kVThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  const bool vec = (w & 3) == 0 && aligned16(hh) && aligned16(out) &&
                   (carry == nullptr || aligned16(carry));
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    vscan_kernel<true><<<(unsigned)blocks, kVThreads, 0, s>>>(hh, carry, out,
                                                              planes, h, w);
  } else {
    vscan_kernel<false><<<(unsigned)blocks, kVThreads, 0, s>>>(hh, carry, out,
                                                               planes, h, w);
  }
  return (int)cudaGetLastError();
}
