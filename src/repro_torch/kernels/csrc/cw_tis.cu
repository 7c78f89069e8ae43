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
// hscan: one CTA per (frame, block of BB bins, group of kRowsPerCta rows).
//   Thread t owns 4*Q contiguous columns of every row of its group; the
//   one-hot is formed from the bin id in registers, and each row is
//   scanned across the width with the CTA-wide scan of wf_tis_scan.cuh
//   (warp shuffles, then the per-warp totals): one __syncthreads per row
//   for all BB bins.  The TPU kernel's row carry between column tiles is
//   that scan.  Rows are independent, so groups of rows go to different
//   CTAs.  hh is written once, 16 bytes a thread where rows are aligned.
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

template <int BB, int Q>
__global__ void __launch_bounds__(1024)
hscan_kernel(const int* __restrict__ idx,    // (n, h, w) bin ids
             float* __restrict__ hh,         // (n, nb, h, w)
             int h, int w, int nb) {
  __shared__ float warp_tot[2 * BB * 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int f = blockIdx.x;
  const int b0 = blockIdx.y * BB;
  const int r_begin = blockIdx.z * kRowsPerCta;
  const int r_end = min(h, r_begin + kRowsPerCta);
  const int c_first = tid * 4 * Q;
  const bool vec_in =
      (w & 3) == 0 && (reinterpret_cast<uintptr_t>(idx) & 15) == 0;
  const bool vec_out =
      (w & 3) == 0 && (reinterpret_cast<uintptr_t>(hh) & 15) == 0;
  const int* frame = idx + (size_t)f * h * w;

  for (int r = r_begin; r < r_end; ++r) {
    int4 ids[Q];
    load_ids<Q>(frame + (size_t)r * w, c_first, w, vec_in, ids);

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
    cta_exclusive_scan<BB>(tot, excl, warp_tot + ((r - r_begin) & 1) * BB * 32,
                           lane, warp);

#pragma unroll
    for (int j = 0; j < BB; ++j) {
      const int b = b0 + j;
      if (b >= nb) continue;
      float run = excl[j];
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
          if (c < w) *reinterpret_cast<float4*>(orow + c) = o;
        } else {
          if (c < w) orow[c] = o.x;
          if (c + 1 < w) orow[c + 1] = o.y;
          if (c + 2 < w) orow[c + 2] = o.z;
          if (c + 3 < w) orow[c + 3] = o.w;
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

template <int BB, int Q>
cudaError_t launch_hscan_bbq(const int* idx, float* hh, int n, int h, int w,
                             int nb, int threads, cudaStream_t stream) {
  const dim3 grid(n, (nb + BB - 1) / BB, (h + kRowsPerCta - 1) / kRowsPerCta);
  hscan_kernel<BB, Q><<<grid, threads, 0, stream>>>(idx, hh, h, w, nb);
  return cudaGetLastError();
}

template <int BB>
cudaError_t launch_hscan_bb(const int* idx, float* hh, int n, int h, int w,
                            int nb, int threads, int q, cudaStream_t stream) {
  switch (q) {
    case 1: return launch_hscan_bbq<BB, 1>(idx, hh, n, h, w, nb, threads, stream);
    case 2: return launch_hscan_bbq<BB, 2>(idx, hh, n, h, w, nb, threads, stream);
    case 4: return launch_hscan_bbq<BB, 4>(idx, hh, n, h, w, nb, threads, stream);
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
                                   int threads, int q, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || num_bins <= 0) return (int)cudaSuccess;
  if (threads <= 0 || threads > 1024 || (threads & 31) != 0 ||
      (long long)threads * 4 * q < w || (h + kRowsPerCta - 1) / kRowsPerCta > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (bin_block) {
    case 1: return (int)launch_hscan_bb<1>(idx, hh, n, h, w, num_bins, threads, q, s);
    case 2: return (int)launch_hscan_bb<2>(idx, hh, n, h, w, num_bins, threads, q, s);
    case 4: return (int)launch_hscan_bb<4>(idx, hh, n, h, w, num_bins, threads, q, s);
    case 8: return (int)launch_hscan_bb<8>(idx, hh, n, h, w, num_bins, threads, q, s);
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
