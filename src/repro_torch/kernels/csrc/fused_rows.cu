// K2: the query-fused integral histogram for Hopper (sm_90a): only the
// requested rows of H, in request order.  Replaces
// repro/kernels/fused_rows.py::_fused_rows_kernel.  What it computes:
//
//   out[f, b, i, c] = carry[f, b, c] + #{(r, c') : r <= rows[i], c' <= c,
//                                         idx[f, r, c'] == b}
//
// What bounds it: bytes, once nothing walks: the ids of rows [0, rows[K-1]]
// read and K rows of num_bins floats written.  A walk down every row to the
// last requested one (this port's first K2, over wf_tis_scan.cuh) costs
// about half a microsecond a row whatever it emits, so this design has
// none.  It moves the output rows three times instead (pass A writes them,
// pass B reads and writes them).  A row scan is linear, so row rows[i] of H
// is the carry row plus the sum over row chunks of each chunk's row-scanned
// column counts:
//
//   * The host cuts [0, rows[K-1]] into M chunks (fused_rows.py
//     chunk_plan): a chunk ends at every requested row and is at most R
//     rows long, R chosen so that pass A has at least two CTAs an SM.
//     plan[0, M) holds each chunk's first row, plan[M, 2M) the output slot
//     of the requested row it ends (-1 where it ends none).
//   * Pass A (chunk_kernel): one CTA per (frame, chunk, block of BB bins),
//     bin blocks of one chunk next to each other in launch order so they
//     share the chunk's ids in L2.  Thread t counts its 4 columns' hits of
//     BB bins over the chunk's rows in registers, one byte a count (a chunk
//     holds at most 255 rows), four bins to a register: a few integer ops
//     an id, not a compare and an add per bin (8 rows' loads in flight, as
//     wf_tis.cu's count_kernel), then the CTA scans the counts across the
//     row (cta_exclusive_scan) and writes P[f, b, m, :].  A CTA covers at
//     most 2048 columns at a time and walks wider rows slab by slab with the
//     slab totals carried, so registers stay at BB / 4 packed counts a
//     column whatever the width.
//   * Pass B (sum_kernel): one thread per (frame, bin, 4 columns) walks
//     the M chunks with a running float4 sum that starts from the carry row
//     (a row of H, added as it is) and writes the sum at every chunk that
//     ends a requested row: K4 vscan's access pattern, 8 chunks' loads in
//     flight.  Where M == K every chunk ends a requested row, in order, so
//     the caller passes P == out and pass B runs in place (each element is
//     read before it is written, by the thread that writes it).
//
// No CTA waits on another and nothing depends on grid order.  Every value
// is an integer below 2^24, so the fp32 sums are exact in any order and the
// result equals the plain version bit for bit.  No tensor cores are used.

#include "wf_tis_scan.cuh"

namespace {

using wf_tis_scan::cta_exclusive_scan;
using wf_tis_scan::load_ids;

constexpr int kMaxThreads = 512;  // pass A threads: 2048 columns a slab
// Pass A CTAs of kMaxThreads an SM must hold: 2 caps a thread at 64
// registers (28 bytes spill at BB = 8), which keeps six 160-thread CTAs on
// an SM at 640 columns; uncapped, BB = 8 takes 128 and pass A 30% longer
// at the clip (scripts/k2_variants.py).
constexpr int kMinCtas = 2;
constexpr int kBatch = 8;         // rows a pass A thread loads at once
// Pass B threads per CTA: small CTAs spread one frame's few threads (32
// bins x 160 column quads at 640 columns) over 80 SMs.
constexpr int kSumThreads = 64;
constexpr int kSumBatch = 8;      // chunks a pass B thread loads at once

__host__ __device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int BB>
__global__ void __launch_bounds__(kMaxThreads, kMinCtas)
chunk_kernel(const int* __restrict__ idx,    // (n, h, w) bin ids
             const int* __restrict__ first,  // (M,) first row of each chunk
             float* __restrict__ P,          // (n, nb, M, w)
             int h, int h_run, int w, int nb, int chunks, int blocks) {
  __shared__ float warp_tot[2 * BB * 32];
  const int threads = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int fm = blockIdx.x / blocks;        // (frame, chunk)
  const int b0 = (blockIdx.x - fm * blocks) * BB;
  const int f = fm / chunks;
  const int m = fm - f * chunks;
  const int r_begin = __ldg(first + m);
  const int r_end = m + 1 < chunks ? __ldg(first + m + 1) : h_run;
  const bool vec_in = (w & 3) == 0 && aligned16(idx);
  const bool vec_out = (w & 3) == 0 && aligned16(P);
  const int* frame = idx + (size_t)f * h * w;

  float before[BB];                          // counts of the slabs to the left
#pragma unroll
  for (int j = 0; j < BB; ++j) before[j] = 0.f;

  for (int c0 = 0, s = 0; c0 < w; c0 += 4 * threads, ++s) {
    const int c = c0 + 4 * tid;
    // Hits of bin b0 + d in column c + e: byte d % 4 of pk[d / 4][e].  A
    // chunk holds at most 255 rows, so no byte overflows.
    constexpr int NP = (BB + 3) / 4;
    unsigned pk[NP][4];
#pragma unroll
    for (int q = 0; q < NP; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) pk[q][e] = 0u;
    for (int r0 = r_begin; r0 < r_end; r0 += kBatch) {
      // A batch of rows' loads in flight before any is counted.
      int4 id[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        int4 one[1] = {make_int4(-1, -1, -1, -1)};
        if (r0 + k < r_end)
          load_ids<1>(frame + (size_t)(r0 + k) * w, c, w, vec_in, one);
        id[k] = one[0];
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int v[4] = {id[k].x, id[k].y, id[k].z, id[k].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const unsigned d = (unsigned)(v[e] - b0);   // huge when below b0
          const unsigned inc = d < BB ? 1u << ((d & 3u) << 3) : 0u;
#pragma unroll
          for (int q = 0; q < NP; ++q)
            pk[q][e] += (d >> 2) == (unsigned)q ? inc : 0u;
        }
      }
    }
    float4 cnt[BB];
#pragma unroll
    for (int j = 0; j < BB; ++j) {
      const int sh = 8 * (j & 3);
      cnt[j] = make_float4((float)((pk[j >> 2][0] >> sh) & 0xffu),
                           (float)((pk[j >> 2][1] >> sh) & 0xffu),
                           (float)((pk[j >> 2][2] >> sh) & 0xffu),
                           (float)((pk[j >> 2][3] >> sh) & 0xffu));
    }

    // The chunk's counts scanned across the row: thread totals, their
    // exclusive prefix over the CTA, then the prefix within the thread.
    float tot[BB];
    float excl[BB];
#pragma unroll
    for (int j = 0; j < BB; ++j)
      tot[j] = (cnt[j].x + cnt[j].y) + (cnt[j].z + cnt[j].w);
    float* wt = warp_tot + (s & 1) * BB * 32;
    cta_exclusive_scan<BB>(tot, excl, wt, lane, warp);

#pragma unroll
    for (int j = 0; j < BB; ++j) {
      const int b = b0 + j;
      if (b >= nb) break;
      float4 o;
      o.x = before[j] + excl[j] + cnt[j].x;
      o.y = o.x + cnt[j].y;
      o.z = o.y + cnt[j].z;
      o.w = o.z + cnt[j].w;
      float* dst = P + (((size_t)f * nb + b) * chunks + m) * w + c;
      if (vec_out) {
        if (c < w) *reinterpret_cast<float4*>(dst) = o;
      } else {
        if (c < w) dst[0] = o.x;
        if (c + 1 < w) dst[1] = o.y;
        if (c + 2 < w) dst[2] = o.z;
        if (c + 3 < w) dst[3] = o.w;
      }
    }

    // Each bin's total over this slab (the per-warp totals in `wt`), for
    // the slabs to the right.
    if (c0 + 4 * threads < w) {
#pragma unroll
      for (int j = 0; j < BB; ++j)
        for (int k = 0; k < (threads >> 5); ++k) before[j] += wt[j * 32 + k];
    }
  }
}

// P and out may be the same array (M == K), so neither is __restrict__ and
// P is read with plain loads.
template <bool VEC>
__global__ void __launch_bounds__(kSumThreads)
sum_kernel(const float* P,                   // (planes, M, w)
           const float* __restrict__ carry,  // (planes, w) or nullptr
           const int* __restrict__ slot,     // (M,) output row or -1
           float* out,                       // (planes, K, w)
           long long planes, int chunks, int k_rows, int w) {
  const long long ncol = (w + 3) / 4;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= planes * ncol) return;
  const int c = (int)(t % ncol) * 4;
  const long long p = t / ncol;
  const float* src = P + p * chunks * w + c;
  float* dst = out + p * k_rows * w + c;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (carry != nullptr) {
    const float* cr = carry + p * w + c;
    if (VEC) {
      acc = __ldg(reinterpret_cast<const float4*>(cr));
    } else {
      acc.x = __ldg(cr);
      acc.y = c + 1 < w ? __ldg(cr + 1) : 0.f;
      acc.z = c + 2 < w ? __ldg(cr + 2) : 0.f;
      acc.w = c + 3 < w ? __ldg(cr + 3) : 0.f;
    }
  }
  for (int m0 = 0; m0 < chunks; m0 += kSumBatch) {
    float4 v[kSumBatch];
#pragma unroll
    for (int k = 0; k < kSumBatch; ++k) {
      const float* row = src + (long long)(m0 + k) * w;
      if (m0 + k >= chunks) {
        v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      } else if (VEC) {
        v[k] = *reinterpret_cast<const float4*>(row);
      } else {
        v[k] = make_float4(row[0], c + 1 < w ? row[1] : 0.f,
                           c + 2 < w ? row[2] : 0.f, c + 3 < w ? row[3] : 0.f);
      }
    }
#pragma unroll
    for (int k = 0; k < kSumBatch; ++k) {
      if (m0 + k >= chunks) break;
      acc.x += v[k].x;
      acc.y += v[k].y;
      acc.z += v[k].z;
      acc.w += v[k].w;
      const int i = __ldg(slot + m0 + k);
      if (i < 0) continue;
      float* row = dst + (long long)i * w;
      if (VEC) {
        *reinterpret_cast<float4*>(row) = acc;
      } else {
        row[0] = acc.x;
        if (c + 1 < w) row[1] = acc.y;
        if (c + 2 < w) row[2] = acc.z;
        if (c + 3 < w) row[3] = acc.w;
      }
    }
  }
}

template <int BB>
cudaError_t launch_chunks(const int* idx, const int* first, float* P, int n,
                          int h, int h_run, int w, int nb, int chunks,
                          int threads, cudaStream_t stream) {
  const int blocks = (nb + BB - 1) / BB;
  const long long grid = (long long)n * chunks * blocks;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  chunk_kernel<BB><<<(unsigned)grid, threads, 0, stream>>>(
      idx, first, P, h, h_run, w, nb, chunks, blocks);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes: the plan's copy, pass A, then pass B, on
// `stream`.  plan_host is (2 * chunks,) ints in pageable host memory: CUDA
// stages such a copy before cudaMemcpyAsync returns, without synchronising
// the device, so the caller may free or reuse it at once.
// plan is room for it on the device.  P is (n, num_bins, chunks, w) floats
// of scratch, or out itself when chunks == k_rows.  Returns the first
// failing cudaError_t, else cudaSuccess.
extern "C" int fused_rows_launch(const int* idx, const float* carry,
                                 const int* plan_host, int* plan, float* P,
                                 float* out, int n, int h, int h_run, int w,
                                 int num_bins, int chunks, int k_rows,
                                 int bin_block, int threads, void* stream) {
  if (n <= 0 || w <= 0 || num_bins <= 0 || k_rows <= 0)
    return (int)cudaSuccess;
  if (threads <= 0 || threads > kMaxThreads || (threads & 31) != 0 ||
      chunks < k_rows || h_run <= 0 || h_run > h ||
      (P == out && chunks != k_rows))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemcpyAsync(plan, plan_host,
                                    sizeof(int) * 2 * (size_t)chunks,
                                    cudaMemcpyHostToDevice, st);
  if (err != cudaSuccess) return (int)err;
  switch (bin_block) {
    case 1: err = launch_chunks<1>(idx, plan, P, n, h, h_run, w, num_bins, chunks, threads, st); break;
    case 2: err = launch_chunks<2>(idx, plan, P, n, h, h_run, w, num_bins, chunks, threads, st); break;
    case 4: err = launch_chunks<4>(idx, plan, P, n, h, h_run, w, num_bins, chunks, threads, st); break;
    case 8: err = launch_chunks<8>(idx, plan, P, n, h, h_run, w, num_bins, chunks, threads, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;

  const long long planes = (long long)n * num_bins;
  const long long items = planes * ((w + 3) / 4);
  const long long grid = (items + kSumThreads - 1) / kSumThreads;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec = (w & 3) == 0 && aligned16(P) && aligned16(out) &&
                   (carry == nullptr || aligned16(carry));
  if (vec) {
    sum_kernel<true><<<(unsigned)grid, kSumThreads, 0, st>>>(
        P, carry, plan + chunks, out, planes, chunks, k_rows, w);
  } else {
    sum_kernel<false><<<(unsigned)grid, kSumThreads, 0, st>>>(
        P, carry, plan + chunks, out, planes, chunks, k_rows, w);
  }
  return (int)cudaGetLastError();
}
