// WF-TiS integral-histogram scan for Hopper (sm_90a), the dense kernel
// (wf_tis.cu, K1).  Its row loader and CTA-wide row scan (load_ids,
// cta_exclusive_scan) are also the horizontal pass of CW-TiS (cw_tis.cu,
// K4) and the chunk pass of the query-fused kernel (fused_rows.cu, K2).
//
// Replaces repro/kernels/wf_tis.py::_wf_tis_kernel.  What it computes:
//
//   H[f, b, r, c] = carry[f, b, c] + #{(r', c') : r' <= r, c' <= c,
//                                      idx[f, r', c'] == b}
//
// What bounds it: the b-fold fp32 write of H.  Per pixel it reads one
// int32 bin id and writes num_bins floats, so at the paper's 32 bins the
// write is 32x the read and the arithmetic is a few adds per float.  The
// design keeps everything but that write on chip:
//
//   * One CTA per (frame, block of BB bins, strip of rows, strip of
//     columns) walks its strip top to bottom.  Carries move along that
//     loop, never between CTAs: no grid order, no atomics (the TPU
//     kernel's VMEM carries rely on a sequential grid).
//   * Thread t owns 4*Q contiguous columns.  For each of its columns and
//     bins it keeps the running column count V (the vertical prefix) in
//     shared memory; the one-hot is formed from the bin id in registers and
//     never reaches device memory.
//   * Row r of H is the prefix over columns of V[r, :]: a thread-local
//     prefix over its 4*Q columns, a warp scan of thread totals with
//     shuffles, and a pass over the per-warp totals in shared memory.  One
//     __syncthreads per row (double-buffered warp totals).
//   * The band carry-in enters as the column differences of the carry row,
//     seeded into V, so the same prefix reproduces carry[c] + local H.
//   * Strips.  A walk costs about half a microsecond a row, so a
//     frame walked by one CTA per (frame, bin block) leaves most SMs idle
//     when there are few frames (one 480x640 frame at 32 bins: 32 CTAs of
//     480 rows).  Cut into strips of R rows, each CTA walks R rows; a
//     pre-pass (wf_tis.cu's count_kernel, a launch of its own) first
//     counts each column's hits of each bin in every strip but the last,
//     and strip s seeds V with the counts of strips 0..s-1 on top of the
//     carry's differences.  One strip is the whole walk, which
//     kernels/wf_tis.py::launch_shape keeps for shapes that already fill
//     the card (the clip, 1080p, a 4K band) and for runs too low for
//     strips to pay (a video dirty run); it needs no pre-pass.
//   * Column strips.  A CTA's V covers at most threads * 4 * Q = 16,384
//     columns (64 KiB a bin), so a wider frame is cut into column strips
//     of strip_cols columns (whole blocks of kColBlock), a CTA each: the
//     row strips turned on their side.  Row r of strip j needs, for each
//     bin, the hits in rows [0, r] x columns [0, c_j): the count of a
//     virtual column left of the strip, which the CTA keeps in the V of
//     its first column (thread 0, chunk 0), so that the row prefix carries
//     it to every column of the strip.  A second pre-pass (wf_tis.cu's
//     row_count_kernel) counts each row's hits in every column strip but
//     the last; at each row thread 0 adds those of the strips left of its
//     own (the LEFT instantiation).  A row strip below the first also
//     starts that column from the corner above and to the left, a sum of
//     count_kernel's per-block totals: work bounded by the row strips
//     times the column blocks, not by the rows.  The carry row enters
//     each column strip undifferenced at its first column, so the virtual
//     column holds counts only.
//
// Every value is an integer below 2^24, so fp32 adds are exact in any
// order and the result equals the plain one-hot + cumsum version bit for
// bit, however the rows and columns are cut into strips.  No tensor cores
// are used.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wf_tis_scan {

constexpr unsigned kFullMask = 0xffffffffu;
// Columns of one count_kernel CTA; a column strip is whole blocks of it,
// so the corner left of a strip is a sum of block totals.
constexpr int kColBlock = 512;

// Shared memory bytes for one CTA: V for BB bins x (threads * 4Q) columns,
// plus two buffers of per-warp totals.
inline size_t smem_bytes(int bb, int threads, int q) {
  return sizeof(float) * ((size_t)bb * threads * 4 * q + 2 * (size_t)bb * 32);
}

// Bin ids of one row for the 4*Q columns from c_first (-1 from column w
// on: the frame's end or a column strip's), with 16-byte loads when vec.
template <int Q>
__device__ __forceinline__ void load_ids(const int* __restrict__ row,
                                         int c_first, int w, bool vec,
                                         int4 (&dst)[Q]) {
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int c = c_first + 4 * q;
    if (vec && c < w) {
      dst[q] = __ldg(reinterpret_cast<const int4*>(row + c));
    } else {
      dst[q].x = c < w ? __ldg(row + c) : -1;
      dst[q].y = c + 1 < w ? __ldg(row + c + 1) : -1;
      dst[q].z = c + 2 < w ? __ldg(row + c + 2) : -1;
      dst[q].w = c + 3 < w ? __ldg(row + c + 3) : -1;
    }
  }
}

// The row scan across the CTA: excl[j] = sum of tot[j] over all lower
// threads, for each of BB bins.  A warp shuffle scan, then the per-warp
// totals through `wt` (BB * 32 floats of shared memory), one
// __syncthreads.  Callers alternate two `wt` buffers between calls, so
// one barrier per call is enough.
template <int BB>
__device__ __forceinline__ void cta_exclusive_scan(const float (&tot)[BB],
                                                   float (&excl)[BB],
                                                   float* wt, int lane,
                                                   int warp) {
  float incl[BB];
#pragma unroll
  for (int j = 0; j < BB; ++j) {
    float x = tot[j];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(kFullMask, x, o);
      if (lane >= o) x += y;
    }
    incl[j] = x;
    if (lane == 31) wt[j * 32 + warp] = x;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < BB; ++j) {
    float run = incl[j] - tot[j];
    for (int k = 0; k < warp; ++k) run += wt[j * 32 + k];
    excl[j] = run;
  }
}

// The sum of x[j] over the CTA, for each of BB bins, into every thread's
// x[j]: a warp shuffle sum, then the per-warp sums through `wt` (BB * 32
// floats of shared memory), one __syncthreads.
template <int BB>
__device__ __forceinline__ void cta_sum(float (&x)[BB], float* wt, int lane,
                                        int warp, int warps) {
#pragma unroll
  for (int j = 0; j < BB; ++j) {
    float v = x[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
    if (lane == 0) wt[j * 32 + warp] = v;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < BB; ++j) {
    float v = 0.f;
    for (int k = 0; k < warps; ++k) v += wt[j * 32 + k];
    x[j] = v;
  }
}

// The column counts of strips [0, strips) at 4 columns from c, zero from
// column end on: a float4 per strip, four loads in flight (counts rows
// are w floats apart).
__device__ __forceinline__ float4 sum_strips(const float* __restrict__ cnt,
                                             int strips, int c, int w,
                                             int end, bool vec) {
  auto ld = [&](int s) {
    const float* p = cnt + (size_t)s * w + c;
    if (vec) return *reinterpret_cast<const float4*>(p);
    return make_float4(p[0], c + 1 < end ? p[1] : 0.f,
                       c + 2 < end ? p[2] : 0.f, c + 3 < end ? p[3] : 0.f);
  };
  float4 a[4] = {};
  int s = 0;
  for (; s + 4 <= strips; s += 4)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 v = ld(s + k);
      a[k].x += v.x, a[k].y += v.y, a[k].z += v.z, a[k].w += v.w;
    }
  for (; s < strips; ++s) {
    const float4 v = ld(s);
    a[0].x += v.x, a[0].y += v.y, a[0].z += v.z, a[0].w += v.w;
  }
  return make_float4((a[0].x + a[1].x) + (a[2].x + a[3].x),
                     (a[0].y + a[1].y) + (a[2].y + a[3].y),
                     (a[0].z + a[1].z) + (a[2].z + a[3].z),
                     (a[0].w + a[1].w) + (a[2].w + a[3].w));
}

// The CTA walks row strip blockIdx.z (strip_rows rows) of column strip
// blockIdx.x / n (strip_cols columns) of frame blockIdx.x % n, seeded from
// counts (row strip 0 from the carry alone); with one strip each way
// (gridDim.x == n, gridDim.z == 1) that is the whole frame.  LEFT: the
// launch has more than one column strip, and strips right of the first
// carry the virtual column from corners (count_kernel's block totals,
// (n, nb, strips - 1, ceil(w / kColBlock))) and rowcnt (row_count_kernel's
// counts, (n, nb, h, col strips - 1)).
template <int BB, int Q, bool LEFT>
__global__ void __launch_bounds__(1024)
scan_kernel(const int* __restrict__ idx,        // (n, h, w) bin ids
            const float* __restrict__ carry,    // (n, nb, w) or nullptr
            const float* __restrict__ counts,   // (n, nb, strips - 1, w)
            const float* __restrict__ corners,  // LEFT, strips > 1
            const float* __restrict__ rowcnt,   // LEFT
            float* __restrict__ out,            // (n, nb, h, w)
            int n, int h, int w, int nb, int strip_rows, int strip_cols) {
  extern __shared__ float4 smem4[];
  const int threads = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int f = blockIdx.x % n;              // frames on x: no 65535 cap
  const int cs = blockIdx.x / n;             // column strip
  const int b0 = blockIdx.y * BB;
  const int strip = blockIdx.z;
  const int r_begin = strip * strip_rows;
  const int r_end = min(h, r_begin + strip_rows);
  const int c_lo = cs * strip_cols;          // the strip's columns
  const int c_hi = min(w, c_lo + strip_cols);
  const int c_first = c_lo + tid * 4 * Q;    // first column of this thread

  // V[j][q] for this thread lives at smem4[(j * Q + q) * threads + tid]:
  // only the owner touches it, and neighbouring threads hit neighbouring
  // 16-byte words, so the accesses are free of bank conflicts.
  float4* V = smem4;
  float* warp_tot = reinterpret_cast<float*>(smem4 + (size_t)BB * Q * threads);

  // 16-byte row accesses when every row starts on a 16-byte boundary (a
  // column strip starts on a multiple of kColBlock).
  const bool vec_in =
      (w & 3) == 0 && (reinterpret_cast<uintptr_t>(idx) & 15) == 0;
  const bool vec_out =
      (w & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;

  // Seed V with the column differences of the carry row, plus the column
  // counts of the strips above this one.  V lies in shared memory, so this
  // loop over (bin, chunk) stays rolled: unrolled, it would inline the strip
  // sums BB * Q times, and the largest kernels take seconds to compile.
  const bool vec_cnt =
      (w & 3) == 0 && (reinterpret_cast<uintptr_t>(counts) & 15) == 0;
#pragma unroll 1
  for (int jq = 0; jq < BB * Q; ++jq) {
    const int b = b0 + jq / Q;
    const int c0 = c_first + 4 * (jq % Q);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (b < nb && c0 < c_hi) {
      if (carry != nullptr) {
        const float* crow = carry + ((size_t)f * nb + b) * w;
        const float left = c0 > c_lo ? crow[c0 - 1] : 0.f;
        const float c1 = crow[c0];
        const float c2 = c0 + 1 < c_hi ? crow[c0 + 1] : 0.f;
        const float c3 = c0 + 2 < c_hi ? crow[c0 + 2] : 0.f;
        const float c4 = c0 + 3 < c_hi ? crow[c0 + 3] : 0.f;
        v = make_float4(c1 - left, c0 + 1 < c_hi ? c2 - c1 : 0.f,
                        c0 + 2 < c_hi ? c3 - c2 : 0.f,
                        c0 + 3 < c_hi ? c4 - c3 : 0.f);
      }
      if (strip > 0) {
        const float4 a = sum_strips(
            counts + ((size_t)f * nb + b) * (gridDim.z - 1) * w, strip, c0, w,
            c_hi, vec_cnt);
        v.x += a.x, v.y += a.y, v.z += a.z, v.w += a.w;
      }
    }
    V[jq * threads + tid] = v;
  }

  // The virtual column's corner: each bin's hits in the rows above this
  // row strip and the columns left of this column strip, summed from the
  // block totals by the whole CTA (the second warp-total buffer: the
  // first row's scan writes the first, and no thread writes the second
  // before every thread has passed that scan's barrier).
  if (LEFT && cs > 0 && strip > 0) {
    const int ncb = (w + kColBlock - 1) / kColBlock;
    const int left_blocks = c_lo / kColBlock;
    const int items = strip * left_blocks;
    float part[BB];
#pragma unroll
    for (int j = 0; j < BB; ++j) {
      part[j] = 0.f;
      if (b0 + j >= nb) continue;
      const float* tot = corners + ((size_t)f * nb + b0 + j) * (gridDim.z - 1)
                                       * ncb;
      for (int i = tid; i < items; i += threads) {
        const int s = i / left_blocks;
        part[j] += __ldg(tot + (size_t)s * ncb + (i - s * left_blocks));
      }
    }
    cta_sum<BB>(part, warp_tot + BB * 32, lane, warp, threads >> 5);
    if (tid == 0) {
#pragma unroll
      for (int j = 0; j < BB; ++j) V[j * Q * threads].x += part[j];
    }
  }

  const int* frame = idx + (size_t)f * h * w;

  // Bin ids of one row for this thread's columns (-1 outside the strip).
  auto load_row = [&](int r, int4 (&dst)[Q]) {
    load_ids<Q>(frame + (size_t)r * w, c_first, c_hi, vec_in, dst);
  };

  // LEFT: thread 0's next row of the virtual column, the hits of each bin
  // in the column strips left of this one (zero for every other thread).
  const bool lead = LEFT && tid == 0 && cs > 0;
  const int left_stride = LEFT ? gridDim.x / n - 1 : 0;
  float lft[BB] = {};
  auto load_left = [&](int r) {
#pragma unroll
    for (int j = 0; j < BB; ++j) {
      lft[j] = 0.f;
      if (!lead || b0 + j >= nb) continue;
      const float* p =
          rowcnt + (((size_t)f * nb + b0 + j) * h + r) * left_stride;
      for (int k = 0; k < cs; ++k) lft[j] += __ldg(p + k);
    }
  };

  // The next row's bin ids are loaded one row ahead, so their latency
  // overlaps this row's work instead of stalling the walk; so are thread
  // 0's left counts.
  int4 cur[Q];
  int4 nxt[Q];
  if (r_begin < r_end) {
    load_row(r_begin, cur);
    if (LEFT) load_left(r_begin);
  }

  for (int r = r_begin; r < r_end; ++r) {
    if (r + 1 < r_end) load_row(r + 1, nxt);

    // Vertical step: V += one-hot of this row; thread totals of V.
    float tot[BB];
#pragma unroll
    for (int j = 0; j < BB; ++j) {
      const int b = b0 + j;
      float t = 0.f;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        float4 v = V[(j * Q + q) * threads + tid];
        v.x += cur[q].x == b ? 1.f : 0.f;
        v.y += cur[q].y == b ? 1.f : 0.f;
        v.z += cur[q].z == b ? 1.f : 0.f;
        v.w += cur[q].w == b ? 1.f : 0.f;
        if constexpr (LEFT) {
          if (q == 0) v.x += lft[j];
        }
        V[(j * Q + q) * threads + tid] = v;
        t += (v.x + v.y) + (v.z + v.w);
      }
      tot[j] = t;
    }
    if (LEFT && r + 1 < r_end) load_left(r + 1);

    // Horizontal step: exclusive prefix of the thread totals across the
    // CTA (warp shuffle scan, then the per-warp totals).
    float excl[BB];
    cta_exclusive_scan<BB>(tot, excl, warp_tot + ((r - r_begin) & 1) * BB * 32,
                           lane, warp);

#pragma unroll
    for (int j = 0; j < BB; ++j) {
      const int b = b0 + j;
      float run = excl[j];
      if (b >= nb) continue;
      float* orow = out + (((size_t)f * nb + b) * h + r) * w;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int c = c_first + 4 * q;
        const float4 v = V[(j * Q + q) * threads + tid];
        float4 o;
        o.x = run + v.x;
        o.y = o.x + v.y;
        o.z = o.y + v.z;
        o.w = o.z + v.w;
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

#pragma unroll
    for (int q = 0; q < Q; ++q) cur[q] = nxt[q];
  }
}

// Launch one instantiation: threads is a multiple of 32, at most 1024; a
// CTA per (frame and column strip, bin block, strip of strip_rows rows).
template <int BB, int Q, bool LEFT>
cudaError_t launch_bbq(const int* idx, const float* carry, const float* counts,
                       const float* corners, const float* rowcnt, float* out,
                       int n, int h, int w, int nb, int threads,
                       int strip_rows, int strip_cols, cudaStream_t stream) {
  const size_t smem = smem_bytes(BB, threads, Q);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        scan_kernel<BB, Q, LEFT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long x = (long long)n * ((w + strip_cols - 1) / strip_cols);
  const int y = (nb + BB - 1) / BB;
  const int z = (h + strip_rows - 1) / strip_rows;
  if (x > 0x7fffffffLL || y > 65535 || z > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)x, y, z);
  scan_kernel<BB, Q, LEFT><<<grid, threads, smem, stream>>>(
      idx, carry, counts, corners, rowcnt, out, n, h, w, nb, strip_rows,
      strip_cols);
  return cudaGetLastError();
}

}  // namespace wf_tis_scan
