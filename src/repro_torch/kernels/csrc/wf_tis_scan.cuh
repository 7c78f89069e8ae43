// WF-TiS integral-histogram scan for Hopper (sm_90a), shared by the dense
// kernel (wf_tis.cu, K1) and the query-fused kernel (fused_rows.cu, K2).
// Its row loader and CTA-wide row scan (load_ids, cta_exclusive_scan) are
// also the horizontal pass of CW-TiS (cw_tis.cu, K4).
//
// Replaces repro/kernels/wf_tis.py::_wf_tis_kernel and
// repro/kernels/fused_rows.py::_fused_rows_kernel.  What it computes:
//
//   H[f, b, r, c] = carry[f, b, c] + #{(r', c') : r' <= r, c' <= c,
//                                      idx[f, r', c'] == b}
//
// What bounds it: the b-fold fp32 write of H.  Per pixel it reads one
// int32 bin id and writes num_bins floats, so at the paper's 32 bins the
// write is 32x the read and the arithmetic is a few adds per float.  The
// design keeps everything but that write on chip:
//
//   * One CTA per (frame, block of BB bins) walks the frame top to bottom.
//     Carries move along that loop, never between CTAs: no grid order, no
//     atomics (the TPU kernel's VMEM carries rely on a sequential grid).
//   * Thread t owns 4*Q contiguous columns.  For each of its columns and
//     bins it keeps the running column count V (the vertical prefix) in
//     shared memory; the one-hot is formed from the bin id in registers and
//     never reaches device memory.
//   * Row r of H is the prefix over columns of V[r, :]: a thread-local
//     prefix over its 4*Q columns, a warp scan of thread totals with
//     shuffles, and a pass over the per-warp totals in shared memory.  One
//     __syncthreads per emitted row (double-buffered warp totals).
//   * The band carry-in enters as the column differences of the carry row,
//     seeded into V, so the same prefix reproduces carry[c] + local H.
//   * FUSED: only rows with row_slot[r] >= 0 are scanned across columns and
//     written, to output row row_slot[r]; other rows only update V.  The
//     caller stops the walk after the last requested row.
//
// Every value is an integer below 2^24, so fp32 adds are exact in any
// order and the result equals the plain one-hot + cumsum version bit for
// bit.  No tensor cores are used.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wf_tis_scan {

constexpr unsigned kFullMask = 0xffffffffu;

// Shared memory bytes for one CTA: V for BB bins x (threads * 4Q) columns,
// plus two buffers of per-warp totals.
inline size_t smem_bytes(int bb, int threads, int q) {
  return sizeof(float) * ((size_t)bb * threads * 4 * q + 2 * (size_t)bb * 32);
}

// Bin ids of one row for the 4*Q columns from c_first (-1 outside the
// frame), with 16-byte loads when vec.
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

template <int BB, int Q, bool FUSED>
__global__ void __launch_bounds__(1024)
scan_kernel(const int* __restrict__ idx,       // (n, h, w) bin ids
            const float* __restrict__ carry,   // (n, nb, w) or nullptr
            const int* __restrict__ row_slot,  // (h_run,) FUSED only
            float* __restrict__ out,           // (n, nb, h_out, w)
            int h, int h_run, int w, int nb, int h_out) {
  extern __shared__ float4 smem4[];
  const int threads = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int f = blockIdx.x;                  // frames on x: no 65535 cap
  const int b0 = blockIdx.y * BB;
  const int c_first = tid * 4 * Q;           // first column of this thread

  // V[j][q] for this thread lives at smem4[(j * Q + q) * threads + tid]:
  // only the owner touches it, and neighbouring threads hit neighbouring
  // 16-byte words, so the accesses are free of bank conflicts.
  float4* counts = smem4;
  float* warp_tot = reinterpret_cast<float*>(smem4 + (size_t)BB * Q * threads);

  // 16-byte row accesses when every row starts on a 16-byte boundary.
  const bool vec_in =
      (w & 3) == 0 && (reinterpret_cast<uintptr_t>(idx) & 15) == 0;
  const bool vec_out =
      (w & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;

  // Seed V with the column differences of the carry row.
#pragma unroll
  for (int j = 0; j < BB; ++j) {
    const int b = b0 + j;
    const float* crow =
        (carry != nullptr && b < nb) ? carry + ((size_t)f * nb + b) * w : nullptr;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c_first + 4 * q + e;
        float d = 0.f;
        if (crow != nullptr && c < w) d = crow[c] - (c > 0 ? crow[c - 1] : 0.f);
        v[e] = d;
      }
      counts[(j * Q + q) * threads + tid] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }

  const int* frame = idx + (size_t)f * h * w;

  // Bin ids of one row for this thread's columns (-1 outside the frame).
  auto load_row = [&](int r, int4 (&dst)[Q]) {
    load_ids<Q>(frame + (size_t)r * w, c_first, w, vec_in, dst);
  };

  // The next row's bin ids and output slot are loaded one row ahead, so
  // their latency overlaps this row's work instead of stalling the walk.
  int4 cur[Q];
  int4 nxt[Q];
  int slot_cur = 0;
  int slot_nxt = 0;
  if (h_run > 0) {
    load_row(0, cur);
    if (FUSED) slot_cur = __ldg(row_slot);
  }
  int emitted = 0;

  for (int r = 0; r < h_run; ++r) {
    if (r + 1 < h_run) {
      load_row(r + 1, nxt);
      if (FUSED) slot_nxt = __ldg(row_slot + r + 1);
    }
    const int slot = FUSED ? slot_cur : r;
    const bool emit = !FUSED || slot >= 0;     // uniform across the CTA

    // Vertical step: V += one-hot of this row; thread totals of V.
    float tot[BB];
#pragma unroll
    for (int j = 0; j < BB; ++j) {
      const int b = b0 + j;
      float t = 0.f;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        float4 v = counts[(j * Q + q) * threads + tid];
        v.x += cur[q].x == b ? 1.f : 0.f;
        v.y += cur[q].y == b ? 1.f : 0.f;
        v.z += cur[q].z == b ? 1.f : 0.f;
        v.w += cur[q].w == b ? 1.f : 0.f;
        counts[(j * Q + q) * threads + tid] = v;
        t += (v.x + v.y) + (v.z + v.w);
      }
      tot[j] = t;
    }

    if (emit) {
      // Horizontal step: exclusive prefix of the thread totals across the
      // CTA (warp shuffle scan, then the per-warp totals).
      float excl[BB];
      cta_exclusive_scan<BB>(tot, excl, warp_tot + (emitted & 1) * BB * 32,
                             lane, warp);

#pragma unroll
      for (int j = 0; j < BB; ++j) {
        const int b = b0 + j;
        float run = excl[j];
        if (b >= nb) continue;
        float* orow = out + (((size_t)f * nb + b) * h_out + slot) * w;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int c = c_first + 4 * q;
          const float4 v = counts[(j * Q + q) * threads + tid];
          float4 o;
          o.x = run + v.x;
          o.y = o.x + v.y;
          o.z = o.y + v.z;
          o.w = o.z + v.w;
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
      ++emitted;
    }

#pragma unroll
    for (int q = 0; q < Q; ++q) cur[q] = nxt[q];
    slot_cur = slot_nxt;
  }
}

// Launch one instantiation: threads is a multiple of 32, at most 1024.
template <int BB, int Q, bool FUSED>
cudaError_t launch_bbq(const int* idx, const float* carry, const int* row_slot,
                       float* out, int n, int h, int h_run, int w, int nb,
                       int h_out, int threads, cudaStream_t stream) {
  const size_t smem = smem_bytes(BB, threads, Q);
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<BB, Q, FUSED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n, (nb + BB - 1) / BB);
  scan_kernel<BB, Q, FUSED><<<grid, threads, smem, stream>>>(
      idx, carry, row_slot, out, h, h_run, w, nb, h_out);
  return cudaGetLastError();
}

template <int BB, bool FUSED>
cudaError_t launch_bb(const int* idx, const float* carry, const int* row_slot,
                      float* out, int n, int h, int h_run, int w, int nb,
                      int h_out, int threads, int q, cudaStream_t stream) {
  switch (q) {
    case 1: return launch_bbq<BB, 1, FUSED>(idx, carry, row_slot, out, n, h, h_run, w, nb, h_out, threads, stream);
    case 2: return launch_bbq<BB, 2, FUSED>(idx, carry, row_slot, out, n, h, h_run, w, nb, h_out, threads, stream);
    case 4: return launch_bbq<BB, 4, FUSED>(idx, carry, row_slot, out, n, h, h_run, w, nb, h_out, threads, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Dispatch on the bin block and the columns per thread (4*q).
template <bool FUSED>
cudaError_t launch(const int* idx, const float* carry, const int* row_slot,
                   float* out, int n, int h, int h_run, int w, int nb,
                   int h_out, int bin_block, int threads, int q,
                   cudaStream_t stream) {
  if (threads <= 0 || threads > 1024 || (threads & 31) != 0)
    return cudaErrorInvalidValue;
  if ((size_t)threads * 4 * q < (size_t)w) return cudaErrorInvalidValue;
  switch (bin_block) {
    case 1: return launch_bb<1, FUSED>(idx, carry, row_slot, out, n, h, h_run, w, nb, h_out, threads, q, stream);
    case 2: return launch_bb<2, FUSED>(idx, carry, row_slot, out, n, h, h_run, w, nb, h_out, threads, q, stream);
    case 4: return launch_bb<4, FUSED>(idx, carry, row_slot, out, n, h, h_run, w, nb, h_out, threads, q, stream);
    case 8: return launch_bb<8, FUSED>(idx, carry, row_slot, out, n, h, h_run, w, nb, h_out, threads, q, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wf_tis_scan
