// K3: the carry-delta broadcast of the incremental video path, for Hopper
// (sm_90a).  Replaces repro/kernels/delta_apply.py::_delta_apply_kernel.
//
//   out[p, r, c] = H[p, r, c] + delta[p, c]      p = (frame, bin) plane
//
// What bounds it: bytes.  It reads the slab once and writes it once, plus
// one delta row per plane; one add per element.  The design streams the
// slab with 16-byte accesses and reads each delta chunk once per thread:
//
//   * Thread work item = (plane p, group of kRows rows, 4 contiguous
//     columns).  The four delta values load once, then the kRows rows are
//     read, added and written, their loads issued together (unrolled).
//   * Neighbouring threads take neighbouring 4-column chunks of the same
//     row, so a warp moves 512 contiguous bytes per row.
//   * A grid-stride loop covers any number of planes and rows.
//   * Input and output have their own plane strides (rows inside a plane
//     are w apart), so a row band of a larger H is read in place and the
//     result may be written straight into a row band of another H.
//
// Out of place, as the reference: the cached predecessor H may still be
// read.  fp32 adds of integer values below 2^24 are exact, so the result
// equals the plain broadcast add bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;       // rows per thread work item
constexpr int kThreads = 256;

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
delta_apply_kernel(const float* __restrict__ H, long long h_plane,
                   const float* __restrict__ delta,
                   float* __restrict__ out, long long o_plane,
                   long long planes, int rows, int w) {
  const long long ncol = (w + 3) / 4;
  const long long ngrp = (rows + kRows - 1) / kRows;
  const long long total = planes * ngrp * ncol;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(t % ncol) * 4;
    const long long rest = t / ncol;
    const int r0 = (int)(rest % ngrp) * kRows;
    const long long p = rest / ngrp;
    const float* src = H + p * h_plane + c;
    float* dst = out + p * o_plane + c;
    const float* drow = delta + p * w + c;
    if (VEC) {
      const float4 d = __ldg(reinterpret_cast<const float4*>(drow));
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int r = r0 + k;
        if (r < rows) {
          float4 v = __ldg(reinterpret_cast<const float4*>(src + (long long)r * w));
          v.x += d.x;
          v.y += d.y;
          v.z += d.z;
          v.w += d.w;
          *reinterpret_cast<float4*>(dst + (long long)r * w) = v;
        }
      }
    } else {
      float d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) d[e] = c + e < w ? __ldg(drow + e) : 0.f;
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int r = r0 + k;
        if (r < rows) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (c + e < w) {
              dst[(long long)r * w + e] = __ldg(src + (long long)r * w + e) + d[e];
            }
          }
        }
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Plain C interface for ctypes; returns the cudaError_t of the launch.
extern "C" int delta_apply_launch(const float* H, long long h_plane,
                                  const float* delta, float* out,
                                  long long o_plane, long long planes,
                                  int rows, int w, int max_blocks,
                                  void* stream) {
  if (planes <= 0 || rows <= 0 || w <= 0) return (int)cudaSuccess;
  if (h_plane < (long long)rows * w || o_plane < (long long)rows * w ||
      max_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  const long long ncol = (w + 3) / 4;
  const long long ngrp = (rows + kRows - 1) / kRows;
  const long long items = planes * ngrp * ncol;
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  const bool vec = (w & 3) == 0 && (h_plane & 3) == 0 && (o_plane & 3) == 0 &&
                   aligned16(H) && aligned16(delta) && aligned16(out);
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    delta_apply_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
        H, h_plane, delta, out, o_plane, planes, rows, w);
  } else {
    delta_apply_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        H, h_plane, delta, out, o_plane, planes, rows, w);
  }
  return (int)cudaGetLastError();
}
