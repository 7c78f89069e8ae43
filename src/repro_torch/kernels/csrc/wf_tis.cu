// K1: the dense WF-TiS integral histogram (see wf_tis_scan.cuh).  With
// strip_rows < h it makes two launches, the column-count pre-pass below
// and the strip scan; counts is then (n, num_bins, ceil(h / strip_rows) - 1,
// w) floats of scratch.  Plain C interface for ctypes; returns the first
// failing cudaError_t, else cudaSuccess.

#include "wf_tis_scan.cuh"

namespace {

using wf_tis_scan::load_ids;

// Column counts of each strip but the last: counts[f, b, s, c] = hits of
// bin b in column c over rows [s * R, (s + 1) * R) of frame f, for s <
// gridDim.z.  One thread per 4 columns and kCountBins bins, no barriers.
constexpr int kCountBins = 8;
constexpr int kCountThreads = 128;
constexpr int kCountBatch = 8;    // rows whose loads a thread issues together

__global__ void __launch_bounds__(kCountThreads)
count_kernel(const int* __restrict__ idx,      // (n, h, w) bin ids
             float* __restrict__ counts,       // (n, nb, strips - 1, w)
             int h, int w, int nb, int strip_rows) {
  const int groups = (nb + kCountBins - 1) / kCountBins;
  const int f = blockIdx.x / groups;
  const int b0 = (blockIdx.x - f * groups) * kCountBins;
  const int c = 4 * (blockIdx.y * kCountThreads + threadIdx.x);
  const int s = blockIdx.z;
  const int above = gridDim.z;
  if (c >= w) return;
  const bool vec = (w & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(idx) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(counts) & 15) == 0;
  const int* frame = idx + (size_t)f * h * w;
  float cnt[kCountBins][4] = {};
  const int r_end = (s + 1) * strip_rows;     // every counted strip is whole
  for (int r0 = s * strip_rows; r0 < r_end; r0 += kCountBatch) {
    // A batch of rows' loads in flight before any is counted.
    int4 id[kCountBatch];
#pragma unroll
    for (int k = 0; k < kCountBatch; ++k) {
      int4 one[1] = {make_int4(-1, -1, -1, -1)};
      if (r0 + k < r_end)
        load_ids<1>(frame + (size_t)(r0 + k) * w, c, w, vec, one);
      id[k] = one[0];
    }
#pragma unroll
    for (int k = 0; k < kCountBatch; ++k)
#pragma unroll
      for (int j = 0; j < kCountBins; ++j) {
        const int b = b0 + j;
        cnt[j][0] += id[k].x == b ? 1.f : 0.f;
        cnt[j][1] += id[k].y == b ? 1.f : 0.f;
        cnt[j][2] += id[k].z == b ? 1.f : 0.f;
        cnt[j][3] += id[k].w == b ? 1.f : 0.f;
      }
  }
#pragma unroll
  for (int j = 0; j < kCountBins; ++j) {
    const int b = b0 + j;
    if (b >= nb) break;
    float* dst = counts + (((size_t)f * nb + b) * above + s) * w + c;
    if (vec) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(cnt[j][0], cnt[j][1], cnt[j][2], cnt[j][3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < w) dst[e] = cnt[j][e];
    }
  }
}

// The pre-pass: column counts of every strip of strip_rows rows but the
// last (strips - 1 of them), into counts (n, nb, strips - 1, w).
cudaError_t launch_counts(const int* idx, float* counts, int n, int h, int w,
                          int nb, int strip_rows, cudaStream_t stream) {
  const int strips = (h + strip_rows - 1) / strip_rows;
  if (strips <= 1) return cudaSuccess;
  const dim3 grid(n * ((nb + kCountBins - 1) / kCountBins),
                  (w + 4 * kCountThreads - 1) / (4 * kCountThreads),
                  strips - 1);
  count_kernel<<<grid, kCountThreads, 0, stream>>>(idx, counts, h, w, nb,
                                                   strip_rows);
  return cudaGetLastError();
}

// The scan: dispatch on the bin block and the columns per thread (4*q).
// It walks rows [0, h) in strips of strip_rows; with more than one strip,
// counts must hold count_kernel's output for the same strip_rows.  Kept
// here, not in the header, so that the other sources that include
// wf_tis_scan.cuh do not instantiate its twelve scan kernels.
cudaError_t launch_scan(const int* idx, const float* carry,
                        const float* counts, float* out, int n, int h, int w,
                        int nb, int bin_block, int threads, int q,
                        int strip_rows, cudaStream_t stream) {
  if (threads <= 0 || threads > 1024 || (threads & 31) != 0)
    return cudaErrorInvalidValue;
  if ((size_t)threads * 4 * q < (size_t)w) return cudaErrorInvalidValue;
  if (strip_rows <= 0) return cudaErrorInvalidValue;
  if (strip_rows < h && counts == nullptr) return cudaErrorInvalidValue;
  switch (bin_block) {
    case 1: return wf_tis_scan::launch_bb<1>(idx, carry, counts, out, n, h, w, nb, threads, q, strip_rows, stream);
    case 2: return wf_tis_scan::launch_bb<2>(idx, carry, counts, out, n, h, w, nb, threads, q, strip_rows, stream);
    case 4: return wf_tis_scan::launch_bb<4>(idx, carry, counts, out, n, h, w, nb, threads, q, strip_rows, stream);
    case 8: return wf_tis_scan::launch_bb<8>(idx, carry, counts, out, n, h, w, nb, threads, q, strip_rows, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int wf_tis_launch(const int* idx, const float* carry, float* counts,
                             float* out, int n, int h, int w, int num_bins,
                             int bin_block, int threads, int q, int strip_rows,
                             void* stream) {
  if (strip_rows <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (strip_rows < h) {
    if (counts == nullptr) return (int)cudaErrorInvalidValue;
    const cudaError_t err =
        launch_counts(idx, counts, n, h, w, num_bins, strip_rows, st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch_scan(idx, carry, counts, out, n, h, w, num_bins,
                          bin_block, threads, q, strip_rows, st);
}
