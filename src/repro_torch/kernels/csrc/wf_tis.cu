// K1: the dense WF-TiS integral histogram (see wf_tis_scan.cuh).  One
// launch, the scan, where one CTA spans a whole column of the frame; up to
// two pre-passes before it where the rows or the columns are cut into
// strips: with strip_cols < w, row_count_kernel (each row's counts of every
// column strip but the last, into rowcnt (n, num_bins, h, col strips - 1)
// floats of scratch); with strip_rows < h, count_kernel (each column's
// counts of every row strip but the last, into counts (n, num_bins,
// ceil(h / strip_rows) - 1, w), and with column strips too each 512-column
// block's totals into corners (n, num_bins, row strips - 1, ceil(w / 512))).
// Plain C interface for ctypes; returns the first failing cudaError_t,
// else cudaSuccess.

#include "wf_tis_scan.cuh"

namespace {

using wf_tis_scan::kColBlock;
using wf_tis_scan::kFullMask;
using wf_tis_scan::load_ids;

// Column counts of each strip but the last: counts[f, b, s, c] = hits of
// bin b in column c over rows [s * R, (s + 1) * R) of frame f, for s <
// gridDim.z.  One thread per 4 columns and kCountBins bins, no barriers
// unless corners is given: then the CTA also sums its block's counts of
// each bin, corners[f, b, s, blockIdx.y], for the column strips to its
// right.
constexpr int kCountBins = 8;
constexpr int kCountThreads = 128;
constexpr int kCountBatch = 8;    // rows whose loads a thread issues together
static_assert(4 * kCountThreads == kColBlock, "a count CTA is a column block");

__global__ void __launch_bounds__(kCountThreads)
count_kernel(const int* __restrict__ idx,      // (n, h, w) bin ids
             float* __restrict__ counts,       // (n, nb, strips - 1, w)
             float* __restrict__ corners,      // (n, nb, strips - 1, ncb)
             int h, int w, int nb, int strip_rows) {
  const int groups = (nb + kCountBins - 1) / kCountBins;
  const int f = blockIdx.x / groups;
  const int b0 = (blockIdx.x - f * groups) * kCountBins;
  const int c = 4 * (blockIdx.y * kCountThreads + threadIdx.x);
  const int s = blockIdx.z;
  const int above = gridDim.z;
  const bool inside = c < w;
  if (!inside && corners == nullptr) return;
  const bool vec = (w & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(idx) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(counts) & 15) == 0;
  const int* frame = idx + (size_t)f * h * w;
  float cnt[kCountBins][4] = {};
  const int r_end = (s + 1) * strip_rows;     // every counted strip is whole
  for (int r0 = s * strip_rows; inside && r0 < r_end; r0 += kCountBatch) {
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
    if (b >= nb || !inside) break;
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
  if (corners == nullptr) return;
  __shared__ float part[kCountBins][kCountThreads / 32];
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < kCountBins; ++j) {
    float v = (cnt[j][0] + cnt[j][1]) + (cnt[j][2] + cnt[j][3]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
    if (lane == 0) part[j][threadIdx.x >> 5] = v;
  }
  __syncthreads();
  const int j = threadIdx.x;
  if (j < kCountBins && b0 + j < nb) {
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < kCountThreads / 32; ++k) v += part[j][k];
    corners[(((size_t)f * nb + b0 + j) * above + s) * gridDim.y + blockIdx.y] =
        v;
  }
}

// Row counts of each column strip but the last: rowcnt[f, b, r, j] = hits
// of bin b in row r over columns [j * strip_cols, (j + 1) * strip_cols) of
// frame f.  A warp a row, kCountBins bins a CTA, a lane 4 columns of every
// 128, four 16-byte loads in flight; a column strip is whole blocks of
// kColBlock columns, so no load is masked.  Grid x folds (column strip,
// frame, bin group, tile of kRowWarps rows), no barriers.
constexpr int kRowWarps = 8;

__global__ void __launch_bounds__(32 * kRowWarps)
row_count_kernel(const int* __restrict__ idx,   // (n, h, w) bin ids
                 float* __restrict__ rowcnt,    // (n, nb, h, col strips - 1)
                 int n, int h, int w, int nb, int strip_cols) {
  const int groups = (nb + kCountBins - 1) / kCountBins;
  const int tiles = (h + kRowWarps - 1) / kRowWarps;
  const int left = (w + strip_cols - 1) / strip_cols - 1;
  int x = blockIdx.x;
  const int tile = x % tiles;
  x /= tiles;
  const int grp = x % groups;
  x /= groups;
  const int f = x % n;
  const int cs = x / n;
  const int lane = threadIdx.x & 31;
  const int r = tile * kRowWarps + (threadIdx.x >> 5);
  if (r >= h) return;
  const int b0 = grp * kCountBins;
  const bool vec = (w & 3) == 0 && (reinterpret_cast<uintptr_t>(idx) & 15) == 0;
  const int* row = idx + ((size_t)f * h + r) * w;
  int cnt[kCountBins] = {};
  const int c_end = (cs + 1) * strip_cols;
  for (int c0 = cs * strip_cols; c0 < c_end; c0 += kColBlock) {
    int4 id[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int4 one[1];
      load_ids<1>(row, c0 + 4 * (lane + 32 * k), w, vec, one);
      id[k] = one[0];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int j = 0; j < kCountBins; ++j) {
        const int b = b0 + j;
        cnt[j] += (id[k].x == b) + (id[k].y == b) + (id[k].z == b) +
                  (id[k].w == b);
      }
  }
#pragma unroll
  for (int j = 0; j < kCountBins; ++j)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      cnt[j] += __shfl_xor_sync(kFullMask, cnt[j], o);
  if (lane != 0) return;
#pragma unroll
  for (int j = 0; j < kCountBins; ++j)
    if (b0 + j < nb)
      rowcnt[(((size_t)f * nb + b0 + j) * h + r) * left + cs] = (float)cnt[j];
}

// The row-strip pre-pass: column counts of every strip of strip_rows rows
// but the last (strips - 1 of them), into counts (n, nb, strips - 1, w);
// with corners, each block's totals as well.
cudaError_t launch_counts(const int* idx, float* counts, float* corners,
                          int n, int h, int w, int nb, int strip_rows,
                          cudaStream_t stream) {
  const int strips = (h + strip_rows - 1) / strip_rows;
  if (strips <= 1) return cudaSuccess;
  const long long x = (long long)n * ((nb + kCountBins - 1) / kCountBins);
  const int y = (w + kColBlock - 1) / kColBlock;
  if (x > 0x7fffffffLL || y > 65535 || strips - 1 > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)x, y, strips - 1);
  count_kernel<<<grid, kCountThreads, 0, stream>>>(idx, counts, corners, h, w,
                                                   nb, strip_rows);
  return cudaGetLastError();
}

// The column-strip pre-pass: row counts of every column strip but the
// last, into rowcnt (n, nb, h, col strips - 1).
cudaError_t launch_row_counts(const int* idx, float* rowcnt, int n, int h,
                              int w, int nb, int strip_cols,
                              cudaStream_t stream) {
  const int left = (w + strip_cols - 1) / strip_cols - 1;
  if (left <= 0) return cudaSuccess;
  const long long x = (long long)left * n *
                      ((nb + kCountBins - 1) / kCountBins) *
                      ((h + kRowWarps - 1) / kRowWarps);
  if (x > 0x7fffffffLL) return cudaErrorInvalidValue;
  row_count_kernel<<<(unsigned)x, 32 * kRowWarps, 0, stream>>>(
      idx, rowcnt, n, h, w, nb, strip_cols);
  return cudaGetLastError();
}

template <int BB>
cudaError_t launch_bb(const int* idx, const float* carry, const float* counts,
                      const float* corners, const float* rowcnt, float* out,
                      int n, int h, int w, int nb, int threads, int q,
                      int strip_rows, int strip_cols, cudaStream_t stream) {
  using wf_tis_scan::launch_bbq;
  if (strip_cols < w) {
    // Column strips are wider than 8,192 columns, so 4 columns a chunk.
    if (q != 4) return cudaErrorInvalidValue;
    return launch_bbq<BB, 4, true>(idx, carry, counts, corners, rowcnt, out,
                                   n, h, w, nb, threads, strip_rows,
                                   strip_cols, stream);
  }
  switch (q) {
    case 1: return launch_bbq<BB, 1, false>(idx, carry, counts, nullptr, nullptr, out, n, h, w, nb, threads, strip_rows, w, stream);
    case 2: return launch_bbq<BB, 2, false>(idx, carry, counts, nullptr, nullptr, out, n, h, w, nb, threads, strip_rows, w, stream);
    case 4: return launch_bbq<BB, 4, false>(idx, carry, counts, nullptr, nullptr, out, n, h, w, nb, threads, strip_rows, w, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The scan: dispatch on the bin block, the columns per thread (4*q) and
// whether the columns are cut.  It walks rows [0, h) in strips of
// strip_rows and columns [0, w) in strips of strip_cols; with more than
// one row strip, counts must hold count_kernel's output for the same
// strip_rows, and with column strips too corners; with more than one
// column strip, rowcnt row_count_kernel's.  Kept here, not in the header,
// so that the other sources that include wf_tis_scan.cuh do not
// instantiate the scan kernels.  A bin block of 8 never fits shared
// memory beside 16 columns a thread, so column strips take 1, 2 or 4.
cudaError_t launch_scan(const int* idx, const float* carry,
                        const float* counts, const float* corners,
                        const float* rowcnt, float* out, int n, int h, int w,
                        int nb, int bin_block, int threads, int q,
                        int strip_rows, int strip_cols, cudaStream_t stream) {
  if (threads <= 0 || threads > 1024 || (threads & 31) != 0)
    return cudaErrorInvalidValue;
  if ((size_t)threads * 4 * q < (size_t)strip_cols || strip_cols > w)
    return cudaErrorInvalidValue;
  if (strip_rows <= 0) return cudaErrorInvalidValue;
  const bool cols = strip_cols < w;
  if (strip_rows < h && counts == nullptr) return cudaErrorInvalidValue;
  if (cols && (rowcnt == nullptr || strip_cols % kColBlock != 0 ||
               (strip_rows < h && corners == nullptr)))
    return cudaErrorInvalidValue;
  switch (bin_block) {
    case 1: return launch_bb<1>(idx, carry, counts, corners, rowcnt, out, n, h, w, nb, threads, q, strip_rows, strip_cols, stream);
    case 2: return launch_bb<2>(idx, carry, counts, corners, rowcnt, out, n, h, w, nb, threads, q, strip_rows, strip_cols, stream);
    case 4: return launch_bb<4>(idx, carry, counts, corners, rowcnt, out, n, h, w, nb, threads, q, strip_rows, strip_cols, stream);
    case 8:
      if (cols) return cudaErrorInvalidValue;
      return launch_bb<8>(idx, carry, counts, corners, rowcnt, out, n, h, w, nb, threads, q, strip_rows, strip_cols, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int wf_tis_launch(const int* idx, const float* carry, float* counts,
                             float* corners, float* rowcnt, float* out, int n,
                             int h, int w, int num_bins, int bin_block,
                             int threads, int q, int strip_rows,
                             int strip_cols, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || num_bins <= 0) return (int)cudaSuccess;
  if (strip_rows <= 0 || strip_cols <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool cols = strip_cols < w;
  if (cols) {
    if (rowcnt == nullptr || strip_cols % kColBlock != 0)
      return (int)cudaErrorInvalidValue;
    const cudaError_t err = launch_row_counts(idx, rowcnt, n, h, w, num_bins,
                                              strip_cols, st);
    if (err != cudaSuccess) return (int)err;
  }
  if (strip_rows < h) {
    if (counts == nullptr || (cols && corners == nullptr))
      return (int)cudaErrorInvalidValue;
    const cudaError_t err = launch_counts(idx, counts, cols ? corners : nullptr,
                                          n, h, w, num_bins, strip_rows, st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch_scan(idx, carry, counts, corners, rowcnt, out, n, h, w,
                          num_bins, bin_block, threads, q, strip_rows,
                          strip_cols, st);
}
