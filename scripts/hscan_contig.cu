// K4's hscan with thread-contiguous columns: a variant that
// scripts/hscan_variants.py builds and times beside the port's hscan
// (csrc/cw_tis.cu) to separate the cost of the column layout from that of
// the CTA-wide barrier the hscan had before.
//
// The walk is the port's (one warp per frame, row and block of BB bins,
// no shared memory, no barrier, each bin's row total in a register), but
// a chunk is 512 columns and lane l holds the 16 contiguous columns
// 512 k + 16 l .. + 15, as the earlier hscan and K1 hold them at 16
// columns a thread: each warp-wide int4 load and float4 store then
// touches 32 pieces of 16 bytes, 64 bytes apart, where the port's touch
// 512 contiguous bytes.  A chunk holds up to 512 hits of a bin, so the
// fields are 16 bits wide, 2 bins a word.  Rows must be 16-byte aligned
// and a multiple of 4 columns: the script times it only on such frames.

#include <cstdint>

namespace {

constexpr int kCols = 16;                   // columns a lane
constexpr int kChunk = 32 * kCols;          // columns a warp takes at a time
constexpr int kMaxWarps = 16;
constexpr unsigned kFull = 0xffffffffu;

template <int BB>
__global__ void __launch_bounds__(kMaxWarps * 32)
hscan_contig_kernel(const int* __restrict__ idx, float* __restrict__ hh,
                    int n, int h, int w, int nb) {
  constexpr int kWords = (BB + 1) / 2;
  const int lane = threadIdx.x & 31;
  const int blocks = (nb + BB - 1) / BB;
  long long u = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (u >= (long long)n * h * blocks) return;
  const int b0 = (int)(u % blocks) * BB;
  u /= blocks;
  const long long fr = u;
  const long long plane = (long long)h * w;
  const int* row = idx + fr * w;
  float* out = hh + ((fr / h) * nb + b0) * plane + (fr % h) * w;

  float run[BB];
#pragma unroll
  for (int j = 0; j < BB; ++j) run[j] = 0.f;
  for (int c_lo = 0; c_lo < w; c_lo += kChunk) {
    const int c = c_lo + kCols * lane;
    int d[kCols];
#pragma unroll
    for (int q = 0; q < kCols / 4; ++q) {
      int4 v = make_int4(-1, -1, -1, -1);
      if (c + 4 * q < w) v = __ldg(reinterpret_cast<const int4*>(row + c + 4 * q));
      d[4 * q] = v.x - b0;
      d[4 * q + 1] = v.y - b0;
      d[4 * q + 2] = v.z - b0;
      d[4 * q + 3] = v.w - b0;
    }
    unsigned cnt[kWords], incl[kWords];
#pragma unroll
    for (int k = 0; k < kWords; ++k) cnt[k] = 0u;
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      const unsigned one =
          (unsigned)d[e] < (unsigned)BB ? 1u << (16 * (d[e] & 1)) : 0u;
#pragma unroll
      for (int k = 0; k < kWords; ++k) cnt[k] += (d[e] >> 1) == k ? one : 0u;
    }
#pragma unroll
    for (int k = 0; k < kWords; ++k) incl[k] = cnt[k];
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
#pragma unroll
      for (int k = 0; k < kWords; ++k) {
        const unsigned t = __shfl_up_sync(kFull, incl[k], s);
        if (lane >= s) incl[k] += t;
      }
    }
    unsigned total[kWords];
#pragma unroll
    for (int k = 0; k < kWords; ++k)
      total[k] = __shfl_sync(kFull, incl[k], 31);
#pragma unroll
    for (int j = 0; j < BB; ++j) {
      const int k = j >> 1, sh = 16 * (j & 1);
      if (b0 + j < nb) {
        float o = run[j] + (float)(((incl[k] - cnt[k]) >> sh) & 0xffffu);
        float* orow = out + j * plane;
#pragma unroll
        for (int q = 0; q < kCols / 4; ++q) {
          float4 v;
          v.x = o + (d[4 * q] == j ? 1.f : 0.f);
          v.y = v.x + (d[4 * q + 1] == j ? 1.f : 0.f);
          v.z = v.y + (d[4 * q + 2] == j ? 1.f : 0.f);
          v.w = v.z + (d[4 * q + 3] == j ? 1.f : 0.f);
          o = v.w;
          if (c + 4 * q < w)
            *reinterpret_cast<float4*>(orow + c + 4 * q) = v;
        }
      }
      run[j] += (float)((total[k] >> sh) & 0xffffu);
    }
  }
}

template <int BB>
int launch_b(const int* idx, float* hh, int n, int h, int w, int nb,
             int warps, cudaStream_t stream) {
  const long long units = (long long)n * h * ((nb + BB - 1) / BB);
  const long long grid = (units + warps - 1) / warps;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  hscan_contig_kernel<BB><<<(unsigned)grid, warps * 32, 0, stream>>>(
      idx, hh, n, h, w, nb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hscan_contig_launch(const int* idx, float* hh, int n, int h,
                                   int w, int num_bins, int bin_block,
                                   int warps, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || num_bins <= 0) return (int)cudaSuccess;
  if (warps <= 0 || warps > kMaxWarps || (w & 3) != 0 ||
      (reinterpret_cast<uintptr_t>(idx) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(hh) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (bin_block) {
    case 2: return launch_b<2>(idx, hh, n, h, w, num_bins, warps, s);
    case 8: return launch_b<8>(idx, hh, n, h, w, num_bins, warps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
