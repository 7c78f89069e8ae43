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
// hscan: one warp per unit, a (frame, row, block of BB bins), walking the
//   row left to right in chunks of kChunk = 128 columns.  Lane l holds
//   columns 128 k + 4 l .. 128 k + 4 l + 3 of chunk k: warp-striped, so
//   each int4 load of ids and each bin's float4 store covers 512
//   contiguous bytes.  Per chunk a lane counts its hits of each bin in an
//   8-bit field (4 bins a 32-bit word: a chunk holds at most 128 hits of a
//   bin), scans the words across the warp with five __shfl_up_sync steps
//   and adds each bin's running row total, which stays in a register and
//   grows by the chunk's total, broadcast from lane 31: the TPU kernel's
//   row_carry between column tiles.  The next chunk's ids are loaded
//   before this chunk's stores (a register double buffer), and latency is
//   hidden by many small resident warps, not by a deep pipeline.  No
//   shared memory, no __syncthreads and nothing carried between warps or
//   CTAs, so any width and any height run the same code; a masked tail
//   chunk takes a ragged width, a scalar instantiation a width that is not
//   a multiple of 4 or an unaligned pointer.  A CTA holds `warps` units;
//   grid x runs over (frame, row, bin block) with the bin blocks of a row
//   adjacent, so the warps that read the same ids meet in L1 and L2.  A
//   bin block of 8 holds 32 floats of output a lane: no spill, and the
//   ids are read nb / 8 times.  The TPU kernel's row scan on its matrix
//   unit (_row_scan_mxu, a triangular product) is not carried over: the
//   work is two operations per 4 bytes written, far below what would make
//   tensor cores pay.
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

#include <cstdint>

namespace {

constexpr int kChunk = 128;       // hscan columns a warp takes at a time
constexpr int kMaxWarps = 16;     // hscan warps (units) a CTA at most
constexpr int kVThreads = 256;    // vscan threads per CTA
constexpr unsigned kFull = 0xffffffffu;

// A lane's 4 ids from column c of its row; -1 (no bin) past the row.
template <bool VEC>
__device__ __forceinline__ int4 load_ids(const int* __restrict__ row, int c,
                                         int w) {
  int4 v = make_int4(-1, -1, -1, -1);
  if (VEC) {
    if (c < w) v = __ldg(reinterpret_cast<const int4*>(row + c));
  } else {
    if (c < w) v.x = __ldg(row + c);
    if (c + 1 < w) v.y = __ldg(row + c + 1);
    if (c + 2 < w) v.z = __ldg(row + c + 2);
    if (c + 3 < w) v.w = __ldg(row + c + 3);
  }
  return v;
}

// One hit of bin b0 + d, for d in [0, BB): 1 in the 8-bit field d % 4 of
// word d / 4.  Any other d (another block's bin, or -1) adds nothing.
template <int BB>
__device__ __forceinline__ void add_hit(unsigned (&cnt)[(BB + 3) / 4],
                                        int d) {
  const unsigned one = (unsigned)d < (unsigned)BB ? 1u << (8 * (d & 3)) : 0u;
  if constexpr (BB > 4) {
    cnt[0] += d < 4 ? one : 0u;
    cnt[1] += d < 4 ? 0u : one;
  } else {
    cnt[0] += one;
  }
}

template <int BB, bool VEC>
__global__ void __launch_bounds__(kMaxWarps * 32)
hscan_kernel(const int* __restrict__ idx,    // (n, h, w) bin ids
             float* __restrict__ hh,         // (n, nb, h, w)
             int n, int h, int w, int nb) {
  constexpr int kWords = (BB + 3) / 4;
  const int lane = threadIdx.x & 31;
  const int blocks = (nb + BB - 1) / BB;
  long long u = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (u >= (long long)n * h * blocks) return;   // the last CTA's spare warps
  const int b0 = (int)(u % blocks) * BB;        // unit: (frame, row, block)
  u /= blocks;
  const long long fr = u;                       // f * h + r
  const long long plane = (long long)h * w;     // one bin's plane of hh
  const int* row = idx + fr * w;
  float* out = hh + ((fr / h) * nb + b0) * plane + (fr % h) * w;

  float run[BB];                                // each bin's row total so far
#pragma unroll
  for (int j = 0; j < BB; ++j) run[j] = 0.f;
  int4 ids = load_ids<VEC>(row, 4 * lane, w);
  for (int c_lo = 0; c_lo < w; c_lo += kChunk) {
    const int c = c_lo + 4 * lane;
    const int4 next = load_ids<VEC>(row, c + kChunk, w);
    const int d[4] = {ids.x - b0, ids.y - b0, ids.z - b0, ids.w - b0};
    unsigned cnt[kWords], incl[kWords];
#pragma unroll
    for (int k = 0; k < kWords; ++k) cnt[k] = 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e) add_hit<BB>(cnt, d[e]);
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
      const int k = j >> 2, sh = 8 * (j & 3);
      if (b0 + j < nb) {
        float4 o;
        o.x = run[j] + (float)(((incl[k] - cnt[k]) >> sh) & 0xffu) +
              (d[0] == j ? 1.f : 0.f);
        o.y = o.x + (d[1] == j ? 1.f : 0.f);
        o.z = o.y + (d[2] == j ? 1.f : 0.f);
        o.w = o.z + (d[3] == j ? 1.f : 0.f);
        float* orow = out + j * plane;
        if (VEC) {
          if (c < w) *reinterpret_cast<float4*>(orow + c) = o;
        } else {
          if (c < w) orow[c] = o.x;
          if (c + 1 < w) orow[c + 1] = o.y;
          if (c + 2 < w) orow[c + 2] = o.z;
          if (c + 3 < w) orow[c + 3] = o.w;
        }
      }
      run[j] += (float)((total[k] >> sh) & 0xffu);
    }
    ids = next;
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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int BB>
cudaError_t launch_hscan_bb(const int* idx, float* hh, int n, int h, int w,
                            int nb, int warps, cudaStream_t stream) {
  const long long units = (long long)n * h * ((nb + BB - 1) / BB);
  const long long grid = (units + warps - 1) / warps;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool vec = (w & 3) == 0 && aligned16(idx) && aligned16(hh);
  if (vec) {
    hscan_kernel<BB, true><<<(unsigned)grid, warps * 32, 0, stream>>>(
        idx, hh, n, h, w, nb);
  } else {
    hscan_kernel<BB, false><<<(unsigned)grid, warps * 32, 0, stream>>>(
        idx, hh, n, h, w, nb);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes; each returns the cudaError_t of its launch.
extern "C" int cw_tis_hscan_launch(const int* idx, float* hh, int n, int h,
                                   int w, int num_bins, int bin_block,
                                   int warps, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || num_bins <= 0) return (int)cudaSuccess;
  if (warps <= 0 || warps > kMaxWarps) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (bin_block) {
    case 1: return (int)launch_hscan_bb<1>(idx, hh, n, h, w, num_bins, warps, s);
    case 2: return (int)launch_hscan_bb<2>(idx, hh, n, h, w, num_bins, warps, s);
    case 4: return (int)launch_hscan_bb<4>(idx, hh, n, h, w, num_bins, warps, s);
    case 8: return (int)launch_hscan_bb<8>(idx, hh, n, h, w, num_bins, warps, s);
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
