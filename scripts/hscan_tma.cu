// K4's hscan with its ids fed through a shared-memory ring by the Tensor
// Memory Accelerator: a variant that scripts/hscan_variants.py builds and
// times beside the port's hscan (csrc/cw_tis.cu), whose next chunk of ids
// is a register double buffer instead.
//
// The walk is the port's: one warp per (frame, row, block of BB bins),
// chunks of 128 columns, lane l on columns 128 k + 4 l .. + 3, 8-bit hit
// fields scanned across the warp with shuffles, each bin's row total in a
// register.  Here each warp owns S stages of 512 bytes of shared memory
// and one mbarrier a stage; lane 0 keeps S chunks of the row in flight
// with cp.async.bulk (each completing its stage's barrier by byte count),
// and the warp reads chunk k from stage k % S after waiting on that
// barrier's phase k / S.  A stage is refilled once every lane has read it
// (__syncwarp).  Rows must be 16-byte aligned and a multiple of 4 columns
// (cp.async.bulk copies whole 16-byte units): the script times it only on
// such frames.

#include <cstdint>

namespace {

constexpr int kChunk = 128;
constexpr int kMaxWarps = 16;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void copy_chunk(int4* dst, const int* src,
                                           unsigned bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void wait_phase(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

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

template <int BB, int S>
__global__ void __launch_bounds__(kMaxWarps * 32)
hscan_tma_kernel(const int* __restrict__ idx, float* __restrict__ hh, int n,
                 int h, int w, int nb) {
  constexpr int kWords = (BB + 3) / 4;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int4* ring = reinterpret_cast<int4*>(smem) + (size_t)warp * S * 32;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + (size_t)warps * S * kChunk * 4) +
      warp * S;
  const int blocks = (nb + BB - 1) / BB;
  long long u = (long long)blockIdx.x * warps + warp;
  if (u >= (long long)n * h * blocks) return;
  const int b0 = (int)(u % blocks) * BB;
  u /= blocks;
  const long long fr = u;
  const long long plane = (long long)h * w;
  const int* row = idx + fr * w;
  float* out = hh + ((fr / h) * nb + b0) * plane + (fr % h) * w;
  const int chunks = (w + kChunk - 1) / kChunk;

  if (lane == 0) {
    for (int s = 0; s < S; ++s) bar_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    for (int k = 0; k < S && k < chunks; ++k)
      copy_chunk(ring + k * 32, row + k * kChunk,
                 4u * (unsigned)min(kChunk, w - k * kChunk), &bars[k]);
  }
  __syncwarp();

  float run[BB];
#pragma unroll
  for (int j = 0; j < BB; ++j) run[j] = 0.f;
  for (int k = 0; k < chunks; ++k) {
    const int s = k % S;
    const int c = k * kChunk + 4 * lane;
    wait_phase(&bars[s], (unsigned)(k / S) & 1u);
    int4 ids = ring[s * 32 + lane];
    if (c >= w) ids = make_int4(-1, -1, -1, -1);
    __syncwarp();
    if (lane == 0 && k + S < chunks) {
      // The warp's reads of this stage (generic proxy) before the copy
      // that overwrites it (async proxy).
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      copy_chunk(ring + s * 32, row + (k + S) * kChunk,
                 4u * (unsigned)min(kChunk, w - (k + S) * kChunk), &bars[s]);
    }
    const int d[4] = {ids.x - b0, ids.y - b0, ids.z - b0, ids.w - b0};
    unsigned cnt[kWords], incl[kWords];
#pragma unroll
    for (int q = 0; q < kWords; ++q) cnt[q] = 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e) add_hit<BB>(cnt, d[e]);
#pragma unroll
    for (int q = 0; q < kWords; ++q) incl[q] = cnt[q];
#pragma unroll
    for (int t = 1; t < 32; t <<= 1) {
#pragma unroll
      for (int q = 0; q < kWords; ++q) {
        const unsigned v = __shfl_up_sync(kFull, incl[q], t);
        if (lane >= t) incl[q] += v;
      }
    }
    unsigned total[kWords];
#pragma unroll
    for (int q = 0; q < kWords; ++q)
      total[q] = __shfl_sync(kFull, incl[q], 31);
#pragma unroll
    for (int j = 0; j < BB; ++j) {
      const int q = j >> 2, sh = 8 * (j & 3);
      if (b0 + j < nb) {
        float4 o;
        o.x = run[j] + (float)(((incl[q] - cnt[q]) >> sh) & 0xffu) +
              (d[0] == j ? 1.f : 0.f);
        o.y = o.x + (d[1] == j ? 1.f : 0.f);
        o.z = o.y + (d[2] == j ? 1.f : 0.f);
        o.w = o.z + (d[3] == j ? 1.f : 0.f);
        if (c < w) *reinterpret_cast<float4*>(out + j * plane + c) = o;
      }
      run[j] += (float)((total[q] >> sh) & 0xffu);
    }
  }
}

template <int BB, int S>
int launch_bs(const int* idx, float* hh, int n, int h, int w, int nb,
              int warps, cudaStream_t stream) {
  const long long units = (long long)n * h * ((nb + BB - 1) / BB);
  const long long grid = (units + warps - 1) / warps;
  const int smem = warps * S * (kChunk * 4 + 8);
  if (grid > 0x7fffffffLL || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  hscan_tma_kernel<BB, S><<<(unsigned)grid, warps * 32, smem, stream>>>(
      idx, hh, n, h, w, nb);
  return (int)cudaGetLastError();
}

template <int BB>
int launch_b(const int* idx, float* hh, int n, int h, int w, int nb,
             int warps, int stages, cudaStream_t stream) {
  switch (stages) {
    case 2: return launch_bs<BB, 2>(idx, hh, n, h, w, nb, warps, stream);
    case 4: return launch_bs<BB, 4>(idx, hh, n, h, w, nb, warps, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int hscan_tma_launch(const int* idx, float* hh, int n, int h,
                                int w, int num_bins, int bin_block,
                                int warps, int stages, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || num_bins <= 0) return (int)cudaSuccess;
  if (warps <= 0 || warps > kMaxWarps || (w & 3) != 0 ||
      (reinterpret_cast<uintptr_t>(idx) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(hh) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (bin_block) {
    case 2: return launch_b<2>(idx, hh, n, h, w, num_bins, warps, stages, s);
    case 4: return launch_b<4>(idx, hh, n, h, w, num_bins, warps, stages, s);
    case 8: return launch_b<8>(idx, hh, n, h, w, num_bins, warps, stages, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
