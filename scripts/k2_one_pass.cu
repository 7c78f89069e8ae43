// K2 in one pass: the chunk sums chained by decoupled look-back (Merrill
// and Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", 2016), against which scripts/k2_variants.py times the
// two-pass K2 of src/repro_torch/kernels/csrc/fused_rows.cu.  An
// experiment, not a kernel of the port.
//
// One CTA per tile (frame, chunk m, block of BB bins), tiles numbered by an
// atomic counter in launch order, so that a tile's predecessor (m - 1, the
// same frame and bins) always started before it.  A tile counts and
// row-scans its chunk as pass A does (its aggregate), publishes it
// (flag 1; chunk 0 publishes its inclusive sum at once, flag 2), then looks
// back over m - 1, m - 2, ..., adding aggregates until it meets an
// inclusive sum, adds its own aggregate, publishes its inclusive sum
// (flag 2) and writes it where its chunk ends a requested row.  The
// inclusive sums carry the carry row.  incl may be the output itself when
// every chunk ends a requested row.  Columns: a multiple of 4, at most
// 4 * blockDim.x; bin blocks of 4 or 8.
//
// Built and driven by scripts/k2_variants.py (nvcc -I
// src/repro_torch/kernels/csrc).

#include "wf_tis_scan.cuh"

namespace {

using wf_tis_scan::cta_exclusive_scan;
using wf_tis_scan::load_ids;

constexpr int kMaxThreads = 512;
constexpr int kBatch = 8;

template <int BB>
__global__ void __launch_bounds__(kMaxThreads)
one_pass_kernel(const int* __restrict__ idx,     // (n, h, w)
                const int* __restrict__ plan,    // first (M,), slot (M,)
                const float* __restrict__ carry, // (n, nb, w) or nullptr
                float* agg,                      // (n, nb, M, w)
                float* incl,                     // (n, nb, M, w), or out
                float* out,                      // (n, nb, K, w)
                int* flags,                      // (n, blocks, M), zeroed
                unsigned* counter,               // zeroed
                int h, int h_run, int w, int nb, int chunks, int k_rows,
                int blocks) {
  __shared__ float warp_tot[BB * 32];
  __shared__ int s_tile;
  __shared__ int s_flag;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_tile = (int)atomicAdd(counter, 1u);
  __syncthreads();
  const int tile = s_tile;
  const int fm = tile / blocks;               // tiles in (f, m, bin block)
  const int bblock = tile - fm * blocks;
  const int b0 = bblock * BB;
  const int f = fm / chunks;
  const int m = fm - f * chunks;
  const int c = 4 * tid;
  const int* first = plan;
  const int* slot = plan + chunks;
  const int r_begin = __ldg(first + m);
  const int r_end = m + 1 < chunks ? __ldg(first + m + 1) : h_run;
  const int* frame = idx + (size_t)f * h * w;

  float4 cnt[BB];
#pragma unroll
  for (int j = 0; j < BB; ++j) cnt[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r0 = r_begin; r0 < r_end; r0 += kBatch) {
    int4 id[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      int4 one[1] = {make_int4(-1, -1, -1, -1)};
      if (r0 + k < r_end)
        load_ids<1>(frame + (size_t)(r0 + k) * w, c, w, (w & 3) == 0, one);
      id[k] = one[0];
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
#pragma unroll
      for (int j = 0; j < BB; ++j) {
        const int b = b0 + j;
        cnt[j].x += id[k].x == b ? 1.f : 0.f;
        cnt[j].y += id[k].y == b ? 1.f : 0.f;
        cnt[j].z += id[k].z == b ? 1.f : 0.f;
        cnt[j].w += id[k].w == b ? 1.f : 0.f;
      }
  }
  float tot[BB];
  float excl[BB];
#pragma unroll
  for (int j = 0; j < BB; ++j)
    tot[j] = (cnt[j].x + cnt[j].y) + (cnt[j].z + cnt[j].w);
  cta_exclusive_scan<BB>(tot, excl, warp_tot, lane, warp);
  float4 own[BB];                              // the aggregate
#pragma unroll
  for (int j = 0; j < BB; ++j) {
    own[j].x = excl[j] + cnt[j].x;
    own[j].y = own[j].x + cnt[j].y;
    own[j].z = own[j].y + cnt[j].z;
    own[j].w = own[j].z + cnt[j].w;
  }

  auto row = [&](float* base, int j, int mm) {
    return base + (((size_t)f * nb + b0 + j) * chunks + mm) * w + c;
  };
  auto put = [&](float* p, float4 v) {
    if (c + 3 < w) {
      *reinterpret_cast<float4*>(p) = v;
    } else {
      if (c < w) p[0] = v.x;
      if (c + 1 < w) p[1] = v.y;
      if (c + 2 < w) p[2] = v.z;
    }
  };
  auto get = [&](const float* p) {
    if (c + 3 < w) return __ldcg(reinterpret_cast<const float4*>(p));
    return make_float4(c < w ? __ldcg(p) : 0.f, c + 1 < w ? __ldcg(p + 1) : 0.f,
                       c + 2 < w ? __ldcg(p + 2) : 0.f, 0.f);
  };
  int* my_flag = flags + ((size_t)f * blocks + bblock) * chunks + m;
  auto publish = [&](int value) {
    __threadfence();
    __syncthreads();
    if (tid == 0) atomicExch(my_flag, value);
  };

  float4 sum[BB];
#pragma unroll
  for (int j = 0; j < BB; ++j) {
    sum[j] = own[j];
    if (m == 0 && carry != nullptr && b0 + j < nb) {
      const float* cr = carry + ((size_t)f * nb + b0 + j) * w + c;
      const float4 v = make_float4(c < w ? cr[0] : 0.f,
                                   c + 1 < w ? cr[1] : 0.f,
                                   c + 2 < w ? cr[2] : 0.f,
                                   c + 3 < w ? cr[3] : 0.f);
      sum[j].x += v.x, sum[j].y += v.y, sum[j].z += v.z, sum[j].w += v.w;
    }
  }
  if (m > 0) {
#pragma unroll
    for (int j = 0; j < BB; ++j)
      if (b0 + j < nb) put(row(agg, j, m), own[j]);
    publish(1);
    // Look back until an inclusive sum: aggregates on the way.
    for (int mm = m - 1;; --mm) {
      if (tid == 0) {
        const volatile int* fp = my_flag - (m - mm);
        int fl;
        do {
          fl = *fp;
        } while (fl == 0);
        __threadfence();
        s_flag = fl;
      }
      __syncthreads();
      const int fl = s_flag;
      __syncthreads();
      float* src = fl == 2 ? incl : agg;
#pragma unroll
      for (int j = 0; j < BB; ++j) {
        if (b0 + j >= nb) break;
        const float4 v = get(row(src, j, mm));
        sum[j].x += v.x, sum[j].y += v.y, sum[j].z += v.z, sum[j].w += v.w;
      }
      if (fl == 2) break;
    }
  }
#pragma unroll
  for (int j = 0; j < BB; ++j)
    if (b0 + j < nb) put(row(incl, j, m), sum[j]);
  publish(2);
  const int i = __ldg(slot + m);
  if (incl != out && i >= 0) {
#pragma unroll
    for (int j = 0; j < BB; ++j)
      if (b0 + j < nb)
        put(out + (((size_t)f * nb + b0 + j) * k_rows + i) * w + c, sum[j]);
  }
}

}  // namespace

// flags is (n * ceil(nb / bin_block) * chunks + 1) ints on the device: the
// tiles' flags, then the tile counter; zeroed here.  plan is on the device.
extern "C" int k2_one_pass_launch(const int* idx, const int* plan,
                                  const float* carry, float* agg, float* incl,
                                  float* out, int* flags, int n, int h,
                                  int h_run, int w, int nb, int chunks,
                                  int k_rows, int bin_block, int threads,
                                  void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (threads <= 0 || threads > kMaxThreads || 4 * threads < w ||
      (w & 3) != 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (nb + bin_block - 1) / bin_block;
  const long long tiles = (long long)n * blocks * chunks;
  cudaError_t err =
      cudaMemsetAsync(flags, 0, sizeof(int) * (size_t)(tiles + 1), st);
  if (err != cudaSuccess) return (int)err;
  unsigned* counter = reinterpret_cast<unsigned*>(flags + tiles);
#define K2_ONE_PASS(BB)                                                    \
  one_pass_kernel<BB><<<(unsigned)tiles, threads, 0, st>>>(                \
      idx, plan, carry, agg, incl, out, flags, counter, h, h_run, w, nb,   \
      chunks, k_rows, blocks)
  switch (bin_block) {
    case 8: K2_ONE_PASS(8); break;
    case 4: K2_ONE_PASS(4); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef K2_ONE_PASS
  return (int)cudaGetLastError();
}
