// What K5 (ssd_scan.cu) and K5-bwd (ssd_scan_bwd.cu) share: the 64-step
// chunk, the 3xTF32 tensor-core products, the cp.async copies and the
// chunk-decay warp scan.
//
// The products run as mma.sync m16n8k8 in TF32 with fp32 accumulation, in
// the 3xTF32 split: each fp32 operand x is split into hi = tf32(x) and
// lo = tf32(x - hi) (by bit masks), and each product takes hi*lo + lo*hi +
// hi*hi (lo*lo dropped): about fp32 accuracy, where plain TF32 (10-bit
// mantissas) misses the kernels' 1e-4 gates.  It costs three tensor-core
// products for each product needed, so the operation bound is the TF32
// rate over 3.
//
// Shared-memory layouts are padded so that fragment loads of a warp hit 32
// different banks: a row stride of 4 mod 32 words where lanes read (row g,
// column t), 8 mod 32 where they read (row t, column g) (g = lane / 4,
// t = lane % 4).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;            // steps of one chunk
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// ---- 3xTF32 tensor-core products --------------------------------------------

// x = hi + lo with hi = x rounded to TF32's 10 explicit mantissa bits (a
// half-ulp add, then the low 13 bits cleared) and lo = (x - hi) with its
// low 13 bits cleared: integer and fp32 ops at the full rate, where
// cvt.rna.tf32.f32 runs in the quarter-rate conversion pipe.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32: the small terms first, then hi * hi.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// The A fragment (16 x 8, row major) of a(m, k) = p[m * sm + k * sk], split;
// with kScale, row m is first multiplied by s[m].
template <bool kScale = false>
__device__ __forceinline__ void load_a(const float* p, int sm, int sk,
                                       int lane, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4],
                                       const float* s = nullptr) {
  const int g = lane >> 2, t = lane & 3;
  float v0 = p[g * sm + t * sk], v1 = p[(g + 8) * sm + t * sk];
  float v2 = p[g * sm + (t + 4) * sk], v3 = p[(g + 8) * sm + (t + 4) * sk];
  if constexpr (kScale) {
    const float s0 = s[g], s1 = s[g + 8];
    v0 *= s0;
    v1 *= s1;
    v2 *= s0;
    v3 *= s1;
  }
  split(v0, hi[0], lo[0]);
  split(v1, hi[1], lo[1]);
  split(v2, hi[2], lo[2]);
  split(v3, hi[3], lo[3]);
}

// The B fragment (8 x 8, column major) of b(k, n) = p[k * sk + n * sn],
// split; with kScale, column n is first multiplied by s[n].
template <bool kScale = false>
__device__ __forceinline__ void load_b(const float* p, int sk, int sn,
                                       int lane, uint32_t (&hi)[2],
                                       uint32_t (&lo)[2],
                                       const float* s = nullptr) {
  const int g = lane >> 2, t = lane & 3;
  float v0 = p[t * sk + g * sn], v1 = p[(t + 4) * sk + g * sn];
  if constexpr (kScale) {
    v0 *= s[g];
    v1 *= s[g];
  }
  split(v0, hi[0], lo[0]);
  split(v1, hi[1], lo[1]);
}

// acc[mt][nt] += A (16 MT x 8k) B (8k x 8 NT) over k steps [0, ksteps): MT
// m-tiles of 16 rows, NT n-tiles of 8 columns; each fragment is split
// once.  a(m, k) = A[m * sam + k * sak] (times sa[m] with kScaleA),
// b(k, n) = B[k * sbk + n * sbn] (times sb[n] with kScaleB).
template <int MT, int NT, bool kScaleA = false, bool kScaleB = false>
__device__ __forceinline__ void warp_gemm(float (*acc)[NT][4],
                                          const float* A, int sam, int sak,
                                          const float* B, int sbk, int sbn,
                                          int ksteps, int lane,
                                          const float* sa = nullptr,
                                          const float* sb = nullptr) {
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      load_a<kScaleA>(A + 16 * mt * sam + 8 * ks * sak, sam, sak, lane,
                      ah[mt], al[mt], kScaleA ? sa + 16 * mt : nullptr);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t bh[2], bl[2];
      load_b<kScaleB>(B + 8 * ks * sbk + 8 * nt * sbn, sbk, sbn, lane, bh,
                      bl, kScaleB ? sb + 8 * nt : nullptr);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        mma3(acc[mt][nt], ah[mt], al[mt], bh, bl);
    }
  }
}

// ---- asynchronous copies into shared memory ---------------------------------

// 16 bytes from global to shared memory without passing through registers;
// zero-filled (nothing read) where !valid.  Both addresses 16-byte aligned.
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes, zero-filled where !valid; src 4-byte aligned.
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` committed groups of this thread are in flight.
template <int pending>
__device__ __forceinline__ void copies_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---- the chunk's decays -----------------------------------------------------

// One warp: a_cum of the chunk's kQ steps from their dt in shared memory
// (0 past S), a = dt * Ah, two steps a lane: cum = a_cum at steps 2 lane
// and 2 lane + 1.  Returns the chunk's total in every lane.
__device__ __forceinline__ float warp_cumsum(const float* d, float Ah,
                                             int lane, float (&cum)[2]) {
  const float a0 = d[2 * lane] * Ah, a1 = d[2 * lane + 1] * Ah;
  float incl = a0 + a1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += o;
  }
  float excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0.f;
  cum[0] = excl + a0;
  cum[1] = cum[0] + a1;
  return __shfl_sync(kFull, cum[1], 31);
}

}  // namespace
