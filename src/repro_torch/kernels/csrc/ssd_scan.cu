// K5: the Mamba-2 SSD chunked scan (G = 1 group), for Hopper (sm_90a).
// Replaces repro/kernels/ssd_scan.py::ssd_scan_pallas (body _ssd_kernel).
//
//   a_t = dt_t A ,  xdt_t = dt_t x_t
//   h_t = exp(a_t) h_{t-1} + B_t xdt_t^T        (state h: N x P)
//   y_t = C_t h_t
//
// per (batch, head), seeded from h0 (or zero), computed chunk by chunk in
// the SSD form: inside a chunk y = (C B^T * L) xdt + exp(a_cum) * (C h),
// with the decay mask L[i][j] = exp(a_cum_i - a_cum_j) for j <= i; across
// chunks h = exp(total) h + B^T (xdt * exp(total - a_cum)).  The final
// state is written out (h_last).
//
// What bounds it: operations.  Per 64-step chunk and head it does about
// 2 * 64 * (64 N + 64 P + 2 N P) flops on 64 (N + N + P) inputs, far more
// than the card's 20 flops a byte.  The design keeps every product on chip
// in fp32 FMAs (no tensor cores, no TF32):
//
//   * One CTA per (batch, head) walks the chunks in order with the (N, P)
//     state in shared memory: the TPU kernel's carry in VMEM scratch across
//     its ordered grid becomes a loop inside the CTA, because CTAs run in
//     no order.  Nothing crosses CTAs.
//   * The TPU's 256-step chunk does not fit: its B and C blocks, score and
//     decay matrices take about 800 KiB.  The CTA walks 64-step chunks
//     instead (kQ); the result does not depend on the chunk length apart
//     from rounding.  At N = 128, P = 64 one CTA holds 137 KiB of dynamic
//     shared memory: B and C transposed (n-major), the masked scores
//     transposed, x * dt, the state and the chunk's decays.
//   * Each product is a shared-memory GEMM of 4 x 4 register tiles fed by
//     16-byte loads: scores (only tiles on or below the diagonal), then y
//     (C h scaled by exp(a_cum), plus the masked scores times xdt up to the
//     diagonal), then the state update in place.
//   * The cumulative log-decay is a warp scan, not the TPU's triangular
//     matmul; steps past the sequence end (a ragged last chunk) are
//     identities (a = 0, xdt = 0) and write no y.
//
// Inputs are read where they lie: x (B, S, H, P), dt (B, S, H) and B / C
// (B, S, N) with their batch and sequence strides, the inner dims dense.
// y is written as a dense (B, S, H, P), h0 and h_last are dense (B, H, N, P).

#include <cuda_runtime.h>

namespace {

constexpr int kQ = 64;            // steps of one chunk walked by a CTA
constexpr int kLd = kQ + 4;       // padded row of the transposed tiles
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void outer4(float (&acc)[4][4], const float4 a,
                                       const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, long long sxb, long long sxs,
                const float* __restrict__ dt, long long sdb, long long sds,
                const float* __restrict__ A,
                const float* __restrict__ Bm, long long sbb, long long sbs,
                const float* __restrict__ Cm, long long scb, long long scs,
                const float* __restrict__ h0, float* __restrict__ y,
                float* __restrict__ h_last, int S, int H, int P, int N) {
  extern __shared__ __align__(16) float smem[];
  float* Ct = smem;                 // Ct[n * kLd + i] = C[i][n]
  float* Bt = Ct + N * kLd;         // Bt[n * kLd + j] = B[j][n]
  float* Mt = Bt + N * kLd;         // Mt[j * kLd + i] = (C B^T * L)[i][j]
  float* xs = Mt + kQ * kLd;        // xs[j * P + p] = xdt[j][p]
  float* hs = xs + kQ * P;          // hs[n * P + p] = state
  float* acum = hs + N * P;         // cumulative log-decay in the chunk
  float* din = acum + kQ;           // exp(acum)
  float* dout = din + kQ;           // exp(total - acum)

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const float Ah = A[h];
  const long long state_off = ((long long)b * H + h) * N * P;

  for (int e = tid; e < N * P; e += kThreads)
    hs[e] = h0 != nullptr ? h0[state_off + e] : 0.f;

  const int ptiles = P / 4;
  for (int t0 = 0; t0 < S; t0 += kQ) {
    // ---- load the chunk: a, x * dt, B and C transposed --------------------
    for (int i = tid; i < kQ; i += kThreads) {
      const int t = t0 + i;
      acum[i] = t < S ? dt[b * sdb + t * sds + h] * Ah : 0.f;
    }
    for (int e = tid; e < kQ * P; e += kThreads) {
      const int i = e / P, p = e - i * P, t = t0 + i;
      xs[e] = t < S ? x[b * sxb + t * sxs + (long long)h * P + p] *
                          dt[b * sdb + t * sds + h]
                    : 0.f;
    }
    for (int e = tid; e < kQ * N; e += kThreads) {
      const int i = e / N, n = e - i * N, t = t0 + i;
      Bt[n * kLd + i] = t < S ? Bm[b * sbb + t * sbs + n] : 0.f;
      Ct[n * kLd + i] = t < S ? Cm[b * scb + t * scs + n] : 0.f;
    }
    __syncthreads();

    // ---- cumulative log-decay: one warp, two steps a lane ------------------
    if (tid < 32) {
      const float a0 = acum[2 * tid], a1 = acum[2 * tid + 1];
      float incl = a0 + a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(kFull, incl, off);
        if (tid >= off) incl += o;
      }
      float excl = __shfl_up_sync(kFull, incl, 1);
      if (tid == 0) excl = 0.f;
      const float c0 = excl + a0, c1 = c0 + a1;
      const float total = __shfl_sync(kFull, c1, 31);
      acum[2 * tid] = c0;
      acum[2 * tid + 1] = c1;
      din[2 * tid] = expf(c0);
      din[2 * tid + 1] = expf(c1);
      dout[2 * tid] = expf(total - c0);
      dout[2 * tid + 1] = expf(total - c1);
    }
    __syncthreads();

    // ---- masked scores, stored transposed: one 4x4 tile a thread ----------
    {
      const int i0 = 4 * (tid >> 4), j0 = 4 * (tid & 15);
      float acc[4][4] = {};
      if (j0 <= i0 + 3) {                  // tiles above the diagonal are 0
        for (int n = 0; n < N; ++n)
          outer4(acc, ld4(Ct + n * kLd + i0), ld4(Bt + n * kLd + j0));
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int i = i0 + r, j = j0 + c;
            acc[r][c] = j <= i ? acc[r][c] * expf(acum[i] - acum[j]) : 0.f;
          }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<float4*>(Mt + (j0 + c) * kLd + i0) =
            make_float4(acc[0][c], acc[1][c], acc[2][c], acc[3][c]);
    }
    __syncthreads();

    // ---- y = exp(a_cum) * (C h) + (C B^T * L) xdt --------------------------
    for (int tile = tid; tile < (kQ / 4) * ptiles; tile += kThreads) {
      const int i0 = 4 * (tile / ptiles), p0 = 4 * (tile % ptiles);
      float acc[4][4] = {};
      for (int n = 0; n < N; ++n)
        outer4(acc, ld4(Ct + n * kLd + i0), ld4(hs + n * P + p0));
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float d = din[i0 + r];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] *= d;
      }
      for (int j = 0; j < i0 + 4; ++j)     // M[i][j] = 0 for j > i
        outer4(acc, ld4(Mt + j * kLd + i0), ld4(xs + j * P + p0));
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = t0 + i0 + r;
        if (t < S)
          *reinterpret_cast<float4*>(
              y + (((long long)b * S + t) * H + h) * P + p0) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      }
    }
    __syncthreads();

    // ---- state: h = exp(total) h + B^T (xdt * exp(total - a_cum)) ----------
    {
      const float et = expf(acum[kQ - 1]);
      for (int tile = tid; tile < (N / 4) * ptiles; tile += kThreads) {
        const int n0 = 4 * (tile / ptiles), p0 = 4 * (tile % ptiles);
        float acc[4][4] = {};
        for (int j = 0; j < kQ; j += 4) {
          const float4 b4[4] = {ld4(Bt + (n0 + 0) * kLd + j),
                                ld4(Bt + (n0 + 1) * kLd + j),
                                ld4(Bt + (n0 + 2) * kLd + j),
                                ld4(Bt + (n0 + 3) * kLd + j)};
          const float bj[4][4] = {{b4[0].x, b4[1].x, b4[2].x, b4[3].x},
                                  {b4[0].y, b4[1].y, b4[2].y, b4[3].y},
                                  {b4[0].z, b4[1].z, b4[2].z, b4[3].z},
                                  {b4[0].w, b4[1].w, b4[2].w, b4[3].w}};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float4 xv = ld4(xs + (j + k) * P + p0);
            const float d = dout[j + k];
            outer4(acc, make_float4(bj[k][0], bj[k][1], bj[k][2], bj[k][3]),
                   make_float4(xv.x * d, xv.y * d, xv.z * d, xv.w * d));
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float4* hp = reinterpret_cast<float4*>(hs + (n0 + r) * P + p0);
          const float4 o = *hp;
          *hp = make_float4(fmaf(et, o.x, acc[r][0]), fmaf(et, o.y, acc[r][1]),
                            fmaf(et, o.z, acc[r][2]), fmaf(et, o.w, acc[r][3]));
        }
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < N * P; e += kThreads) h_last[state_off + e] = hs[e];
}

// Dynamic shared memory of one CTA (kernels/ssd_scan.py::smem_bytes
// checks the same sum before any launch).
int smem_bytes(int P, int N) {
  return (int)sizeof(float) *
         (2 * N * kLd + kQ * kLd + kQ * P + N * P + 3 * kQ);
}

}  // namespace

// Plain C interface for ctypes; returns the cudaError_t of the launch.
extern "C" int ssd_scan_launch(const float* x, long long sxb, long long sxs,
                               const float* dt, long long sdb, long long sds,
                               const float* A, const float* Bm, long long sbb,
                               long long sbs, const float* Cm, long long scb,
                               long long scs, const float* h0, float* y,
                               float* h_last, int batch, int S, int H, int P,
                               int N, void* stream) {
  if (batch <= 0 || H <= 0) return (int)cudaSuccess;
  if (P <= 0 || N <= 0 || (P & 3) || (N & 3) || S < 0)
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(P, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<<<dim3(H, batch), kThreads, smem, (cudaStream_t)stream>>>(
      x, sxb, sxs, dt, sdb, sds, A, Bm, sbb, sbs, Cm, scb, scs, h0, y, h_last,
      S, H, P, N);
  return (int)cudaGetLastError();
}
