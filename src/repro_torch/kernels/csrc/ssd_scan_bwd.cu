// K5-bwd: the gradients of the Mamba-2 SSD scan (G = 1 group), for Hopper
// (sm_90a).  The TPU kernel (repro/kernels/ssd_scan.py::ssd_scan_pallas) has
// no backward: the reference differentiates its jnp chunk loop through XLA.
// On the card K5 (ssd_scan.cu) is on the training path, so autograd needs a
// backward of its own (kernels/ssd_scan.py::SSDScanFunction).
//
// Per (batch, head), with the forward's
//   a_t = dt_t A ,  u_t = dt_t x_t ,  h_t = exp(a_t) h_{t-1} + B_t u_t^T ,
//   y_t = h_t^T C_t
// and the gradients gy (of y) and g_hlast (of the last state), the gradient
// lam_t of the loss in h_t runs backwards:
//   lam_t = C_t gy_t^T + exp(a_{t+1}) lam_{t+1}      (seeded with g_hlast)
//   gu_t = lam_t^T B_t ,  gB_t = lam_t u_t ,  gC_t = h_t gy_t ,
//   ga_t = exp(a_t) <h_{t-1}, lam_t> ,  g_h0 = exp(a_1) lam_1 ,
// and gx = gu dt, gdt = <gu, x> + ga A (gA = sum ga dt is left to the
// wrapper).
//
// The design is the simple one: one CTA per (32 columns of P, head, batch)
// walks the 64-step chunks from the last to the first, one thread per state
// row n, its 32 columns of lam and h in registers.
//
//   1. h_t is recomputed from the state entering the chunk, which the
//      forward (ssd_scan.cu's state scan) wrote and the wrapper kept.  Each
//      thread contracts its row over its columns: gC_t[n] (written per 32
//      columns and head, summed by the wrapper) and C_t[n] gC_t[n] (summed
//      over the rows by a warp reduction: the CTA's part of <gy_t, y_t>).
//   2. lam walks the chunk backwards.  gB_t[n] is a row's contraction again
//      (written per 32 columns and head); gu_t = sum_n lam_t[n] B_t[n]
//      crosses the rows: each warp reduces its 32 rows for all 32 columns at
//      once (a butterfly that halves the columns a lane keeps at each of its
//      five shuffles, leaving lane l with column l) into shared memory.
//   3. gu is summed over the warps: gx = gu dt, and <gu, x>.
//   4. ga, without a third pass over the state: with q_t = <h_t, lam_t>,
//      ga_t = q_t - <u_t, gu_t> and q_{t-1} = <gy_{t-1}, y_{t-1}> + ga_t
//      (the CTA's columns only: all of it is linear), seeded at the chunk's
//      last step with q = <h, lam> computed there from the registers.  A
//      warp's suffix scan of the chunk's 64 steps gives every ga_t; rounding
//      runs over one chunk, not the sequence.
//
// Every decay is exp of a non-positive number (dt >= 0, A < 0): nothing
// overflows, as the masked chunk form of the plain version (and of the
// reference at 256-step chunks, which reads NaN) would.  No atomics: each
// output element has one writer, partial sums are added by the wrapper in
// a fixed order, and the gradients repeat bit for bit.
//
// What bounds it on an H100: operations.  The function needs five fp32
// multiply-adds per state element a step (h recomputed, gC, lam, gB, gu),
// 10 N P flops a step, 8.1 GFLOP at the training shape (B=4, S=1024, H=24,
// P=64, N=128), against 0.14 GB of inputs read and gradients written.  This
// kernel walks 1024 steps in order in each of its 192 CTAs (4 warps each)
// and keeps the tensor cores idle: its time is the walk's latency.  The
// chunk-parallel form K5 has (chunk states, then every chunk at once on the
// tensor cores) is the redesign.
//
// Inputs are read where they lie: x (B, S, H, P) and B / C (B, S, N) with
// their batch and sequence strides, the inner dims dense, dt (B, S, H) with
// H dense; gy is a dense (B, S, H, P), states a dense (B, H, chunks, N, P),
// g_hlast and g_h0 dense (B, H, N, P).  Steps past S are identities (dt = 0,
// u = gy = B = C = 0) and write nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;            // steps of one chunk: ssd_scan.cu's kQ
constexpr int kHalf = kQ / 2;     // steps whose gu rows wait in shared memory
constexpr int kPB = 32;           // columns of P one CTA owns
constexpr int kMaxRows = 256;     // state rows (N) at most: one thread each
constexpr unsigned kFull = 0xffffffffu;

// Shared memory of one CTA, in floats, for nr threads (N rounded up to 32):
// a chunk's B and C rows, its x and gy columns, its dt, exp(a) and <gu, x>,
// then each warp's gu (half a chunk's steps, all columns), C gC (all steps)
// and <h, lam>.  About 98 KiB at N = 128: two CTAs an SM.
__host__ __device__ constexpr int smem_floats(int nr) {
  return 2 * kQ * nr + 2 * kQ * kPB + 3 * kQ +
         (nr / 32) * (kHalf * kPB + kQ + 1);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// One fold of the warp's column sums: the lanes whose kOff bit is set keep
// the upper kOff of the 2 kOff columns still held, the others the lower,
// and each adds its partner's copy of what it keeps.
template <int kOff>
__device__ __forceinline__ void fold(float (&v)[kPB], int lane) {
  const bool upper = (lane & kOff) != 0;
#pragma unroll
  for (int k = 0; k < kOff; ++k) {
    const float send = upper ? v[k] : v[k + kOff];
    const float keep = upper ? v[k + kOff] : v[k];
    v[k] = keep + __shfl_xor_sync(kFull, send, kOff);
  }
}

__global__ void __launch_bounds__(kMaxRows)
ssd_bwd_kernel(const float* __restrict__ x, long long sxb, long long sxs,
               const float* __restrict__ dt, long long sdb, long long sds,
               const float* __restrict__ A,
               const float* __restrict__ Bm, long long sbb, long long sbs,
               const float* __restrict__ Cm, long long scb, long long scs,
               const float* __restrict__ gy, const float* __restrict__ states,
               const float* __restrict__ g_hlast, float* __restrict__ gx,
               float* __restrict__ gdt_part, float* __restrict__ ga_part,
               float* __restrict__ gB_part, float* __restrict__ gC_part,
               float* __restrict__ g_h0, int batch, int S, int H, int P,
               int N, int chunks) {
  extern __shared__ __align__(16) float smem[];
  const int nr = blockDim.x, nw = nr >> 5;
  float* Bs = smem;                     // [kQ][nr]: B[t][n]
  float* Cs = Bs + kQ * nr;             // [kQ][nr]: C[t][n]
  float* Xs = Cs + kQ * nr;             // [kQ][kPB]: x
  float* Gs = Xs + kQ * kPB;            // [kQ][kPB]: gy
  float* dts = Gs + kQ * kPB;           // [kQ]: dt
  float* eas = dts + kQ;                // [kQ]: exp(dt A)
  float* gux = eas + kQ;                // [kQ]: <gu, x> over the CTA's columns
  float* GU = gux + kQ;                 // [nw][kHalf][kPB]: a warp's rows of gu
  float* CG = GU + nw * kHalf * kPB;    // [nw][kQ]: a warp's rows of C gC
  float* red = CG + nw * kQ;            // [nw]: a warp's rows of <h, lam>

  const int pb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int p0 = pb * kPB;
  const int n = threadIdx.x, lane = n & 31, warp = n >> 5;
  const bool row = n < N;
  const float Ah = A[h];
  const long long bh = (long long)b * H + h;

  float lam[kPB], hs[kPB];
#pragma unroll
  for (int p = 0; p < kPB; ++p)
    lam[p] = g_hlast != nullptr && row && p0 + p < P
                 ? g_hlast[(bh * N + n) * P + p0 + p] : 0.f;
  float decay_next = 1.f;         // exp(a_{t+1}) of the step after this one

  for (int c = chunks - 1; c >= 0; --c) {
    const int t0 = c * kQ;
    __syncthreads();              // the previous chunk's shared memory is read
    for (int e = n; e < kQ * nr; e += nr) {
      const int i = e / nr, m = e - i * nr, t = t0 + i;
      const bool valid = t < S && m < N;
      Bs[e] = valid ? Bm[b * sbb + t * sbs + m] : 0.f;
      Cs[e] = valid ? Cm[b * scb + t * scs + m] : 0.f;
    }
    for (int e = n; e < kQ * kPB; e += nr) {
      const int i = e / kPB, p = e - i * kPB, t = t0 + i;
      const bool valid = t < S && p0 + p < P;
      Xs[e] = valid ? x[b * sxb + t * sxs + (long long)h * P + p0 + p] : 0.f;
      Gs[e] = valid ? gy[(((long long)b * S + t) * H + h) * P + p0 + p] : 0.f;
    }
    for (int i = n; i < kQ; i += nr) {
      const int t = t0 + i;
      const float d = t < S ? dt[b * sdb + t * sds + h] : 0.f;
      dts[i] = d;
      eas[i] = expf(d * Ah);
    }
    __syncthreads();

    // 1. h_t from the state entering the chunk: gC_t and C_t gC_t.
    const float* hin = states + ((bh * chunks + c) * N + n) * P + p0;
#pragma unroll
    for (int p = 0; p < kPB; ++p) hs[p] = row && p0 + p < P ? hin[p] : 0.f;
    for (int i = 0; i < kQ; ++i) {
      const float e = eas[i], bu = Bs[i * nr + n] * dts[i];   // B_t[n] dt_t
      const float4* x4 = reinterpret_cast<const float4*>(Xs + i * kPB);
      const float4* g4 = reinterpret_cast<const float4*>(Gs + i * kPB);
      float gc = 0.f;
#pragma unroll
      for (int k = 0; k < kPB / 4; ++k) {
        const float4 xv = x4[k], g = g4[k];
        hs[4 * k] = fmaf(e, hs[4 * k], bu * xv.x);
        hs[4 * k + 1] = fmaf(e, hs[4 * k + 1], bu * xv.y);
        hs[4 * k + 2] = fmaf(e, hs[4 * k + 2], bu * xv.z);
        hs[4 * k + 3] = fmaf(e, hs[4 * k + 3], bu * xv.w);
        gc = fmaf(hs[4 * k], g.x, gc);
        gc = fmaf(hs[4 * k + 1], g.y, gc);
        gc = fmaf(hs[4 * k + 2], g.z, gc);
        gc = fmaf(hs[4 * k + 3], g.w, gc);
      }
      const int t = t0 + i;
      if (row && t < S)
        gC_part[((((long long)pb * batch + b) * S + t) * H + h) * N + n] = gc;
      const float cg = warp_sum(Cs[i * nr + n] * gc);
      if (lane == 0) CG[warp * kQ + i] = cg;
    }

    // 2. lam backwards through the chunk, half a chunk at a time: gB_t and
    //    each warp's rows of gu_t; <h, lam> at the chunk's last step (hs
    //    holds that step's h).  3. Then gu of that half summed over the
    //    warps (lane = column): gx and <gu, x>.
    for (int half = 1; half >= 0; --half) {
      for (int j = kHalf - 1; j >= 0; --j) {
        const int i = half * kHalf + j, t = t0 + i;
        const float cn = Cs[i * nr + n], bn = Bs[i * nr + n], d = dts[i];
        const float4* x4 = reinterpret_cast<const float4*>(Xs + i * kPB);
        const float4* g4 = reinterpret_cast<const float4*>(Gs + i * kPB);
        float gb = 0.f;
#pragma unroll
        for (int k = 0; k < kPB / 4; ++k) {
          const float4 xv = x4[k], g = g4[k];
          lam[4 * k] = fmaf(decay_next, lam[4 * k], cn * g.x);
          lam[4 * k + 1] = fmaf(decay_next, lam[4 * k + 1], cn * g.y);
          lam[4 * k + 2] = fmaf(decay_next, lam[4 * k + 2], cn * g.z);
          lam[4 * k + 3] = fmaf(decay_next, lam[4 * k + 3], cn * g.w);
          gb = fmaf(lam[4 * k], xv.x, gb);
          gb = fmaf(lam[4 * k + 1], xv.y, gb);
          gb = fmaf(lam[4 * k + 2], xv.z, gb);
          gb = fmaf(lam[4 * k + 3], xv.w, gb);
        }
        if (i == kQ - 1) {
          float q = 0.f;
#pragma unroll
          for (int p = 0; p < kPB; ++p) q = fmaf(hs[p], lam[p], q);
          q = warp_sum(q);
          if (lane == 0) red[warp] = q;
        }
        if (row && t < S)           // gB_t[n] = <lam_t[n], x_t> dt_t
          gB_part[((((long long)pb * batch + b) * S + t) * H + h) * N + n] =
              gb * d;
        // The warp's sum over its rows of lam[n][p] B[n], every column at
        // once: five folds leave lane l with column l in v[0].
        float v[kPB];
#pragma unroll
        for (int p = 0; p < kPB; ++p) v[p] = lam[p] * bn;
        fold<16>(v, lane);
        fold<8>(v, lane);
        fold<4>(v, lane);
        fold<2>(v, lane);
        fold<1>(v, lane);
        GU[(warp * kHalf + j) * kPB + lane] = v[0];
        decay_next = eas[i];
      }
      __syncthreads();
      for (int j = warp; j < kHalf; j += nw) {
        const int i = half * kHalf + j, t = t0 + i;
        float gu = 0.f;
        for (int w = 0; w < nw; ++w) gu += GU[(w * kHalf + j) * kPB + lane];
        if (t < S && p0 + lane < P)
          gx[(((long long)b * S + t) * H + h) * P + p0 + lane] = gu * dts[i];
        const float s = warp_sum(gu * Xs[i * kPB + lane]);
        if (lane == 0) gux[i] = s;
      }
      __syncthreads();              // GU is read; gux is written
    }

    // 4. ga_i = (q_end - cg_end) + sum_{r >= i} (cg_r - dt_r <gu_r, x_r>),
    //    by one warp, two steps a lane; then gdt = <gu, x> + ga A.
    if (warp == 0) {
      float q_end = 0.f, cg_end = 0.f, d[2];
      for (int w = 0; w < nw; ++w) {
        q_end += red[w];
        cg_end += CG[w * kQ + kQ - 1];
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int i = 2 * lane + k;
        float cg = 0.f;
        for (int w = 0; w < nw; ++w) cg += CG[w * kQ + i];
        d[k] = cg - dts[i] * gux[i];
      }
      float incl = d[0] + d[1];   // then: the sum over lanes >= this one
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_down_sync(kFull, incl, off);
        if (lane + off < 32) incl += o;
      }
      float after = __shfl_down_sync(kFull, incl, 1);
      if (lane == 31) after = 0.f;
      const float suffix1 = d[1] + after, suffix0 = d[0] + suffix1;
      const float base = q_end - cg_end;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int i = 2 * lane + k, t = t0 + i;
        const float ga = base + (k ? suffix1 : suffix0);
        if (t < S) {
          const long long o = (((long long)pb * batch + b) * S + t) * H + h;
          ga_part[o] = ga;
          gdt_part[o] = fmaf(ga, Ah, gux[i]);
        }
      }
    }
  }

  // g_h0 = exp(a_0) lam_0: decay_next holds chunk 0's first decay.
  if (g_h0 != nullptr && row) {
#pragma unroll
    for (int p = 0; p < kPB; ++p)
      if (p0 + p < P) g_h0[(bh * N + n) * P + p0 + p] = decay_next * lam[p];
  }
}

}  // namespace

// Plain C interface for ctypes: one launch on the given stream.  gdt_part
// and ga_part are (ceil(P / 32), B, S, H), gB_part and gC_part
// (ceil(P / 32), B, S, H, N): per 32 columns of P and per head, for the
// wrapper to sum.  g_hlast and g_h0 may be null.  Returns the first failing
// cudaError_t, else cudaSuccess.
extern "C" int ssd_scan_bwd_launch(
    const float* x, long long sxb, long long sxs, const float* dt,
    long long sdb, long long sds, const float* A, const float* Bm,
    long long sbb, long long sbs, const float* Cm, long long scb,
    long long scs, const float* gy, const float* states,
    const float* g_hlast, float* gx, float* gdt_part, float* ga_part,
    float* gB_part, float* gC_part, float* g_h0, int batch, int S, int H,
    int P, int N, void* stream) {
  if (batch <= 0 || H <= 0 || P <= 0) return (int)cudaSuccess;
  if (N <= 0 || N > kMaxRows || S < 0) return (int)cudaErrorInvalidValue;
  const int nr = (N + 31) / 32 * 32;
  const int chunks = (S + kQ - 1) / kQ;
  const int smem = (int)sizeof(float) * smem_floats(nr);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_kernel<<<dim3((P + kPB - 1) / kPB, H, batch), nr, smem,
                   (cudaStream_t)stream>>>(
      x, sxb, sxs, dt, sdb, sds, A, Bm, sbb, sbs, Cm, scb, scs, gy, states,
      g_hlast, gx, gdt_part, ga_part, gB_part, gC_part, g_h0, batch, S, H, P,
      N, chunks);
  return (int)cudaGetLastError();
}
