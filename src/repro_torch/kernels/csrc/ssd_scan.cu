// K5: the Mamba-2 SSD chunked scan (G = 1 group), for Hopper (sm_90a).
// Replaces repro/kernels/ssd_scan.py::ssd_scan_pallas (body _ssd_kernel).
//
//   a_t = dt_t A ,  xdt_t = dt_t x_t
//   h_t = exp(a_t) h_{t-1} + B_t xdt_t^T        (state h: N x P)
//   y_t = C_t h_t
//
// per (batch, head), seeded from h0 (or zero); the final state is written
// out (h_last).
//
// What bounds it: operations.  The function needs 4 N P flops a step
// (3.22 GFLOP at the Mamba2-130M prefill, B=4, S=1024, H=24, P=64, N=128)
// on 58 MB of inputs and outputs.  The design cuts the sequence into
// 64-step chunks (kQ) and follows the SSD algorithm's split (Dao & Gu
// 2024, "Transformers are SSMs", sec. 6: chunk state, state passing, chunk
// scan), in two launches:
//
//   1. state_scan_kernel, one CTA per (128 state rows of N, head, batch,
//      64 columns of P), fuses the chunk states and the state passing.
//      Its block of the state stays in registers while it walks the
//      chunks: for chunk c it writes the entering state h, computes the
//      chunk's own contribution S_c = B^T (xdt * exp(total - a_cum)), and
//      sets h = exp(total) h + S_c.  The next two chunks' B, x rows and dt
//      are copied (cp.async, three buffers) while one is computed.  h
//      starts from h0; the last h is h_last.  Only the entering states
//      reach device memory (50.3 MB at kQ = 64).  96 CTAs at the prefill
//      shape, one an SM: the walk of 16 chunk steps is the kernel's
//      latency, and it measured the same with the state cut into 32-row
//      blocks over 384 CTAs.
//   2. chunk_scan_kernel, one CTA per (chunk, group of heads, batch, 64
//      columns of P): y = exp(a_cum) * (C h_enter) + (C B^T * L) xdt, with
//      the decay mask L[i][j] = exp(a_cum_i - a_cum_j) for j <= i, else
//      0.  C and B do not depend on the head (G = 1), so a CTA copies them
//      and computes C B^T once for its group, then walks the heads; the
//      group is as large as still leaves two CTAs for every SM (6 heads,
//      256 CTAs at the prefill shape).  kQ = 64 keeps it at 104.5 KiB of
//      shared memory; kQ = 128 would halve the states but need a score
//      block four times as large.
//
// Tiles reach shared memory by cp.async (16 bytes a copy, zero-filled past
// S, N and P); the wrapper hands over x, B and C 16-byte aligned.
//
// The four products (C h, C B^T, M xdt, B^T X) run on the tensor cores
// in 3xTF32 (ssd_mma.cuh, shared with K5-bwd, says how and lays out the
// shared-memory rows against bank conflicts).  The cumulative decay, the
// masks and the exponentials stay in fp32.  mma.sync reaches only part of
// the TF32 rate that wgmma reaches (scripts/mma_sync_rate.cu measures it;
// PERF.md has the reading), and with the fragment loads and splits between
// products and the state scan's serial walk the kernel stays far from
// either.
//
// Inputs are read where they lie: x (B, S, H, P), dt (B, S, H) and B / C
// (B, S, N) with their batch and sequence strides, the inner dims dense.
// y is written as a dense (B, S, H, P), h0 and h_last are dense
// (B, H, N, P).  Steps past the sequence end (a ragged last chunk) are
// identities (a = 0, xdt = 0) and write no y.

#include "ssd_mma.cuh"

namespace {

constexpr int kPB = 64;           // columns of P one CTA computes
constexpr int kThreads = 256;     // 8 warps a CTA
constexpr int kLdP = kPB + 8;     // rows of xdt and of the state (8 mod 32)
constexpr int kLdM = kQ + 4;      // rows of the masked scores (4 mod 32)
constexpr int kNB = 128;          // state rows (of N) one state-scan CTA owns
constexpr int kLdNB = kNB + 8;    // rows of its block of B (8 mod 32)
constexpr int kStages = 3;        // chunks a state-scan CTA has in flight

// kQ rows of a (B, S, N) matrix from step t0, columns [0, np) (zero past S
// and past N) into dst with row stride ld, by all threads of the CTA.
__device__ __forceinline__ void copy_rows(float* dst, int ld,
                                          const float* m, long long sb,
                                          long long ss, int b, int t0, int S,
                                          int N, int np, int tid) {
  for (int e = tid; e < kQ * (np / 4); e += kThreads) {
    const int i = e / (np / 4), n = 4 * (e - i * (np / 4)), t = t0 + i;
    const bool valid = t < S && n < N;
    copy16(dst + i * ld + n, valid ? m + b * sb + t * ss + n : m, valid);
  }
}

// The chunk's x rows, columns [p0, p0 + kPB) of head h (zero past S and
// P), into Xs; scaled by dt (and the decays) once those are known.
__device__ __forceinline__ void copy_x(float* Xs, const float* x,
                                       long long sxb, long long sxs, int b,
                                       int h, int t0, int S, int P, int p0,
                                       int tid) {
  for (int e = tid; e < kQ * (kPB / 4); e += kThreads) {
    const int j = e / (kPB / 4), p = 4 * (e - j * (kPB / 4)), t = t0 + j;
    const bool valid = t < S && p0 + p < P;
    copy16(Xs + j * kLdP + p,
           valid ? x + b * sxb + t * sxs + (long long)h * P + p0 + p : x,
           valid);
  }
}

// Xs[j][:] *= scale[j] for the chunk's kQ rows.
__device__ __forceinline__ void scale_rows(float* Xs, const float* scale,
                                           int tid) {
  for (int e = tid; e < kQ * (kPB / 4); e += kThreads) {
    const int j = e / (kPB / 4), p = 4 * (e - j * (kPB / 4));
    float4* v = reinterpret_cast<float4*>(Xs + j * kLdP + p);
    const float d = scale[j];
    const float4 o = *v;
    *v = make_float4(o.x * d, o.y * d, o.z * d, o.w * d);
  }
}

// ---- the chunk's decays -----------------------------------------------------

// kQ values of dt for head h from step t0 (zero past S) into d, by the
// first kQ threads.
__device__ __forceinline__ void copy_dt(float* d, const float* dt,
                                        long long sdb, long long sds, int b,
                                        int h, int t0, int S, int tid) {
  if (tid < kQ) {
    const bool valid = t0 + tid < S;
    copy4(d + tid, valid ? dt + b * sdb + (t0 + tid) * sds + h : dt, valid);
  }
}

// ---- steps 1 and 2: the state that enters each chunk ----------------------

// Shared memory of one state-scan CTA, in floats: kStages buffers of a
// chunk's B block, x rows and dt, then the chunk's input scales and total.
__host__ __device__ constexpr int state_smem_floats() {
  return kStages * (kQ * kLdNB + kQ * kLdP + kQ) + kQ + 4;
}

__global__ void __launch_bounds__(kThreads, 1)
state_scan_kernel(const float* __restrict__ x, long long sxb, long long sxs,
                  const float* __restrict__ dt, long long sdb, long long sds,
                  const float* __restrict__ A,
                  const float* __restrict__ Bm, long long sbb, long long sbs,
                  const float* __restrict__ h0, float* __restrict__ states,
                  float* __restrict__ h_last, int S, int H, int P, int N,
                  int chunks) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kBSize = kQ * kLdNB, kXSize = kQ * kLdP;
  float* Bbuf = smem;                        // [kStages][kBSize]: B[j][n0 + n]
  float* Xbuf = Bbuf + kStages * kBSize;     // [kStages][kXSize]: x, scaled
  float* Dbuf = Xbuf + kStages * kXSize;     // [kStages][kQ]: dt
  float* scale = Dbuf + kStages * kQ;
  float* total = scale + kQ;

  const int n0 = blockIdx.x * kNB, h = blockIdx.y;
  const int npb = (P + kPB - 1) / kPB;
  const int b = blockIdx.z / npb, pb = blockIdx.z % npb;
  const int p0 = pb * kPB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float Ah = A[h];

  // Chunk c's B block, x rows and dt into buffer `buf`, as one group (an
  // empty group past the last chunk, so that every wait counts alike).
  auto issue = [&](int c, int buf) {
    if (c < chunks) {
      const int t0 = c * kQ;
      float* Bb = Bbuf + buf * kBSize;
      for (int e = tid; e < kQ * (kNB / 4); e += kThreads) {
        const int j = e / (kNB / 4), n = 4 * (e - j * (kNB / 4)), t = t0 + j;
        const bool valid = t < S && n0 + n < N;
        copy16(Bb + j * kLdNB + n,
               valid ? Bm + b * sbb + t * sbs + n0 + n : Bm, valid);
      }
      copy_x(Xbuf + buf * kXSize, x, sxb, sxs, b, h, t0, S, P, p0, tid);
      copy_dt(Dbuf + buf * kQ, dt, sdb, sds, b, h, t0, S, tid);
    }
    copies_commit();
  };

  // The state block (kNB x kPB) lives in registers: warp w owns rows
  // 32 (w / 2) .. +32 and columns 32 (w % 2) .. +32, as 2 x 4 mma tiles.
  const int g = lane >> 2, tq = lane & 3;
  const int wr = 32 * (warp >> 1), wc = 32 * (warp & 1);
  const long long bh = (long long)b * H + h;
  float hs[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + wr + 16 * mt + g + 8 * (e >> 1);
        const int p = p0 + wc + 8 * nt + 2 * tq + (e & 1);
        hs[mt][nt][e] = h0 != nullptr && n < N && p < P
                            ? h0[(bh * N + n) * P + p] : 0.f;
      }
  auto store_state = [&](float* dst) {        // dst: a dense (N, P) state
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int p = p0 + wc + 8 * nt + 2 * tq;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int n = n0 + wr + 16 * mt + g + 8 * half;
          if (n < N && p < P)
            *reinterpret_cast<float2*>(dst + (long long)n * P + p) =
                make_float2(hs[mt][nt][2 * half], hs[mt][nt][2 * half + 1]);
        }
      }
  };

#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) issue(k, k);
  for (int c = 0; c < chunks; ++c) {
    const int buf = c % kStages;
    // Chunk c + kStages - 1 is copied while this one is computed.
    issue(c + kStages - 1, (c + kStages - 1) % kStages);
    copies_wait_group<kStages - 1>();
    __syncthreads();
    if (warp == 0) {
      // a_cum from this chunk's dt (0 past S); the scale of x_j in the state
      // the chunk leaves is dt_j exp(total - a_cum_j).
      const float* d = Dbuf + buf * kQ;
      float cum[2];
      const float tot = warp_cumsum(d, Ah, lane, cum);
      scale[2 * lane] = d[2 * lane] * expf(tot - cum[0]);
      scale[2 * lane + 1] = d[2 * lane + 1] * expf(tot - cum[1]);
      if (lane == 0) *total = tot;
    }
    store_state(states + (bh * chunks + c) * N * P);   // the entering state
    __syncthreads();
    scale_rows(Xbuf + buf * kXSize, scale, tid);
    __syncthreads();
    // S_c = B^T X: a(m = n, k = j) = B[j * kLdNB + n],
    // b(k = j, n = p) = X[j * kLdP + p].
    float acc[2][4][4] = {};
    warp_gemm<2, 4>(acc, Bbuf + buf * kBSize + wr, 1, kLdNB,
                    Xbuf + buf * kXSize + wc, kLdP, 1, kQ / 8, lane);
    const float et = expf(*total);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          hs[mt][nt][e] = fmaf(et, hs[mt][nt][e], acc[mt][nt][e]);
    __syncthreads();                // buffer free for chunk c + kStages
  }
  store_state(h_last + bh * N * P);
}

// ---- step 3: the chunks' outputs -------------------------------------------

// Shared memory of one chunk_scan CTA, in floats: C, then B (later a
// head's entering state in its place), xdt, the masked scores, the dt and
// a_cum of one head.
__host__ __device__ constexpr int scan_smem_floats(int np) {
  return kQ * (np + 4) +
         (np * kLdP > kQ * (np + 4) ? np * kLdP : kQ * (np + 4)) +
         kQ * kLdP + kQ * kLdM + 2 * kQ;
}

// One CTA per (chunk, group of heads, batch, 64 columns of P), two an SM.
// C and B are the same for every head (G = 1): the CTA copies them once
// and keeps each warp's tile of C B^T in registers, then walks its heads.
__global__ void __launch_bounds__(kThreads, 2)
chunk_scan_kernel(const float* __restrict__ x, long long sxb, long long sxs,
                  const float* __restrict__ dt, long long sdb, long long sds,
                  const float* __restrict__ A,
                  const float* __restrict__ Bm, long long sbb, long long sbs,
                  const float* __restrict__ Cm, long long scb, long long scs,
                  const float* __restrict__ states, float* __restrict__ y,
                  int S, int H, int P, int N, int chunks, int heads_per_cta) {
  extern __shared__ __align__(16) float smem[];
  const int np = round_up(N, 32);
  const int ldc = np + 4;                    // 4 mod 32
  const int r1 = np * kLdP > kQ * ldc ? np * kLdP : kQ * ldc;
  float* Cs = smem;                          // Cs[i * ldc + n] = C[i][n]
  float* Bs = Cs + kQ * ldc;                 // Bs[j * ldc + n] = B[j][n]
  float* Hs = Bs;                            // later Hs[n * kLdP + p] = h_enter[n][p]
  float* Xs = Bs + r1;                       // Xs[j * kLdP + p] = xdt[j][p]
  float* Ms = Xs + kQ * kLdP;                // Ms[i * kLdM + j] = (C B^T * L)[i][j]
  float* dts = Ms + kQ * kLdM;
  float* acum = dts + kQ;

  const int c = blockIdx.x;
  const int h_begin = blockIdx.y * heads_per_cta;
  const int h_end = min(H, h_begin + heads_per_cta);
  const int npb = (P + kPB - 1) / kPB;
  const int b = blockIdx.z / npb, pb = blockIdx.z % npb;
  const int p0 = pb * kPB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = c * kQ;

  // Warp w owns rows r0..r0+15 and columns c0..c0+31 of C B^T, M and y.
  const int r0 = 16 * (warp >> 1), c0 = 32 * (warp & 1);
  const int g = lane >> 2, tq = lane & 3;

  copy_rows(Cs, ldc, Cm, scb, scs, b, t0, S, N, np, tid);
  copy_rows(Bs, ldc, Bm, sbb, sbs, b, t0, S, N, np, tid);
  copies_wait();
  __syncthreads();
  // Scores C B^T; the tiles above the diagonal are masked to zero anyway.
  float sacc[1][4][4] = {};
  if (c0 <= r0 + 15)
    // a(m = i, k = n) = Cs[i * ldc + n]; b(k = n, n = j) = Bs[j * ldc + n]
    warp_gemm<1, 4>(sacc, Cs + r0 * ldc, ldc, 1, Bs + c0 * ldc, 1, ldc,
                    np / 8, lane);
  __syncthreads();                           // B is read

  for (int h = h_begin; h < h_end; ++h) {
    // The head's x rows, entering state and dt.
    copy_x(Xs, x, sxb, sxs, b, h, t0, S, P, p0, tid);
    const float* hin = states + (((long long)b * H + h) * chunks + c) * N * P;
    for (int e = tid; e < np * (kPB / 4); e += kThreads) {
      const int n = e / (kPB / 4), p = 4 * (e - n * (kPB / 4));
      const bool valid = n < N && p0 + p < P;
      copy16(Hs + n * kLdP + p, valid ? hin + (long long)n * P + p0 + p : hin,
             valid);
    }
    copy_dt(dts, dt, sdb, sds, b, h, t0, S, tid);
    copies_wait();
    __syncthreads();
    if (warp == 0) {
      float cum[2];
      warp_cumsum(dts, A[h], lane, cum);
      acum[2 * lane] = cum[0];
      acum[2 * lane + 1] = cum[1];
    }
    __syncthreads();
    scale_rows(Xs, dts, tid);                // xdt
    // M = C B^T * L for this head's decays.
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = r0 + g + 8 * half, j = c0 + 8 * nt + 2 * tq;
        const float ai = acum[i];
        const float m0 =
            j <= i ? sacc[0][nt][2 * half] * expf(ai - acum[j]) : 0.f;
        const float m1 = j + 1 <= i
                             ? sacc[0][nt][2 * half + 1] * expf(ai - acum[j + 1])
                             : 0.f;
        *reinterpret_cast<float2*>(Ms + i * kLdM + j) = make_float2(m0, m1);
      }
    __syncthreads();

    // y = M xdt over j <= i (k steps up to the warp's last row)
    //   + exp(a_cum) * (C h_enter).
    float yacc[1][4][4] = {};
    // a(m = i, k = j) = Ms[i * kLdM + j]; b(k = j, n = p) = Xs[j * kLdP + p]
    warp_gemm<1, 4>(yacc, Ms + r0 * kLdM, kLdM, 1, Xs + c0, kLdP, 1,
                    (r0 + 16) / 8, lane);
    float iacc[1][4][4] = {};
    // a(m = i, k = n) = Cs[i * ldc + n]; b(k = n, n = p) = Hs[n * kLdP + p]
    warp_gemm<1, 4>(iacc, Cs + r0 * ldc, ldc, 1, Hs + c0, kLdP, 1, np / 8,
                    lane);
    const float d0 = expf(acum[r0 + g]), d1 = expf(acum[r0 + g + 8]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int p = p0 + c0 + 8 * nt + 2 * tq;
      if (p >= P) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = t0 + r0 + g + 8 * half;
        const float d = half ? d1 : d0;
        if (t < S)
          *reinterpret_cast<float2*>(
              y + (((long long)b * S + t) * H + h) * P + p) =
              make_float2(
                  fmaf(d, iacc[0][nt][2 * half], yacc[0][nt][2 * half]),
                  fmaf(d, iacc[0][nt][2 * half + 1],
                       yacc[0][nt][2 * half + 1]));
      }
    }
    __syncthreads();                         // before the next head's copies
  }
}

}  // namespace

// Plain C interface for ctypes: the two launches on one stream.  states
// is B*H*chunks*N*P floats of scratch (chunks = ceil(S / 64)), the state
// entering each chunk.  Returns the first failing cudaError_t, else
// cudaSuccess.
extern "C" int ssd_scan_launch(const float* x, long long sxb, long long sxs,
                               const float* dt, long long sdb, long long sds,
                               const float* A, const float* Bm, long long sbb,
                               long long sbs, const float* Cm, long long scb,
                               long long scs, const float* h0, float* y,
                               float* h_last, float* states, int batch, int S,
                               int H, int P, int N, void* stream) {
  if (batch <= 0 || H <= 0) return (int)cudaSuccess;
  if (P <= 0 || N <= 0 || (P & 3) || (N & 3) || S < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int chunks = (S + kQ - 1) / kQ;
  const int np = round_up(N, 32);
  const int npb = (P + kPB - 1) / kPB;
  const int smem1 = (int)sizeof(float) * state_smem_floats();
  cudaError_t err = cudaFuncSetAttribute(
      state_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return (int)err;
  state_scan_kernel<<<dim3((N + kNB - 1) / kNB, H, batch * npb), kThreads,
                      smem1, st>>>(x, sxb, sxs, dt, sdb, sds, A, Bm, sbb, sbs,
                                   h0, states, h_last, S, H, P, N, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 0) return (int)err;
  const int smem2 = (int)sizeof(float) * scan_smem_floats(np);
  err = cudaFuncSetAttribute(chunk_scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem2);
  if (err != cudaSuccess) return (int)err;
  // Heads per CTA: as many as still leave two CTAs for every SM.
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long per_head = (long long)chunks * batch * npb;
  int hg = (int)((per_head * H + 2LL * sms - 1) / (2LL * sms));
  hg = hg < 1 ? 1 : (hg > H ? H : hg);
  const int groups = (H + hg - 1) / hg;
  chunk_scan_kernel<<<dim3(chunks, groups, batch * npb), kThreads, smem2,
                      st>>>(x, sxb, sxs, dt, sdb, sds, A, Bm, sbb, sbs, Cm,
                            scb, scs, states, y, S, H, P, N, chunks, hg);
  return (int)cudaGetLastError();
}
