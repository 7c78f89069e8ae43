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
// What bounds it on an H100: operations.  The function needs 10 N P flops a
// step (8.05 GFLOP at the training shape B=4, S=1024, H=24, P=64, N=128)
// against 0.14 GB of inputs read and gradients written.  The design is K5's
// chunk-parallel form run backwards, in two launches over 64-step chunks,
// every product on the tensor cores in 3xTF32 (ssd_mma.cuh).  In a chunk c,
// with a_cum the chunk's cumulative a, total its last entry,
// L[i][j] = exp(a_cum_i - a_cum_j) for j <= i (else 0),
// dout_j = exp(total - a_cum_j), H0_c the state entering the chunk (K5's
// `states`) and G_c the gradient of the state leaving it:
//
//   1. state_bwd_kernel, the mirror of K5's state scan: one CTA per (128
//      state rows, head, batch, 64 columns of P) walks the chunks from the
//      last, G in registers (G_last = g_hlast, or 0):
//        G_{c-1} = exp(total_c) G_c + C^T diag(exp(a_cum)) gy .
//      It writes each G_c, g_h0 = G_{-1}, and its block's part of each
//      chunk's exp(total_c) <H0_c, G_c>, summed over its warps in a fixed
//      order.
//   2. chunk_bwd_kernel, the mirror of K5's chunk scan: one CTA per (chunk,
//      128 state rows, group of heads, batch, 64 columns of P), every chunk
//      at once.  B and C do not depend on the head (G = 1): the CTA copies
//      them and computes C B^T once, then walks its heads.  With
//      M = (C B^T) * L and W = (gy u^T) * L, for each head:
//        gu = M^T gy + diag(dout) B G_c ,   gx = gu dt ,
//        gB = W^T C + diag(dout) u G_c^T ,
//        gC = W B + diag(exp(a_cum)) gy H0_c^T .
//      gB and gC are summed over the CTA's heads inside the kernel: the
//      G_c and H0_c terms accumulate in registers head by head, and W B and
//      W^T C are taken once, from the sum of the heads' W (B and C are the
//      heads' own).  ga needs no state walk: splitting h_{i-1} and lam_i of
//      ga_i = exp(a_i) <h_{i-1}, lam_i> into their H0_c / G_c parts and
//      their in-chunk parts,
//        ga_i = exp(total) <H0_c, G_c> + sum_{r >= i} <C_r, T_r>
//               + sum_{r >= i, j < i} E[r][j] + sum_{j < i} v_j ,
//      with T = diag(exp(a_cum)) gy H0_c^T (gC's state term), E = W * C B^T
//      and v_j = dout_j dt_j <x_j, (B G_c)_j>: a suffix, the sums of E's
//      rectangles below and left of the diagonal (each row's exclusive
//      prefix, then each column's sum from the diagonal down) and a prefix,
//      all in fp32 on the CUDA cores.  No term cancels another: the
//      shorter identity ga_i = q_i - <u_i, gu_i> with q_{i-1} =
//      <C_{i-1}, gC_{i-1}> + ga_i takes each rectangle as the difference of
//      two sums that share the diagonal, and that rounding, alike for every
//      step of a chunk, adds up in gA = sum ga dt instead of averaging out.
//      It is 211 KiB of shared memory and 512 threads, one CTA an SM: the
//      heads' sums of gB and gC take 32 registers a thread at 16 warps,
//      where 8 warps (two CTAs an SM) would need 64.
//
// Everything above is linear in each of the two blocks a CTA owns (its
// state rows, its columns of P), so a CTA's products are its block's part
// of every sum: gx is written per block of state rows, ga and gdt per
// (state rows, columns) block, gB and gC per (columns, group of heads), and
// the wrapper adds the parts in a fixed order.  At the training shape there
// is one block of each (N = 128, P = 64): only gB and gC have parts, one a
// group of heads.  No atomics: each output element has one writer, and the
// gradients repeat bit for bit.  Every decay is exp of a non-positive
// number (dt >= 0, A < 0), nothing is divided by a decay, and L is masked
// before its exp.
//
// Inputs are read where they lie: x (B, S, H, P) and B / C (B, S, N) with
// their batch and sequence strides, the inner dims dense, dt (B, S, H) with
// H dense; gy is a dense (B, S, H, P), states and gstates dense
// (B, H, chunks, N, P), g_hlast and g_h0 dense (B, H, N, P); x, B,
// C, gy and the states 16-byte aligned.  Steps past S are identities
// (dt = 0, u = gy = B = C = 0) and write nothing.

#include "ssd_mma.cuh"

namespace {

constexpr int kPB = 64;           // columns of P a CTA owns
constexpr int kNB = 128;          // state rows (of N) a CTA owns

// ---- launch 1: the reverse state pass ---------------------------------------

constexpr int kStateThreads = 256;  // 8 warps
constexpr int kLdNB = kNB + 8;      // rows of a chunk's C block (8 mod 32)
constexpr int kLdP = kPB + 8;       // rows of a chunk's gy columns (8 mod 32)
constexpr int kStages = 3;          // chunks in flight

// Shared memory of one state_bwd CTA, in floats: kStages buffers of a
// chunk's C block, gy columns and dt, then the chunk's scales, its total
// and the warps' parts of <H0, G>.
__host__ __device__ constexpr int state_bwd_smem_floats() {
  return kStages * (kQ * kLdNB + kQ * kLdP + kQ) + kQ + 4 +
         kStateThreads / 32;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__global__ void __launch_bounds__(kStateThreads, 1)
state_bwd_kernel(const float* __restrict__ dt, long long sdb, long long sds,
                 const float* __restrict__ A,
                 const float* __restrict__ Cm, long long scb, long long scs,
                 const float* __restrict__ gy,
                 const float* __restrict__ states,
                 const float* __restrict__ g_hlast,
                 float* __restrict__ gstates, float* __restrict__ base,
                 float* __restrict__ g_h0, int batch, int S, int H, int P,
                 int N, int chunks) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kCSize = kQ * kLdNB, kGSize = kQ * kLdP;
  float* Cbuf = smem;                        // [kStages][kCSize]: C[j][n0 + n]
  float* Gbuf = Cbuf + kStages * kCSize;     // [kStages][kGSize]: gy, scaled
  float* Dbuf = Gbuf + kStages * kGSize;     // [kStages][kQ]: dt
  float* scale = Dbuf + kStages * kQ;        // [kQ]: exp(a_cum)
  float* total = scale + kQ;
  float* red = total + 4;                    // [warps]: parts of <H0, G>

  const int nb = blockIdx.x, n0 = nb * kNB, h = blockIdx.y;
  const int npb = (P + kPB - 1) / kPB;
  const int b = blockIdx.z / npb, pb = blockIdx.z % npb;
  const int p0 = pb * kPB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float Ah = A[h];
  const long long bh = (long long)b * H + h;

  // Chunk c's C block, gy columns and dt into buffer `buf`, as one group
  // (an empty group before the first chunk, so that every wait counts
  // alike).
  auto issue = [&](int c, int buf) {
    if (c >= 0) {
      const int t0 = c * kQ;
      float* Cb = Cbuf + buf * kCSize;
      for (int e = tid; e < kQ * (kNB / 4); e += kStateThreads) {
        const int j = e / (kNB / 4), n = 4 * (e - j * (kNB / 4)), t = t0 + j;
        const bool valid = t < S && n0 + n < N;
        copy16(Cb + j * kLdNB + n,
               valid ? Cm + b * scb + t * scs + n0 + n : Cm, valid);
      }
      float* Gb = Gbuf + buf * kGSize;
      for (int e = tid; e < kQ * (kPB / 4); e += kStateThreads) {
        const int j = e / (kPB / 4), p = 4 * (e - j * (kPB / 4)), t = t0 + j;
        const bool valid = t < S && p0 + p < P;
        copy16(Gb + j * kLdP + p,
               valid ? gy + (((long long)b * S + t) * H + h) * P + p0 + p
                     : gy,
               valid);
      }
      if (tid < kQ) {
        const bool valid = t0 + tid < S;
        copy4(Dbuf + buf * kQ + tid,
              valid ? dt + b * sdb + (t0 + tid) * sds + h : dt, valid);
      }
    }
    copies_commit();
  };

  // The gradient block (kNB x kPB) lives in registers: warp w owns rows
  // 32 (w / 2) .. +32 and columns 32 (w % 2) .. +32, as 2 x 4 mma tiles.
  const int g = lane >> 2, tq = lane & 3;
  const int wr = 32 * (warp >> 1), wc = 32 * (warp & 1);
  float gs[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + wr + 16 * mt + g + 8 * (e >> 1);
        const int p = p0 + wc + 8 * nt + 2 * tq + (e & 1);
        gs[mt][nt][e] = g_hlast != nullptr && n < N && p < P
                            ? g_hlast[(bh * N + n) * P + p] : 0.f;
      }
  // dst / src: a dense (N, P) state.
  auto store_block = [&](float* dst) {
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
                make_float2(gs[mt][nt][2 * half], gs[mt][nt][2 * half + 1]);
        }
      }
  };
  // The thread's elements of a chunk's entering state H0_c, loaded one
  // chunk ahead (zero past N and P), and their products with G.
  float2 hv[2][4][2];
  auto load_block = [&](const float* src) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int p = p0 + wc + 8 * nt + 2 * tq;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int n = n0 + wr + 16 * mt + g + 8 * half;
          hv[mt][nt][half] =
              n < N && p < P
                  ? *reinterpret_cast<const float2*>(src + (long long)n * P +
                                                     p)
                  : make_float2(0.f, 0.f);
        }
      }
  };
  auto dot_block = [&]() {
    float s = 0.f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          s = fmaf(hv[mt][nt][half].x, gs[mt][nt][2 * half], s);
          s = fmaf(hv[mt][nt][half].y, gs[mt][nt][2 * half + 1], s);
        }
    return s;
  };

#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) issue(chunks - 1 - k, k);
  if (chunks > 0) load_block(states + (bh * chunks + chunks - 1) * N * P);
  for (int k = 0; k < chunks; ++k) {
    const int c = chunks - 1 - k, buf = k % kStages;
    // Chunk c - kStages + 1 is copied while this one is computed.
    issue(c - (kStages - 1), (k + kStages - 1) % kStages);
    copies_wait_group<kStages - 1>();
    __syncthreads();
    if (warp == 0) {
      float cum[2];
      const float tot = warp_cumsum(Dbuf + buf * kQ, Ah, lane, cum);
      scale[2 * lane] = expf(cum[0]);
      scale[2 * lane + 1] = expf(cum[1]);
      if (lane == 0) *total = tot;
    }
    // G_c out, the block's part of <H0_c, G_c>, then H0_{c-1}'s loads.
    store_block(gstates + (bh * chunks + c) * N * P);
    const float part = warp_sum(dot_block());
    if (lane == 0) red[warp] = part;
    if (c > 0) load_block(states + (bh * chunks + c - 1) * N * P);
    __syncthreads();
    float* Gb = Gbuf + buf * kGSize;
    for (int e = tid; e < kQ * (kPB / 4); e += kStateThreads) {
      const int j = e / (kPB / 4), p = 4 * (e - j * (kPB / 4));
      float4* v = reinterpret_cast<float4*>(Gb + j * kLdP + p);
      const float s = scale[j];
      const float4 o = *v;
      *v = make_float4(o.x * s, o.y * s, o.z * s, o.w * s);
    }
    if (tid == 0) {
      float s = 0.f;
      for (int w = 0; w < kStateThreads / 32; ++w) s += red[w];
      base[(((long long)(nb * npb + pb) * batch + b) * H + h) * chunks + c] =
          expf(*total) * s;
    }
    __syncthreads();
    // C^T diag(exp(a_cum)) gy: a(m = n, k = j) = C[j * kLdNB + n],
    // b(k = j, n = p) = gy'[j * kLdP + p].
    float acc[2][4][4] = {};
    warp_gemm<2, 4>(acc, Cbuf + buf * kCSize + wr, 1, kLdNB, Gb + wc, kLdP, 1,
                    kQ / 8, lane);
    const float et = expf(*total);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          gs[mt][nt][e] = fmaf(et, gs[mt][nt][e], acc[mt][nt][e]);
    __syncthreads();                // buffer free for chunk c - kStages
  }
  if (g_h0 != nullptr) store_block(g_h0 + bh * N * P);
}

// ---- launch 2: every chunk at once ------------------------------------------

constexpr int kChunkThreads = 512;  // 16 warps
constexpr int kParts = kChunkThreads / kQ;   // threads that sum one column
constexpr int kLdC = kNB + 4;       // rows of C and B (4 mod 32)
constexpr int kLdX = kPB + 4;       // rows of x, gy and H0 (4 mod 32)
constexpr int kLdG = kPB + 8;       // rows of G (8 mod 32)
constexpr int kLdM = kQ + 8;        // rows of M and of the summed W (8 mod 32)
constexpr int kLdE = kQ + 4;        // rows of E (4 mod 32)
constexpr int kVecs = 5 + 3 * 4 + kParts;   // per-step vectors of a head

// Shared memory of one chunk_bwd CTA, in floats: C, B, x, gy, G_c, H0_c, M
// (the summed W at the end), E and the head's per-step vectors.
__host__ __device__ constexpr int chunk_bwd_smem_floats() {
  return 2 * kQ * kLdC + 2 * kQ * kLdX + kNB * kLdG + kNB * kLdX +
         kQ * kLdM + kQ * kLdE + kVecs * kQ;
}

// v summed over the four lanes of a quad (the lanes that hold one row of an
// mma tile), in the same order in each.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

__global__ void __launch_bounds__(kChunkThreads, 1)
chunk_bwd_kernel(const float* __restrict__ x, long long sxb, long long sxs,
                 const float* __restrict__ dt, long long sdb, long long sds,
                 const float* __restrict__ A,
                 const float* __restrict__ Bm, long long sbb, long long sbs,
                 const float* __restrict__ Cm, long long scb, long long scs,
                 const float* __restrict__ gy,
                 const float* __restrict__ states,
                 const float* __restrict__ gstates,
                 const float* __restrict__ base, float* __restrict__ gx,
                 float* __restrict__ gdt_part, float* __restrict__ ga_part,
                 float* __restrict__ gB_part, float* __restrict__ gC_part,
                 int batch, int S, int H, int P, int N, int chunks,
                 int heads_per_cta) {
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;                    // [kQ][kLdC]: C[i][n0 + n]
  float* Bs = Cs + kQ * kLdC;          // [kQ][kLdC]: B[j][n0 + n]
  float* Xs = Bs + kQ * kLdC;          // [kQ][kLdX]: x[j][p0 + p]
  float* Ys = Xs + kQ * kLdX;          // [kQ][kLdX]: gy[i][p0 + p]
  float* Gs = Ys + kQ * kLdX;          // [kNB][kLdG]: G_c[n0 + n][p0 + p]
  float* Hs = Gs + kNB * kLdG;         // [kNB][kLdX]: H0_c[n0 + n][p0 + p]
  float* Ms = Hs + kNB * kLdX;         // [kQ][kLdM]: M[r][i]; at the end W
  float* Es = Ms + kQ * kLdM;          // [kQ][kLdE]: E[r][j], then its row
                                       // prefixes F[r][i] = sum_{j<i} E[r][j]
  float* dts = Es + kQ * kLdE;         // [kQ]: dt
  float* acum = dts + kQ;              // [kQ]: a_cum
  float* ea = acum + kQ;               // [kQ]: exp(a_cum)
  float* dout = ea + kQ;               // [kQ]: exp(total - a_cum)
  float* ddo = dout + kQ;              // [kQ]: dt exp(total - a_cum)
  float* pc = ddo + kQ;                // [4][kQ]: rows of <C, T>
  float* pu = pc + 4 * kQ;             // [4][kQ]: rows of <x, gu>
  float* pv = pu + 4 * kQ;             // [4][kQ]: rows of <x, B G_c>
  float* pf = pv + 4 * kQ;             // [kParts][kQ]: columns of F

  const int npb = (P + kPB - 1) / kPB;
  const int c = blockIdx.x % chunks, nb = blockIdx.x / chunks;
  const int grp = blockIdx.y, groups = gridDim.y;
  const int b = blockIdx.z / npb, pb = blockIdx.z % npb;
  const int n0 = nb * kNB, p0 = pb * kPB, t0 = c * kQ;
  const int h_begin = grp * heads_per_cta;
  const int h_end = min(H, h_begin + heads_per_cta);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  // Warp w owns rows r0..r0+15 of every tile, and in column block
  // wb = w % 4 the columns wq..wq+15 of the kQ x kQ and kQ x kPB tiles and
  // wn..wn+31 of the kQ x kNB tiles.
  const int wb = warp & 3, r0 = 16 * (warp >> 2);
  const int wq = 16 * wb, wn = 32 * wb;
  const int nk = round_up(min(kNB, N - n0), 8) / 8;   // k steps over rows
  const long long pidx = (long long)nb * npb + pb;  // (rows, columns) block

  for (int e = tid; e < kQ * (kNB / 4); e += kChunkThreads) {
    const int i = e / (kNB / 4), n = 4 * (e - i * (kNB / 4)), t = t0 + i;
    const bool valid = t < S && n0 + n < N;
    copy16(Cs + i * kLdC + n, valid ? Cm + b * scb + t * scs + n0 + n : Cm,
           valid);
    copy16(Bs + i * kLdC + n, valid ? Bm + b * sbb + t * sbs + n0 + n : Bm,
           valid);
  }
  copies_commit();
  copies_wait();
  __syncthreads();
  // The warp's tile of C B^T, kept for every head; tiles above the
  // diagonal are masked to zero anyway.
  float cb[1][2][4] = {};
  if (wq <= r0)
    // a(m = i, k = n) = C[i][n]; b(k = n, n = j) = B[j][n]
    warp_gemm<1, 2>(cb, Cs + r0 * kLdC, kLdC, 1, Bs + wq * kLdC, 1, kLdC, nk,
                    lane);
  float wsum[1][2][4] = {};            // the heads' W, masked
  float gBa[1][4][4] = {}, gCa[1][4][4] = {};   // the heads' gB and gC

  for (int h = h_begin; h < h_end; ++h) {
    const long long bh = (long long)b * H + h;
    const long long blk = ((bh * chunks + c) * N + n0) * P + p0;
    // Three groups: the head's x and gy columns and dt; G_c; H0_c.
    for (int e = tid; e < kQ * (kPB / 4); e += kChunkThreads) {
      const int j = e / (kPB / 4), p = 4 * (e - j * (kPB / 4)), t = t0 + j;
      const bool valid = t < S && p0 + p < P;
      copy16(Xs + j * kLdX + p,
             valid ? x + b * sxb + t * sxs + (long long)h * P + p0 + p : x,
             valid);
      copy16(Ys + j * kLdX + p,
             valid ? gy + (((long long)b * S + t) * H + h) * P + p0 + p : gy,
             valid);
    }
    if (tid < kQ) {
      const bool valid = t0 + tid < S;
      copy4(dts + tid, valid ? dt + b * sdb + (t0 + tid) * sds + h : dt,
            valid);
    }
    copies_commit();
    for (int e = tid; e < kNB * (kPB / 4); e += kChunkThreads) {
      const int n = e / (kPB / 4), p = 4 * (e - n * (kPB / 4));
      const bool valid = n0 + n < N && p0 + p < P;
      copy16(Gs + n * kLdG + p,
             valid ? gstates + blk + (long long)n * P + p : gstates, valid);
    }
    copies_commit();
    for (int e = tid; e < kNB * (kPB / 4); e += kChunkThreads) {
      const int n = e / (kPB / 4), p = 4 * (e - n * (kPB / 4));
      const bool valid = n0 + n < N && p0 + p < P;
      copy16(Hs + n * kLdX + p,
             valid ? states + blk + (long long)n * P + p : states, valid);
    }
    copies_commit();
    copies_wait_group<2>();
    __syncthreads();
    if (warp == 0) {
      float cum[2];
      const float tot = warp_cumsum(dts, A[h], lane, cum);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int i = 2 * lane + k;
        const float o = expf(tot - cum[k]);
        acum[i] = cum[k];
        ea[i] = expf(cum[k]);
        dout[i] = o;
        ddo[i] = dts[i] * o;
      }
    }
    __syncthreads();

    // W~ = gy u^T: a(m = i, k = p) = gy[i][p]; b(k = p, n = j) = x[j][p] dt_j.
    float wt[1][2][4] = {};
    if (wq <= r0)
      warp_gemm<1, 2, false, true>(wt, Ys + r0 * kLdX, kLdX, 1,
                                   Xs + wq * kLdX, 1, kLdX, kPB / 8, lane,
                                   nullptr, dts + wq);
    // M = C B^T * L and E = W * C B^T into shared memory, W = W~ * L into
    // the heads' sum (zero above the diagonal).
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = r0 + g + 8 * half, j = wq + 8 * nt + 2 * tq;
        const float ai = acum[i];
        const float l0 = j <= i ? expf(ai - acum[j]) : 0.f;
        const float l1 = j + 1 <= i ? expf(ai - acum[j + 1]) : 0.f;
        const float c0 = cb[0][nt][2 * half], c1 = cb[0][nt][2 * half + 1];
        const float w0 = wt[0][nt][2 * half] * l0;
        const float w1 = wt[0][nt][2 * half + 1] * l1;
        *reinterpret_cast<float2*>(Ms + i * kLdM + j) =
            make_float2(c0 * l0, c1 * l1);
        *reinterpret_cast<float2*>(Es + i * kLdE + j) =
            make_float2(w0 * c0, w1 * c1);
        wsum[0][nt][2 * half] += w0;
        wsum[0][nt][2 * half + 1] += w1;
      }
    copies_wait_group<0>();
    __syncthreads();                   // M, E, G_c and H0_c are in place

    // E's rows to their exclusive prefixes F, in place: each warp scans
    // kQ / 16 rows, two columns a lane.
#pragma unroll
    for (int k = 0; k < kQ / 16; ++k) {
      float2* row =
          reinterpret_cast<float2*>(Es + (kQ / 16 * warp + k) * kLdE);
      const float2 e = row[lane];
      float incl = e.x + e.y;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += o;
      }
      float excl = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) excl = 0.f;
      row[lane] = make_float2(excl, excl + e.x);
    }

    // gu = M^T gy over r >= i (a(m = i, k = r) = M[r][i], b(k = r, n = p) =
    // gy[r][p]) + diag(dout) B G_c (a(m = i, k = n) = B[i][n], b(k = n,
    // n = p) = G[n][p]); then gx = gu dt and the rows of <x, gu> and of
    // <x, B G_c>.
    float gm[1][2][4] = {}, gg[1][2][4] = {};
    warp_gemm<1, 2>(gm, Ms + r0 * kLdM + r0, 1, kLdM, Ys + r0 * kLdX + wq,
                    kLdX, 1, (kQ - r0) / 8, lane);
    warp_gemm<1, 2>(gg, Bs + r0 * kLdC, kLdC, 1, Gs + wq, kLdG, 1, nk, lane);
    float ux[2] = {0.f, 0.f}, vx[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = r0 + g + 8 * half, p = wq + 8 * nt + 2 * tq;
        const float o = dout[i];
        const float g0 = gg[0][nt][2 * half], g1 = gg[0][nt][2 * half + 1];
        const float u0 = fmaf(o, g0, gm[0][nt][2 * half]);
        const float u1 = fmaf(o, g1, gm[0][nt][2 * half + 1]);
        const float2 xv = *reinterpret_cast<const float2*>(Xs + i * kLdX + p);
        ux[half] = fmaf(u0, xv.x, ux[half]);
        ux[half] = fmaf(u1, xv.y, ux[half]);
        vx[half] = fmaf(g0, xv.x, vx[half]);
        vx[half] = fmaf(g1, xv.y, vx[half]);
        const int t = t0 + i;
        if (t < S && p0 + p < P) {
          const float d = dts[i];
          *reinterpret_cast<float2*>(
              gx + ((((long long)nb * batch + b) * S + t) * H + h) * P + p0 +
              p) = make_float2(u0 * d, u1 * d);
        }
      }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float su = quad_sum(ux[half]), sv = quad_sum(vx[half]);
      if (tq == 0) {
        pu[wb * kQ + r0 + g + 8 * half] = su;
        pv[wb * kQ + r0 + g + 8 * half] = sv;
      }
    }
    // gB += diag(dt dout) x G_c^T: a(m = i, k = p) = x[i][p] dt_i dout_i,
    // b(k = p, n = n) = G[n][p].
    warp_gemm<1, 4, true>(gBa, Xs + r0 * kLdX, kLdX, 1, Gs + wn * kLdG, 1,
                          kLdG, kPB / 8, lane, ddo + r0);
    // gC's state term of this head, T = diag(exp(a_cum)) gy H0_c^T:
    // a(m = i, k = p) = gy[i][p] exp(a_cum_i), b(k = p, n = n) = H0[n][p];
    // the rows of <C, T>, then T into the heads' sum.
    float st[1][4][4] = {};
    warp_gemm<1, 4, true>(st, Ys + r0 * kLdX, kLdX, 1, Hs + wn * kLdX, 1,
                          kLdX, kPB / 8, lane, ea + r0);
    float cr[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = r0 + g + 8 * half, n = wn + 8 * nt + 2 * tq;
        const float2 cv = *reinterpret_cast<const float2*>(Cs + i * kLdC + n);
        cr[half] = fmaf(cv.x, st[0][nt][2 * half], cr[half]);
        cr[half] = fmaf(cv.y, st[0][nt][2 * half + 1], cr[half]);
        gCa[0][nt][2 * half] += st[0][nt][2 * half];
        gCa[0][nt][2 * half + 1] += st[0][nt][2 * half + 1];
      }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float s = quad_sum(cr[half]);
      if (tq == 0) pc[wb * kQ + r0 + g + 8 * half] = s;
    }
    __syncthreads();                   // F and the rows' parts are in place

    // The columns of F from the diagonal down: thread (column i, part k)
    // sums rows 8 k .. 8 k + 7 that are >= i.
    {
      const int i = tid % kQ, k = tid / kQ;
      float s = 0.f;
#pragma unroll
      for (int r = kQ / kParts * k; r < kQ / kParts * (k + 1); ++r)
        if (r >= i) s += Es[r * kLdE + i];
      pf[k * kQ + i] = s;
    }
    __syncthreads();

    // ga_i = exp(total) <H0_c, G_c> + sum_{r >= i} <C_r, T_r>
    //        + sum_{r >= i, j < i} E[r][j] + sum_{j < i} v_j, by one warp,
    // two steps a lane; then gdt = <gu, x> + ga A.
    if (warp == 0) {
      float tc[2], v[2], rect[2], uxs[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int i = 2 * lane + k;
        float sc = 0.f, su = 0.f, sv = 0.f, sf = 0.f;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          sc += pc[w * kQ + i];
          su += pu[w * kQ + i];
          sv += pv[w * kQ + i];
        }
#pragma unroll
        for (int w = 0; w < kParts; ++w) sf += pf[w * kQ + i];
        tc[k] = sc;
        uxs[k] = su;
        v[k] = ddo[i] * sv;
        rect[k] = sf;
      }
      // The suffix of <C, T> (lanes >= this one) and the exclusive prefix
      // of v (lanes < this one).
      float suf = tc[0] + tc[1], pre = v[0] + v[1];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_down_sync(kFull, suf, off);
        if (lane + off < 32) suf += o;
        const float u = __shfl_up_sync(kFull, pre, off);
        if (lane >= off) pre += u;
      }
      float after = __shfl_down_sync(kFull, suf, 1);
      if (lane == 31) after = 0.f;
      float before = __shfl_up_sync(kFull, pre, 1);
      if (lane == 0) before = 0.f;
      const float suffix[2] = {tc[0] + (tc[1] + after), tc[1] + after};
      const float prefix[2] = {before, before + v[0]};
      const float bs = base[((pidx * batch + b) * H + h) * chunks + c];
      const float Ah = A[h];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int t = t0 + 2 * lane + k;
        const float ga = ((bs + suffix[k]) + rect[k]) + prefix[k];
        if (t < S) {
          const long long o = ((pidx * batch + b) * S + t) * H + h;
          ga_part[o] = ga;
          gdt_part[o] = fmaf(ga, Ah, uxs[k]);
        }
      }
    }
    __syncthreads();                   // before the next head's copies
  }

  // The heads' summed W (lower triangle; zero above), then gC += W B over
  // j <= i (a(m = i, k = j) = W[i][j], b(k = j, n = n) = B[j][n]) and
  // gB += W^T C over r >= i (a(m = i, k = r) = W[r][i], b(k = r, n = n) =
  // C[r][n]).
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = r0 + g + 8 * half, j = wq + 8 * nt + 2 * tq;
      *reinterpret_cast<float2*>(Ms + i * kLdM + j) =
          make_float2(wsum[0][nt][2 * half], wsum[0][nt][2 * half + 1]);
    }
  __syncthreads();
  warp_gemm<1, 4>(gCa, Ms + r0 * kLdM, kLdM, 1, Bs + wn, kLdC, 1,
                  (r0 + 16) / 8, lane);
  warp_gemm<1, 4>(gBa, Ms + r0 * kLdM + r0, 1, kLdM, Cs + r0 * kLdC + wn,
                  kLdC, 1, (kQ - r0) / 8, lane);
  const long long slab = (long long)pb * groups + grp;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = r0 + g + 8 * half, n = n0 + wn + 8 * nt + 2 * tq;
      const int t = t0 + i;
      if (t < S && n < N) {
        const long long o = ((slab * batch + b) * S + t) * N + n;
        *reinterpret_cast<float2*>(gB_part + o) =
            make_float2(gBa[0][nt][2 * half], gBa[0][nt][2 * half + 1]);
        *reinterpret_cast<float2*>(gC_part + o) =
            make_float2(gCa[0][nt][2 * half], gCa[0][nt][2 * half + 1]);
      }
    }
}

}  // namespace

// Plain C interface for ctypes: the two launches on one stream.  With
// chunks = ceil(S / 64), nnb = ceil(N / 128), npb = ceil(P / 64) and
// groups = ceil(H / heads_per_cta): gstates is (B, H, chunks, N, P) and
// base (nnb, npb, B, H, chunks) of scratch; gx is (nnb, B, S, H, P),
// gdt_part and ga_part (nnb, npb, B, S, H), gB_part and gC_part
// (npb, groups, B, S, N): parts for the wrapper to add.  g_hlast and g_h0
// may be null.  Returns the first failing cudaError_t, else cudaSuccess.
extern "C" int ssd_scan_bwd_launch(
    const float* x, long long sxb, long long sxs, const float* dt,
    long long sdb, long long sds, const float* A, const float* Bm,
    long long sbb, long long sbs, const float* Cm, long long scb,
    long long scs, const float* gy, const float* states,
    const float* g_hlast, float* gstates, float* base, float* gx,
    float* gdt_part, float* ga_part, float* gB_part, float* gC_part,
    float* g_h0, int batch, int S, int H, int P, int N, int heads_per_cta,
    void* stream) {
  if (batch <= 0 || H <= 0) return (int)cudaSuccess;
  if (P <= 0 || N <= 0 || (P & 3) || (N & 3) || S < 0 || heads_per_cta < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int chunks = (S + kQ - 1) / kQ;
  const int nnb = (N + kNB - 1) / kNB, npb = (P + kPB - 1) / kPB;
  const int smem1 = (int)sizeof(float) * state_bwd_smem_floats();
  cudaError_t err = cudaFuncSetAttribute(
      state_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return (int)err;
  state_bwd_kernel<<<dim3(nnb, H, batch * npb), kStateThreads, smem1, st>>>(
      dt, sdb, sds, A, Cm, scb, scs, gy, states, g_hlast, gstates, base, g_h0,
      batch, S, H, P, N, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 0) return (int)err;
  const int smem2 = (int)sizeof(float) * chunk_bwd_smem_floats();
  err = cudaFuncSetAttribute(chunk_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem2);
  if (err != cudaSuccess) return (int)err;
  const int groups = (H + heads_per_cta - 1) / heads_per_cta;
  chunk_bwd_kernel<<<dim3(chunks * nnb, groups, batch * npb), kChunkThreads,
                     smem2, st>>>(
      x, sxb, sxs, dt, sdb, sds, A, Bm, sbb, sbs, Cm, scb, scs, gy, states,
      gstates, base, gx, gdt_part, ga_part, gB_part, gC_part, batch, S, H, P,
      N, chunks, heads_per_cta);
  return (int)cudaGetLastError();
}
