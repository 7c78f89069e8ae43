// The fragments tracker's vote, for Hopper (sm_90a): every candidate of
// every target scored against its reference fragments in one launch, each
// target on its own frame of a stored fp32 integral histogram, and the first
// best candidate a target written out.
//
// Replaces no TPU kernel: the reference votes with XLA ops
// (repro/core/tracking.py), and so does the port's plain path, which builds
// every candidate's fragment histograms (targets x candidates x fragments x
// bins) and passes over them some twenty times.  For target g of frame i,
// box [r0, c0, r1, c1] (bh = r1 - r0, bw = c1 - c0), grid gr x gc, radius R:
//
//   candidate (dr, dc), dr outer, each in [0, 2R]:
//     top  = min(max(r0 + dr - R, 0), max(h - 1 - bh, 0)), left alike;
//   its corner lattice (k = 0..gr, j = 0..gc):
//     row_k = top + k (bh + 1) / gr - 1,  col_j = left + j (bw + 1) / gc - 1,
//     L_kj,b = H[i, b, row_k, col_j], 0 where row_k or col_j is -1;
//   fragment (k, j):  v_b = ((L_k+1,j+1 - L_k,j+1) - L_k+1,j) + L_k,j
//                     N   = sum_b v_b
//                     s   = sum_b min(v_b / (N + 1e-8), t_b / (T + 1e-8))
//   score = median of the gr gc values s (the mean of the two middle ones
//   of an even count), the winner the first candidate with the largest.
//
// with t the fragment's reference histogram and T its in-order sum.  Equal
// to the plain path bit for bit: each corner is the plain gather's value,
// the fragment's differences are taken in its order (exact, as counts are
// integers below 2^24), every sum over the bins is taken in bin order from
// 0 in fp32, as torch's cumsum down the bin axis takes it, the quotient is
// the IEEE one (__fdiv_rn), the minimum is torch.minimum's for finite
// values, and the median sorts the same values.
//
// What bounds it: not much.  A CTA is one target, a thread a candidate: the
// lanes of a warp are consecutive column offsets, so each corner load of a
// bin is 32 consecutive floats.  The CTA first normalises the target's
// reference fragments into shared memory; each thread then walks the bins
// twice (the sums N, then the intersections), keeping its lattice row in
// registers; the CTA reduces (score, candidate) to the first maximum.

#include <cuda_runtime.h>

#include <cfloat>

namespace {

constexpr int kThreads = 256;
constexpr float kEps = 1e-8f;

template <int GR, int GC>
__device__ inline void load_lattice(const float* __restrict__ Hb, int w,
                                    const int (&rows)[GR + 1],
                                    const int (&cols)[GC + 1],
                                    float (&L)[GR + 1][GC + 1]) {
#pragma unroll
  for (int k = 0; k <= GR; ++k)
#pragma unroll
    for (int j = 0; j <= GC; ++j)
      L[k][j] = (rows[k] >= 0 && cols[j] >= 0)
                    ? Hb[(long long)rows[k] * w + cols[j]]
                    : 0.0f;
}

template <int GR, int GC>
__global__ void __launch_bounds__(kThreads)
    track_vote_kernel(const float* __restrict__ H,
                      const int* __restrict__ boxes,
                      const float* __restrict__ ref, long long rs_n,
                      long long rs_t, long long rs_f, long long rs_b,
                      int* __restrict__ out_box, float* __restrict__ out_score,
                      int t, int nb, int h, int w, int radius) {
  constexpr int F = GR * GC;
  extern __shared__ float tref[];            // (F, nb): t_b / (T + 1e-8)
  __shared__ float best_val[kThreads];
  __shared__ int best_idx[kThreads];

  const int g = blockIdx.x;                  // target: frame g / t
  const int i = g / t;
  const int* box = boxes + 4LL * g;
  const int bh = box[2] - box[0], bw = box[3] - box[1];
  const int rmax = max(h - 1 - bh, 0), cmax = max(w - 1 - bw, 0);
  const int hh = (bh + 1) / GR, ww = (bw + 1) / GC;
  const int side = 2 * radius + 1;
  const int cands = side * side;

  const float* rg = ref + (long long)i * rs_n + (long long)(g % t) * rs_t;
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    float T = 0.0f;
    for (int b = 0; b < nb; ++b) T += rg[f * rs_f + b * rs_b];
    const float d = T + kEps;
    for (int b = 0; b < nb; ++b)
      tref[f * nb + b] = __fdiv_rn(rg[f * rs_f + b * rs_b], d);
  }
  __syncthreads();

  const float* Hi = H + (long long)i * nb * h * w;
  float my_val = -FLT_MAX;
  int my_idx = cands;
  for (int c = threadIdx.x; c < cands; c += blockDim.x) {
    const int top = min(max(box[0] + c / side - radius, 0), rmax);
    const int left = min(max(box[1] + c % side - radius, 0), cmax);
    int rows[GR + 1], cols[GC + 1];
#pragma unroll
    for (int k = 0; k <= GR; ++k) rows[k] = min(top + k * hh - 1, h - 1);
#pragma unroll
    for (int j = 0; j <= GC; ++j) cols[j] = min(left + j * ww - 1, w - 1);

    float N[GR][GC];
#pragma unroll
    for (int k = 0; k < GR; ++k)
#pragma unroll
      for (int j = 0; j < GC; ++j) N[k][j] = 0.0f;
    float L[GR + 1][GC + 1];
    for (int b = 0; b < nb; ++b) {
      load_lattice<GR, GC>(Hi + (long long)b * h * w, w, rows, cols, L);
#pragma unroll
      for (int k = 0; k < GR; ++k)
#pragma unroll
        for (int j = 0; j < GC; ++j)
          N[k][j] += ((L[k + 1][j + 1] - L[k][j + 1]) - L[k + 1][j]) + L[k][j];
    }
    float s[F];
#pragma unroll
    for (int f = 0; f < F; ++f) s[f] = 0.0f;
    for (int b = 0; b < nb; ++b) {
      load_lattice<GR, GC>(Hi + (long long)b * h * w, w, rows, cols, L);
#pragma unroll
      for (int k = 0; k < GR; ++k)
#pragma unroll
        for (int j = 0; j < GC; ++j) {
          const float v =
              ((L[k + 1][j + 1] - L[k][j + 1]) - L[k + 1][j]) + L[k][j];
          const float q = __fdiv_rn(v, N[k][j] + kEps);
          s[k * GC + j] += fminf(q, tref[(k * GC + j) * nb + b]);
        }
    }
    // insertion sort of the F similarities, then the middle pair's mean
#pragma unroll
    for (int a = 1; a < F; ++a)
#pragma unroll
      for (int e = a; e > 0; --e)
        if (s[e] < s[e - 1]) {
          const float x = s[e];
          s[e] = s[e - 1];
          s[e - 1] = x;
        }
    const float score = (s[(F - 1) / 2] + s[F / 2]) * 0.5f;
    if (score > my_val) {                    // candidates rise: first max
      my_val = score;
      my_idx = c;
    }
  }
  best_val[threadIdx.x] = my_val;
  best_idx[threadIdx.x] = my_idx;
  __syncthreads();
  for (int half = blockDim.x / 2; half > 0; half /= 2) {
    if (threadIdx.x < half) {
      const float ov = best_val[threadIdx.x + half];
      const int oi = best_idx[threadIdx.x + half];
      const float mv = best_val[threadIdx.x];
      if (ov > mv || (ov == mv && oi < best_idx[threadIdx.x])) {
        best_val[threadIdx.x] = ov;
        best_idx[threadIdx.x] = oi;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const int c = best_idx[0];
    const int top = min(max(box[0] + c / side - radius, 0), rmax);
    const int left = min(max(box[1] + c % side - radius, 0), cmax);
    out_box[4 * g + 0] = top;
    out_box[4 * g + 1] = left;
    out_box[4 * g + 2] = top + bh;
    out_box[4 * g + 3] = left + bw;
    out_score[g] = best_val[0];
  }
}

template <int GR, int GC>
int launch(int targets, size_t smem, cudaStream_t st, const float* H,
           const int* boxes, const float* ref, long long rs_n, long long rs_t,
           long long rs_f, long long rs_b, int* out_box, float* out_score,
           int t, int nb, int h, int w, int radius) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        track_vote_kernel<GR, GC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  track_vote_kernel<GR, GC><<<targets, kThreads, smem, st>>>(
      H, boxes, ref, rs_n, rs_t, rs_f, rs_b, out_box, out_score, t, nb, h, w,
      radius);
  return (int)cudaGetLastError();
}

}  // namespace

// H (n, nb, h, w) contiguous fp32; boxes (n, t, 4) contiguous int32, inside
// the frame; ref (n, t, gr gc, nb) fp32 with the given element strides (0
// broadcasts); out_box (n, t, 4) int32, out_score (n, t) fp32.  Grids up to
// 4 x 4 and radii up to 511.
extern "C" int track_vote_launch(const float* H, const int* boxes,
                                 const float* ref, long long rs_n,
                                 long long rs_t, long long rs_f,
                                 long long rs_b, int* out_box,
                                 float* out_score, int n, int t, int nb, int h,
                                 int w, int gr, int gc, int radius,
                                 void* stream) {
  if (n <= 0 || t <= 0) return (int)cudaSuccess;
  if (nb <= 0 || h <= 0 || w <= 0 || radius < 0 || radius > 511 || gr < 1 ||
      gr > 4 || gc < 1 || gc > 4 || (long long)n * t > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)gr * gc * nb * sizeof(float);
  if (smem > 160 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int targets = n * t;
#define TRACK_VOTE_CASE(A, B)                                               \
  if (gr == A && gc == B)                                                   \
    return launch<A, B>(targets, smem, st, H, boxes, ref, rs_n, rs_t, rs_f, \
                        rs_b, out_box, out_score, t, nb, h, w, radius);
#define TRACK_VOTE_ROW(A) \
  TRACK_VOTE_CASE(A, 1) TRACK_VOTE_CASE(A, 2) TRACK_VOTE_CASE(A, 3) \
  TRACK_VOTE_CASE(A, 4)
  TRACK_VOTE_ROW(1)
  TRACK_VOTE_ROW(2)
  TRACK_VOTE_ROW(3)
  TRACK_VOTE_ROW(4)
#undef TRACK_VOTE_ROW
#undef TRACK_VOTE_CASE
  return (int)cudaErrorInvalidValue;
}
