// The dense likelihood map, for Hopper (sm_90a): every (wh, ww) window of a
// stored fp32 integral histogram, at stride s, scored against a target by
// histogram intersection, in one pass that writes only the map.
//
// Replaces no TPU kernel: the reference computes the map with XLA ops
// (repro/core/region_query.py::likelihood_map over
// repro/core/distances.py::intersection), and so did the port's plain path,
// which materialises the whole window field (frames x rows x cols x bins)
// several times over.  For output (f, i, j), r0 = i s, c0 = j s:
//
//   v_b  = (H[b,r1,c1] - H[b,r1,c0-1]) - (H[b,r0-1,c1] - H[b,r0-1,c0-1])
//   N    = sum_b v_b
//   map  = sum_b min(v_b / (N + 1e-8), t_b / (T + 1e-8))   (in order, from 0)
//
// with corners at -1 reading 0 and T the target's in-order sum from 0.
//
// Equal to the plain path bit for bit where H holds integer counts below
// 2^24, as every exact integral histogram does: the corner sums and N are
// then exact in any order; the two bin sums that round (the target's T and
// the map) are taken in bin order from 0, as torch's cumsum down the bin
// axis takes them; and v / (N + 1e-8) is taken as the fp64 product of v and
// the fp64 reciprocal of N + 1e-8, rounded to fp32, which is the IEEE fp32
// quotient there: v and N are integers below 2^24, so v / N lies at least
// 2^-49 of its size from any fp32 rounding midpoint (its exact value needs
// at most 24 bits when it is dyadic), and the product is within 2^-52 of it.
// The minimum is torch.minimum's: NaN where the target has a NaN bin.
//
// What bounds it: bytes.  H is read once and the map written once; the
// work is a few adds, a product and a minimum a bin.  A lane owns an output
// column, and a chain of output rows q apart walks down it.  Where the
// window height is a multiple of the stride (q = wh / s), the bottom
// corner row of a step is the top corner row of the next: the lane keeps
// each bin's difference of that row's two corners in a register, so each
// H row is read once per column strip, not twice wh rows apart (a distance
// no cache holds at this traffic).  Two kernels:
//
//   * window_map_rows_kernel (stride 1, bins <= 32, rows of whole 16-byte
//     chunks): a CTA is one chain over kRowThreads columns.  Each step its
//     threads copy the step's corner row of every bin, the columns its
//     lanes read, into shared memory with cp.async, kStages rows in
//     flight, and each lane takes its two corners of a bin from there.
//     Scalar loads of two misaligned corners a bin and lane ran at a
//     quarter of this speed on the H100; three or four stages, or 64, 192
//     or 256 columns a CTA, were slower.
//   * window_map_walk_kernel (any stride and bin count): a warp is one
//     chain over 32 columns, loading its corners from global memory; bins
//     up to 32 in registers, more in two passes over the corners (the
//     second from L1).  At one 480x640 frame, stride 2, it ran 2.5 times
//     faster than the plain path on the H100, at 32 frames 6.4 times.
//
// The grids run column strips fastest, then chains, then frames, so the
// CTAs resident at once share frames and the halo columns of neighbouring
// strips come from L2.  The CTA normalises the target once into shared
// memory.  One writer an output element, no atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowThreads = 128;     // rows kernel: columns (threads) a CTA
constexpr int kStages = 2;           // rows kernel: corner rows in flight
constexpr int kRowBlocks = 5;        // rows kernel: CTAs an SM (<= 102 regs)
constexpr int kWarps = 4;            // walk kernel: chains a CTA
constexpr int kLanes = 32;           // walk kernel: columns a chain
constexpr int kRegBins = 32;         // bins kept in registers
constexpr float kEps = 1e-8f;        // distances._EPS as fp32

// t_hat[0, nb): the normalised target; t_hat[nb]: 1 if a bin is NaN.
__device__ void normalise_target(const float* __restrict__ t, int nb,
                                 float* t_hat) {
  for (int b = threadIdx.x; b < nb; b += blockDim.x) t_hat[b] = t[b];
  __syncthreads();
  float T = 0.f;
  for (int b = 0; b < nb; ++b) T = __fadd_rn(T, t_hat[b]);
  const float den = __fadd_rn(T, kEps);
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += blockDim.x)
    t_hat[b] = __fdiv_rn(t_hat[b], den);
  __syncthreads();
  if (threadIdx.x == 0) {
    bool nan = false;
    for (int b = 0; b < nb; ++b) nan |= t_hat[b] != t_hat[b];
    t_hat[nb] = nan ? 1.f : 0.f;
  }
  __syncthreads();
}

// One bin's term of the map: min(v / den, t) with v / den the IEEE fp32
// quotient (see the top), through y = 1 / den in fp64.  Neither is NaN here
// (a target with a NaN bin writes NaN), so fminf is torch.minimum up to the
// sign of a zero, which a sum from +0 does not keep.
__device__ __forceinline__ float term(float v, double y, float t) {
  return fminf(__double2float_rn(__dmul_rn((double)v, y)), t);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(kRowThreads, kRowBlocks)
window_map_rows_kernel(const float* __restrict__ H,
                       const float* __restrict__ target, long long t_stride,
                       float* __restrict__ out, int nb, int h, int w, int wh,
                       int ww, int n_r, int n_c, int q, int steps, int span,
                       int tpad) {
  extern __shared__ float4 smem4[];
  float* t_hat = reinterpret_cast<float*>(smem4);
  float* rows = t_hat + tpad;                 // kStages x nb x span
  const int f = blockIdx.z;
  normalise_target(target + f * t_stride, nb, t_hat);
  const bool t_nan = t_hat[nb] != 0.f;

  const int rho = blockIdx.y % q;
  const int first = (blockIdx.y / q) * steps;
  const int j0 = blockIdx.x * kRowThreads;
  const int a0 = ((j0 - 1) >> 2) << 2;        // first chunk's column (-4)
  const int a1 = min(w, j0 + kRowThreads + ww - 1);
  const int chunks = (a1 - a0 + 3) >> 2;
  const int items = nb * chunks;               // (bin, chunk) pairs a row
  const int b0 = threadIdx.x / chunks, ch0 = threadIdx.x % chunks;
  const int db = kRowThreads / chunks, dch = kRowThreads % chunks;
  const long long hw = (long long)h * w;
  const float* Hf = H + (long long)f * nb * hw;
  float* outf = out + (long long)f * n_r * n_c;
  const int j = j0 + threadIdx.x;
  const int o1 = j + ww - 1 - a0, o0 = j - 1 - a0;
  int loads = 1;                              // the top row, then bottoms
  while (loads <= steps && rho + (first + loads - 1) * q < n_r) ++loads;
  if (loads == 1) return;                     // a chain past the last row
  // Load l: the top corner row of the chain's first output (l = 0, row -1
  // reads as zeros) or the bottom corner row of its output l - 1.
  auto issue = [&](int l) {
    if (l >= loads) return;
    const int i = rho + (first + max(l - 1, 0)) * q;
    const int r = l == 0 ? i - 1 : i + wh - 1;
    float* buf = rows + (l % kStages) * nb * span;
    for (int it = threadIdx.x, b = b0, ch = ch0; it < items;
         it += kRowThreads, b += db, ch += dch) {
      if (ch >= chunks) {
        ch -= chunks;
        ++b;
      }
      const int col = a0 + 4 * ch;
      float* dst = buf + b * span + 4 * ch;
      if (r < 0 || col < 0)
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      else
        cp_async16(dst, Hf + b * hw + (long long)r * w + col);
    }
  };
#pragma unroll
  for (int l = 0; l < kStages - 1; ++l) {
    issue(l);
    cp_async_commit();
  }
  float top[kRegBins];
  for (int l = 0; l < loads; ++l) {
    issue(l + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const float* buf = rows + (l % kStages) * nb * span;
    float d[kRegBins];
#pragma unroll
    for (int b = 0; b < kRegBins; ++b)
      d[b] = b < nb ? __fsub_rn(buf[b * span + o1], buf[b * span + o0]) : 0.f;
    if (l > 0 && j < n_c) {
      float N = 0.f;
#pragma unroll
      for (int b = 0; b < kRegBins; ++b)
        if (b < nb) N = __fadd_rn(N, __fsub_rn(d[b], top[b]));
      const double y = 1.0 / (double)__fadd_rn(N, kEps);
      float acc = 0.f;
#pragma unroll
      for (int b = 0; b < kRegBins; ++b)
        if (b < nb)
          acc = __fadd_rn(acc, term(__fsub_rn(d[b], top[b]), y, t_hat[b]));
      outf[(long long)(rho + (first + l - 1) * q) * n_c + j] =
          t_nan ? __int_as_float(0x7fc00000) : acc;
    }
#pragma unroll
    for (int b = 0; b < kRegBins; ++b) top[b] = d[b];
    __syncthreads();
  }
}

template <int NB>
__global__ void __launch_bounds__(kWarps * kLanes)
window_map_walk_kernel(const float* __restrict__ H,
                       const float* __restrict__ target, long long t_stride,
                       float* __restrict__ out, int nb, int h, int w, int wh,
                       int ww, int s, int n_r, int n_c, int q, int steps,
                       int units, int reuse) {
  extern __shared__ float4 smem4[];
  float* t_hat = reinterpret_cast<float*>(smem4);
  const int f = blockIdx.z;
  normalise_target(target + f * t_stride, nb, t_hat);
  const bool t_nan = t_hat[nb] != 0.f;

  const int unit = blockIdx.y * kWarps + threadIdx.x / kLanes;
  const int j = blockIdx.x * kLanes + threadIdx.x % kLanes;
  if (unit >= units || j >= n_c) return;
  const int rho = unit % q;
  const int first = (unit / q) * steps;
  const long long hw = (long long)h * w;
  const float* Hf = H + (long long)f * nb * hw;
  float* outf = out + (long long)f * n_r * n_c;
  const int c1 = j * s + ww - 1;
  const int c0 = j * s - 1;                   // -1: the virtual column
  // A corner row's right-minus-left corners of bin b (row -1 reads 0).
  auto corners = [&](int r, int b) {
    if (r < 0) return 0.f;
    const float* p = Hf + b * hw + (long long)r * w;
    return __fsub_rn(__ldg(p + c1), c0 >= 0 ? __ldg(p + c0) : 0.f);
  };
  for (int k = 0; k < steps; ++k) {
    const int i = rho + (first + k) * q;
    if (i >= n_r) break;
    const int rb = i * s + wh - 1, rt = i * s - 1;
    float acc = 0.f;
    if constexpr (NB > 0) {
      float top[NB], d[NB];
      if (!reuse || k == 0) {
#pragma unroll
        for (int b = 0; b < NB; ++b) top[b] = b < nb ? corners(rt, b) : 0.f;
      }
      float N = 0.f;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        d[b] = b < nb ? corners(rb, b) : 0.f;
        N = __fadd_rn(N, __fsub_rn(d[b], top[b]));
      }
      const double y = 1.0 / (double)__fadd_rn(N, kEps);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        if (b < nb)
          acc = __fadd_rn(acc, term(__fsub_rn(d[b], top[b]), y, t_hat[b]));
        top[b] = d[b];
      }
    } else {
      float N = 0.f;
      for (int b = 0; b < nb; ++b)
        N = __fadd_rn(N, __fsub_rn(corners(rb, b), corners(rt, b)));
      const double y = 1.0 / (double)__fadd_rn(N, kEps);
      for (int b = 0; b < nb; ++b)
        acc = __fadd_rn(acc, term(__fsub_rn(corners(rb, b), corners(rt, b)),
                                  y, t_hat[b]));
    }
    outf[(long long)i * n_c + j] = t_nan ? __int_as_float(0x7fc00000) : acc;
  }
}

template <int NB>
int launch_walk(dim3 grid, size_t smem, cudaStream_t st, const float* H,
                const float* target, long long t_stride, float* out, int nb,
                int h, int w, int wh, int ww, int s, int n_r, int n_c, int q,
                int steps, int units, int reuse) {
  window_map_walk_kernel<NB><<<grid, kWarps * kLanes, smem, st>>>(
      H, target, t_stride, out, nb, h, w, wh, ww, s, n_r, n_c, q, steps,
      units, reuse);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Plain C interface for ctypes; returns the cudaError_t of the launch.  The
// wrapper (kernels/window_map.py::launch_shape) chooses the kernel and its
// chains; they are checked here against what each kernel assumes.  `span`
// is the rows kernel's floats a corner row of a bin in shared memory (0
// for the walk kernel).
extern "C" int window_map_launch(const float* H, const float* target,
                                 long long t_stride, float* out, int n,
                                 int nb, int h, int w, int wh, int ww, int s,
                                 int n_r, int n_c, int q, int steps,
                                 int units, int reuse, int span,
                                 void* stream) {
  if (n <= 0 || n_r <= 0 || n_c <= 0) return (int)cudaSuccess;
  const bool in_regs = nb <= kRegBins;
  const bool rows = span > 0;
  if (nb <= 0 || s <= 0 || wh <= 0 || ww <= 0 || q <= 0 || steps <= 0 ||
      units <= 0 || units % q || (long long)(n_r - 1) * s + wh > h ||
      (long long)(n_c - 1) * s + ww > w ||
      (reuse && (!in_regs || q * s != wh)) ||
      (long long)steps * (units / q) * q < n_r || n > 65535 ||
      (rows && (!reuse || s != 1 || w % 4 || !aligned16(H) ||
                span < kRowThreads + ww + 6 || span % 4)))
    return (int)cudaErrorInvalidValue;
  const int tpad = (nb + 4) / 4 * 4;          // t_hat and its flag, whole
  cudaStream_t st = (cudaStream_t)stream;
  if (rows) {
    if (units > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((n_c + kRowThreads - 1) / kRowThreads, units, n);
    const size_t smem = (size_t)(tpad + kStages * nb * span) * sizeof(float);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          window_map_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    window_map_rows_kernel<<<grid, kRowThreads, smem, st>>>(
        H, target, t_stride, out, nb, h, w, wh, ww, n_r, n_c, q, steps, span,
        tpad);
    return (int)cudaGetLastError();
  }
  if ((units + kWarps - 1) / kWarps > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((n_c + kLanes - 1) / kLanes, (units + kWarps - 1) / kWarps,
                  n);
  const size_t smem = (size_t)tpad * sizeof(float);
  if (in_regs)
    return launch_walk<kRegBins>(grid, smem, st, H, target, t_stride, out, nb,
                                 h, w, wh, ww, s, n_r, n_c, q, steps, units,
                                 reuse);
  return launch_walk<0>(grid, smem, st, H, target, t_stride, out, nb, h, w,
                        wh, ww, s, n_r, n_c, q, steps, units, reuse);
}
