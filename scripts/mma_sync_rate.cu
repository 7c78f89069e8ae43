// The issue rate of mma.sync on one GPU: TF32 m16n8k8 and BF16 m16n8k16,
// eight independent accumulators a warp, 4 to 32 warps on each SM.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o mma_sync_rate \
//        scripts/mma_sync_rate.cu && ./mma_sync_rate
//
// Prints cycles a product per SM sub-partition (clock64 of one warp) and
// TFLOP/s over the whole card (CUDA events).  K5 (src/repro_torch/kernels/
// csrc/ssd_scan.cu) runs its products as TF32 mma.sync; this is their
// ceiling, against the card's 495 TFLOP/s dense TF32 through wgmma.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool BF16>
__global__ void products(float* out, int iters, long long* clk) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = threadIdx.x * 7 + i;
  b[0] = threadIdx.x;
  b[1] = threadIdx.x * 3;
  float d[8][4] = {};
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (BF16) mma_bf16(d[j], a, b); else mma_tf32(d[j], a, b);
    }
  }
  const long long t1 = clock64();
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0 && blockIdx.x == 0) *clk = t1 - t0;
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out;
  long long* clk;
  cudaMalloc(&out, (size_t)sms * 1024 * sizeof(float));
  cudaMalloc(&clk, sizeof(long long));
  const int iters = 2000;
  for (int bf16 = 0; bf16 < 2; ++bf16)
    for (int warps : {4, 8, 16, 32}) {
      cudaEvent_t e0, e1;
      cudaEventCreate(&e0);
      cudaEventCreate(&e1);
      for (int rep = 0; rep < 2; ++rep) {      // the first is a warm-up
        cudaEventRecord(e0);
        if (bf16) products<true><<<sms, warps * 32>>>(out, iters, clk);
        else products<false><<<sms, warps * 32>>>(out, iters, clk);
        cudaEventRecord(e1);
        cudaEventSynchronize(e1);
      }
      float ms = 0.f;
      cudaEventElapsedTime(&ms, e0, e1);
      long long c = 0;
      cudaMemcpy(&c, clk, sizeof(c), cudaMemcpyDeviceToHost);
      const double per_sm = (double)warps * iters * 8;   // products an SM
      const double flops = (double)sms * per_sm * (bf16 ? 4096 : 2048);
      printf("%s, %d warps an SM: %.1f cycles a product per SM "
             "sub-partition, %.0f TFLOP/s\n",
             bf16 ? "bf16 m16n8k16" : "tf32 m16n8k8", warps,
             (double)c / (per_sm / 4), flops / (ms * 1e-3) / 1e12);
    }
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
