// K1: the dense WF-TiS integral histogram (see wf_tis_scan.cuh).
// Plain C interface for ctypes; returns the cudaError_t of the launch.

#include "wf_tis_scan.cuh"

extern "C" int wf_tis_launch(const int* idx, const float* carry, float* out,
                             int n, int h, int w, int num_bins, int bin_block,
                             int threads, int q, void* stream) {
  return (int)wf_tis_scan::launch<false>(
      idx, carry, nullptr, out, n, h, h, w, num_bins, h, bin_block, threads,
      q, (cudaStream_t)stream);
}
