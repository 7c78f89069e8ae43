// K2: the query-fused WF-TiS scan (see wf_tis_scan.cuh).  Writes only the
// rows with row_slot[r] >= 0, to output row row_slot[r], and stops after
// row h_run - 1.  Plain C interface for ctypes; returns the cudaError_t.

#include "wf_tis_scan.cuh"

extern "C" int fused_rows_launch(const int* idx, const float* carry,
                                 const int* row_slot, float* out, int n, int h,
                                 int h_run, int w, int num_bins, int num_rows,
                                 int bin_block, int threads, int q,
                                 void* stream) {
  // One strip: the whole walk down to row h_run - 1, no pre-pass.
  return (int)wf_tis_scan::launch<true>(
      idx, carry, row_slot, nullptr, out, n, h, h_run, w, num_bins, num_rows,
      bin_block, threads, q, h_run, (cudaStream_t)stream);
}
