"""Hand-written CUDA kernels for the integral-histogram scan (sm_90a).

wf_tis.py     — K1, the WF-TiS scan: bin ids -> inclusive H.
fused_rows.py — K2, the same scan emitting only requested rows of H.
delta_apply.py — K3, the carry-delta broadcast of incremental video updates.
cw_tis.py     — K4, CW-TiS: a row-scan launch (hscan), then a column-scan
                launch (vscan).
ssd_scan.py   — K5, the Mamba-2 SSD chunked scan of the model zoo.
csrc/         — the CUDA C++ sources, shared scan in wf_tis_scan.cuh.
_build.py     — nvcc at first use, libraries loaded with ctypes.
ops.py        — the public entry points and backend dispatch.
ref.py        — the plain torch oracle.
"""

from repro_torch.kernels.ops import integral_histogram
from repro_torch.kernels.ref import integral_histogram_ref

__all__ = ["integral_histogram", "integral_histogram_ref"]
