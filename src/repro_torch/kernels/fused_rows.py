"""K2: the query-fused WF-TiS scan — only the requested rows of H.

Replaces ``repro/kernels/fused_rows.py::fused_rows_pallas`` (body
``_fused_rows_kernel``, host ``slot_plan``).  Source:
``csrc/fused_rows.cu`` over the same scan as K1
(``csrc/wf_tis_scan.cuh``, the ``FUSED`` instantiation).

What bounds it on an H100: the walk, not the output.  It writes
``num_bins * len(rows) * w`` floats, usually a small fraction of H, and
reads the bin ids of every row down to the last requested one.  The
design keeps K1's walk, skips the cross-column scan and the store on
every row that is not requested, and stops after the last requested row
(rows below it feed no output).  The TPU kernel's per-strip ``(nth, kp)``
slot slabs and its one-hot selection matmul exist only because a TPU has
no dynamic sublane gather; here a ``row -> slot`` map, built on the host
from the row ids and copied with the launch, puts each row straight at
its place in request order.

``fused_rows_cuda`` launches the kernel for a CUDA tensor and runs
``fused_rows_plain`` (K1's plain version, then the rows) only for a CPU
tensor.  ``fused_rows_cuda.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels.wf_tis import (
    check_inputs,
    launch_shape,
    wf_tis_plain,
)


def check_rows(row_ids, h: int) -> np.ndarray:
    """``row_ids`` as a host int64 array, or ValueError unless they are
    sorted unique rows in ``[0, h)``."""
    rows = np.asarray(row_ids, np.int64).reshape(-1)
    if (rows.size == 0 or np.any(np.diff(rows) <= 0) or rows[0] < 0
            or rows[-1] >= h):
        raise ValueError(
            f"row_ids must be sorted unique rows within [0, {h}), got {rows}")
    return rows


def row_slot_map(rows: np.ndarray, h: int) -> torch.Tensor:
    """int32 (h,) map: ``map[rows[i]] = i``, -1 for other rows."""
    slot = torch.full((h,), -1, dtype=torch.int32)
    slot[torch.as_tensor(rows, dtype=torch.int64)] = torch.arange(
        len(rows), dtype=torch.int32)
    return slot


def fused_rows_plain(idx: torch.Tensor, num_bins: int, row_ids,
                     carry: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch K2: K1's plain H, then the requested rows in order."""
    rows = torch.as_tensor(np.asarray(row_ids, np.int64), device=idx.device)
    return wf_tis_plain(idx, num_bins, carry)[..., rows, :]


def _lib():
    from repro_torch.kernels import _build

    lib = _build.library("fused_rows.cu")
    fn = lib.fused_rows_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fused_rows_cuda(idx: torch.Tensor, num_bins: int, row_ids, *,
                    bin_block: int | None = None,
                    carry: torch.Tensor | None = None) -> torch.Tensor:
    """The rows ``row_ids`` of the integral histogram, in that order.

    Args:
      idx: (n, h, w) contiguous int32 bin ids (any value outside
        [0, num_bins) matches no bin).
      row_ids: sorted unique rows in [0, h), on the host (a sequence, a
        numpy array or a CPU tensor): they are checked and turned into the
        kernel's row -> slot map without waiting on the card.
      carry: optional (n, num_bins, w) fp32 band carry-in.

    Returns:
      (n, num_bins, len(row_ids), w) fp32.  A CPU tensor runs
      ``fused_rows_plain``.
    """
    check_inputs(idx, num_bins, carry)
    n, h, w = idx.shape
    rows = check_rows(row_ids, h)
    if not idx.is_cuda:
        return fused_rows_plain(idx, num_bins, rows, carry)
    # A pinned source lets the copy run ahead of the host (no stream sync).
    slot = row_slot_map(rows, h).pin_memory().to(idx.device, non_blocking=True)
    out = torch.empty((n, num_bins, rows.size, w), dtype=torch.float32,
                      device=idx.device)
    if out.numel() == 0:
        return out
    bb, threads, chunks, _ = launch_shape(w, num_bins, n, bin_block)
    fn = _lib()
    with torch.cuda.device(idx.device):
        err = fn(idx.data_ptr(),
                 None if carry is None else carry.data_ptr(),
                 slot.data_ptr(), out.data_ptr(), n, h, int(rows[-1]) + 1, w,
                 num_bins, rows.size, bb, threads, chunks,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(
            f"fused_rows kernel launch failed: CUDA error {err}")
    fused_rows_cuda.launches += 1
    return out


fused_rows_cuda.launches = 0
