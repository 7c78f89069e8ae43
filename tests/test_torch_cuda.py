"""repro_torch's CUDA kernels against their plain versions, on the GPU.

Every test here needs a CUDA device and skips without one; the skip is
decided when the test runs, not when the module is imported.  This file
imports neither JAX nor the reference, so it runs on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core.engine import HistogramEngine, RegionQuery
from repro_torch.kernels.fused_rows import fused_rows_cuda
from repro_torch.kernels.wf_tis import wf_tis_cuda, wf_tis_plain

torch.set_num_threads(1)


def _carry(seed, shape, bins):
    rng = np.random.default_rng(seed + 1)
    return rng.integers(0, 1000, shape[:-2] + (bins, shape[-1])).astype(
        np.float32)


@pytest.fixture
def cuda_device():
    """Skip unless a GPU is present (decided at run time, not import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("n,h,w,bins,with_carry", [
    (1, 1, 1, 1, False), (3, 97, 131, 32, True), (2, 33, 4099, 3, True),
])
def test_cuda_kernels_equal_plain(cuda_device, n, h, w, bins, with_carry):
    rng = np.random.default_rng(10)
    idx = torch.as_tensor(rng.integers(-1, bins + 1, (n, h, w)),
                          dtype=torch.int32, device=cuda_device)
    carry = (torch.as_tensor(_carry(10, (n, h, w), bins), device=cuda_device)
             if with_carry else None)
    before = wf_tis_cuda.launches
    H = wf_tis_cuda(idx, bins, carry=carry)
    assert wf_tis_cuda.launches > before
    want = wf_tis_plain(idx, bins, carry)
    assert torch.equal(H, want)
    rows = np.unique(rng.integers(0, h, 5))
    R = fused_rows_cuda(idx, bins, rows, carry=carry)
    assert torch.equal(R, want[..., torch.as_tensor(rows, device=cuda_device), :])


def test_engine_on_the_card_launches_the_kernels(cuda_device):
    frames = np.random.default_rng(11).integers(0, 256, (2, 64, 80),
                                                np.uint8)
    eng = HistogramEngine(num_bins=8)

    def counted(*args):
        # Each path's own counts: set to 0 just before, read just after.
        wf_tis_cuda.launches = fused_rows_cuda.launches = 0
        out = eng.run(frames, *args)
        return out, (wf_tis_cuda.launches, fused_rows_cuda.launches)

    fused, fused_counts = counted([RegionQuery(np.array([[3, 4, 40, 60]]))])
    dense, dense_counts = counted()
    assert fused.plan.representation == "fused"
    assert dense.plan.representation == "dense"
    assert fused_counts == (0, 1)        # (wf_tis, fused_rows)
    assert dense_counts == (1, 0)
    plain = HistogramEngine(num_bins=8, backend="torch").run(
        frames, [RegionQuery(np.array([[3, 4, 40, 60]]))])
    assert torch.equal(fused.results[0], plain.results[0])
