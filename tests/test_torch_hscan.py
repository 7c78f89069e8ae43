"""K4's hscan as the card runs it, restated in torch and held against the
reference.

csrc/cw_tis.cu's ``hscan_kernel`` gives each warp one unit, a (frame, row,
block of bins), and walks the row in chunks of 128 columns, lane l holding
columns 128 k + 4 l .. + 3 of chunk k.  Per chunk a lane counts its hits
of each bin in 8-bit fields (4 bins a 32-bit word), scans the words
across the warp with five shuffle-up steps, and adds each bin's running
row total, which it keeps in a register and grows by the chunk's total
from lane 31.  Ids past the row (the masked tail chunk) read as -1.  The
kernel does not run here, so these tests hold

  * ``_hscan_restated``, that walk in torch, through the port's plain
    vscan, bit-equal to the reference's ``integral_histogram(method=
    "cw_tis")`` (``backend="jnp"``, and its Pallas kernels in interpret
    mode on one shape) at widths 1, 127, 128, 129, 4099 and 16,385 at
    every bin block;
  * the restatement's ``hh`` bit-equal to ``cw_tis_hscan_plain``, with
    ids of -1 and ``num_bins`` that match no bin;
  * the launch choice: the bin block, the warps a CTA and the grid cap at
    chip_smoke's ``TALL_SHAPE`` and past it.

Every value is an integer below 2^24 held in fp32, so every comparison is
exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.core import binning
from repro_torch.kernels import cw_tis
from repro_torch.kernels.cw_tis import (
    HSCAN_CHUNK,
    HSCAN_WARPS,
    cw_tis_hscan_cuda,
    cw_tis_hscan_plain,
    cw_tis_vscan_plain,
    hscan_ctas,
    hscan_shape,
)

torch.set_num_threads(1)

LANES = 32
WIDTHS = (1, 127, 128, 129, 4099, 16385)
BIN_BLOCKS = (1, 2, 4, 8)
TALL_SHAPE = (1, 600000, 16, 16)        # chip_smoke.TALL_SHAPE


def _shfl_up(x, s):
    """``__shfl_up_sync(x, s)`` over the lane axis (last), as the kernel
    uses it: lanes below ``s`` add nothing."""
    t = torch.zeros_like(x)
    t[..., s:] = x[..., :-s]
    return t


def _hscan_restated(ids: torch.Tensor, num_bins: int,
                    bin_block: int) -> torch.Tensor:
    """csrc/cw_tis.cu's hscan_kernel in torch, every unit at once: (n, h,
    w) int32 ids -> (n, num_bins, h, w) fp32 hh."""
    assert HSCAN_CHUNK == 4 * LANES
    n, h, w = ids.shape
    chunks = -(-w // HSCAN_CHUNK)
    padded = torch.full((n, h, chunks * HSCAN_CHUNK), -1, dtype=torch.int64)
    padded[..., :w] = ids                     # load_ids: -1 past the row
    # (n, h, chunk, lane, e): column 128 chunk + 4 lane + e.
    lanes = padded.view(n, h, chunks, LANES, 4)
    words = -(-bin_block // 4)
    hh = torch.empty((n, num_bins, h, chunks * HSCAN_CHUNK))
    for b0 in range(0, num_bins, bin_block):
        d = lanes - b0
        # add_hit: 1 in field d % 4 of word d / 4 for d in [0, bin_block).
        one = torch.where((d >= 0) & (d < bin_block), 1 << (8 * (d & 3)), 0)
        cnt = [torch.where(d // 4 == k, one, 0).sum(-1) for k in range(words)]
        incl = list(cnt)
        for s in (1, 2, 4, 8, 16):
            incl = [x + _shfl_up(x, s) for x in incl]
        total = [x[..., LANES - 1] for x in incl]     # __shfl_sync(.., 31)
        for j in range(min(bin_block, num_bins - b0)):
            k, sh = j >> 2, 8 * (j & 3)
            excl = ((incl[k] - cnt[k]) >> sh) & 0xFF  # (n, h, chunk, lane)
            tot = (total[k] >> sh) & 0xFF             # (n, h, chunk)
            hit = (d == j).float()
            run = torch.zeros((n, h, 1))              # the register carry
            out = torch.empty((n, h, chunks, LANES, 4))
            for c in range(chunks):
                o = run + excl[:, :, c].float() + hit[:, :, c, :, 0]
                out[:, :, c, :, 0] = o
                for e in (1, 2, 3):
                    o = o + hit[:, :, c, :, e]
                    out[:, :, c, :, e] = o
                run = run + tot[:, :, c, None].float()
            hh[:, b0 + j] = out.view(n, h, -1)
    return hh[..., :w].contiguous()


def _frames(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


@pytest.mark.parametrize("bin_block", BIN_BLOCKS)
@pytest.mark.parametrize("w", WIDTHS)
def test_restated_hscan_equals_the_reference(w, bin_block):
    """11 bins: a ragged last block at every bin block but 1."""
    bins = 11
    shape = (2, 2, w) if w < 4096 else (1, 2, w)
    img = _frames(w, shape)
    want = ref_ops.integral_histogram(jnp.asarray(img), bins,
                                      method="cw_tis", backend="jnp")
    ids = binning.bin_indices(torch.as_tensor(img), bins).contiguous()
    hh = _hscan_restated(ids, bins, bin_block)
    assert np.array_equal(cw_tis_vscan_plain(hh).numpy(), np.asarray(want))


def test_restated_hscan_equals_the_references_pallas_kernels():
    """The reference's two Pallas kernels (interpret mode) tile a 3 x 129
    frame into 128-column tiles with a row carry between them."""
    img = _frames(7, (1, 3, 129))
    want = ref_ops.integral_histogram(jnp.asarray(img), 16, method="cw_tis",
                                      backend="pallas", interpret=True)
    ids = binning.bin_indices(torch.as_tensor(img), 16).contiguous()
    hh = _hscan_restated(ids, 16, hscan_shape(16)[0])
    assert np.array_equal(cw_tis_vscan_plain(hh).numpy(), np.asarray(want))


@pytest.mark.parametrize("bin_block", BIN_BLOCKS)
@pytest.mark.parametrize("w", [1, 129, 300])
def test_restated_hscan_equals_plain_past_the_bins(w, bin_block):
    """Ids of -1 and num_bins match no bin; a row of one bin puts 128
    hits in a field each chunk, the most a chunk holds (a field holds
    255)."""
    bins = 6
    rng = np.random.default_rng(w + bin_block)
    ids = torch.as_tensor(rng.integers(-1, bins + 1, (2, 3, w)),
                          dtype=torch.int32)
    ids[1, 0] = 2                       # 128 hits of one bin a chunk
    assert torch.equal(_hscan_restated(ids, bins, bin_block),
                       cw_tis_hscan_plain(ids, bins))


def test_hscan_launch_choice():
    """The largest bin block of 8, 4, 2, 1 that the bins fill, 8 warps a
    CTA at any shape, one warp a (frame, row, bin block)."""
    for bins, bb in ((1, 1), (2, 2), (3, 2), (4, 4), (7, 4), (8, 8),
                     (32, 8), (256, 8)):
        assert hscan_shape(bins) == (bb, HSCAN_WARPS)
    assert hscan_shape(32, bin_block=2) == (2, HSCAN_WARPS)
    with pytest.raises(ValueError, match="bin_block"):
        hscan_shape(32, bin_block=3)
    assert HSCAN_WARPS == 8
    # The clip: 16 x 480 rows x 4 bin blocks of 8, 8 warps a CTA.
    assert hscan_ctas(16, 480, 32, 8, 8) == 16 * 480 * 4 // 8
    assert hscan_ctas(1, 1, 1, 1, 8) == 1


def test_hscan_grid_cap_at_tall_shape_and_past_it():
    """600,000 rows of 16 columns at 16 bins: 1,200,000 units in 150,000
    CTAs.  Past 2^31 - 1 CTAs the wrapper raises before any launch (meta
    tensors: no memory); at 2^31 - 1 it passes."""
    n, h, w, bins = TALL_SHAPE
    bb, warps = hscan_shape(bins)
    assert hscan_ctas(n, h, bins, bb, warps) == 150_000
    hh = cw_tis_hscan_cuda(torch.empty(TALL_SHAPE[:3], dtype=torch.int32,
                                       device="meta"), bins)
    assert tuple(hh.shape) == (n, bins, h, w)
    limit = 2**31 - 1
    ok = torch.empty((limit, 8, 1), dtype=torch.int32, device="meta")
    assert hscan_ctas(limit, 8, 8, 8, 8) == limit
    assert tuple(cw_tis_hscan_cuda(ok, 8).shape) == (limit, 8, 8, 1)
    past = torch.empty((limit, 8, 1), dtype=torch.int32, device="meta")
    with pytest.raises(NotImplementedError, match="grid"):
        cw_tis_hscan_cuda(past, 9)      # two bin blocks: twice the CTAs


def test_hscan_meta_launch_counts_no_launch():
    """A meta call runs the launch's checks and counts nothing."""
    before = cw_tis.cw_tis_hscan_cuda.launches
    cw_tis_hscan_cuda(torch.empty((2, 5, 4099), dtype=torch.int32,
                                  device="meta"), 11)
    assert cw_tis.cw_tis_hscan_cuda.launches == before
