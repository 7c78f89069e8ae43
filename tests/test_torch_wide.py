"""Frames wider than one CTA's 16,384 columns, held against the reference.

K1 cuts such a frame into column strips with a row-count pre-pass, K4's
hscan walks each row in 128-column chunks, and K2's pass A takes any width in
2048-column slabs; none of them runs here, so these tests hold

  * the port's plain versions (what a CPU tensor runs) bit-equal to the
    reference at 16,385, 20,001 and 32,768 columns, the reference with
    ``backend="jnp"`` and, at one 1 x 3 x 16,385 case, its Pallas K1 in
    interpret mode: ``integral_histogram`` under ``wf_tis`` and
    ``cw_tis`` with and without a carry, ``fused_corner_rows``, a banded
    run whose carry crosses a column strip, ``engine.run``;
  * K1's cut, restated in torch from csrc/wf_tis.cu (count pre-pass with
    block totals, row-count pre-pass, seeded walks, the virtual column
    left of each strip), bit-equal to the reference;
  * the launch choices (``launch_shape``, ``chunk_shape``, ``hscan_shape``)
    raising for no width, K4's hscan for no height, and K1's strip count
    within the grid for every shape ``launch_shape`` picks.

Every H value is an integer below 2^24 held in fp32, so every comparison
is ``np.array_equal``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core import engine as ref_engine
from repro.kernels import ops as ref_ops
from repro_torch.core import binning, engine
from repro_torch.kernels import ops, wf_tis
from repro_torch.kernels.cw_tis import cw_tis_hscan_cuda, hscan_shape
from repro_torch.kernels.fused_rows import chunk_shape
from repro_torch.kernels.wf_tis import column_split, launch_shape

torch.set_num_threads(1)

#: (frame shape, bins): past one CTA by one column, a ragged width, two
#: whole strips.
WIDE = [((2, 3, 16385), 4), ((1, 5, 20001), 16), ((2, 2, 32768), 8)]


def _frames(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _carry(seed, shape, bins):
    """Integer-valued fp32 carry of the frame's leading axes."""
    rng = np.random.default_rng(seed + 1)
    return rng.integers(0, 1000, shape[:-2] + (bins, shape[-1])).astype(
        np.float32)


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _ref_carry(carry):
    return None if carry is None else jnp.asarray(carry)


@pytest.mark.parametrize("with_carry", [False, True])
@pytest.mark.parametrize("method", ["wf_tis", "cw_tis"])
@pytest.mark.parametrize("shape,bins", WIDE, ids=[str(s) for s, _ in WIDE])
def test_wide_integral_histogram_equals_reference(shape, bins, method,
                                                  with_carry):
    img = _frames(1, shape)
    carry = _carry(1, shape, bins) if with_carry else None
    want = ref_ops.integral_histogram(
        jnp.asarray(img), bins, method=method, backend="jnp",
        carry_in=_ref_carry(carry))
    got = ops.integral_histogram(img, bins, method=method, carry_in=carry,
                                 device="cpu")
    assert np.array_equal(_np(got), np.asarray(want))


def test_wide_k1_equals_the_references_pallas_kernel():
    """The reference's K1 (``wf_tis_pallas``, interpret mode) tiles a
    16,385-column frame with row carries between its column tiles."""
    img = _frames(2, (1, 3, 16385))
    want = ref_ops.integral_histogram(
        jnp.asarray(img), 8, backend="pallas", interpret=True)
    got = ops.integral_histogram(img, 8, device="cpu")
    assert np.array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("with_carry", [False, True])
@pytest.mark.parametrize("shape,bins", WIDE, ids=[str(s) for s, _ in WIDE])
def test_wide_fused_corner_rows_equal_reference(shape, bins, with_carry):
    img = _frames(3, shape)
    carry = _carry(3, shape, bins) if with_carry else None
    rows = np.array(sorted({0, shape[-2] - 1}))
    want = ref_ops.fused_corner_rows(jnp.asarray(img), bins, rows,
                                     backend="jnp",
                                     carry_in=_ref_carry(carry))
    got = ops.fused_corner_rows(img, bins, rows, carry_in=carry,
                                device="cpu")
    assert np.array_equal(_np(got), np.asarray(want))


def test_wide_banded_run_carries_across_column_strips():
    """A budget of two rows of H bands a 6 x 20,001 frame: each band's
    carry row spans both of K1's column strips."""
    img = _frames(4, (6, 20001))
    bins = 8
    budget = 2 * 4 * bins * 20001
    want = ref_ops.integral_histogram(jnp.asarray(img), bins, backend="jnp",
                                      memory_budget_bytes=budget)
    got = ops.integral_histogram(img, bins, memory_budget_bytes=budget,
                                 device="cpu")
    assert np.array_equal(_np(got), np.asarray(want))


def test_wide_engine_run_equals_reference():
    frames = _frames(5, (2, 3, 20001))
    rects = np.array([[0, 0, 2, 20000], [1, 10000, 2, 10300],
                      [0, 16380, 2, 16390]])

    def run(mod, **kw):
        return mod.HistogramEngine(num_bins=8, **kw).run(
            frames, [mod.RegionQuery(rects)])

    want = run(ref_engine, backend="jnp")
    got = run(engine, device="cpu")
    assert got.plan.representation == want.plan.representation
    assert np.array_equal(_np(got.results[0]), np.asarray(want.results[0]))


def _k1_restated(ids, bins, strip_rows, strip_cols, col_block, carry=None):
    """K1 cut into row strips of ``strip_rows`` and column strips of
    ``strip_cols`` (whole blocks of ``col_block``), restated from
    csrc/wf_tis.cu: count_kernel counts each column of every row strip but
    the last and sums each block of ``col_block`` columns; row_count_kernel
    counts each row of every column strip but the last; a scan CTA seeds
    its columns from the carry (undifferenced at its first column) and the
    counts above, and its first column also carries a virtual column: the
    corner above and to the left (block totals) plus, at each row, the
    row counts of the strips to its left."""
    n, h, w = ids.shape
    oh = (ids[:, None] == torch.arange(bins)[None, :, None, None]).float()
    row0s, col0s = range(0, h, strip_rows), range(0, w, strip_cols)
    ncb = -(-w // col_block)
    counts = [oh[:, :, r:r + strip_rows].sum(2) for r in row0s][:-1]
    corners = [F.pad(c, (0, ncb * col_block - w)).reshape(
        n, bins, ncb, col_block).sum(-1) for c in counts]
    rowcnt = [oh[..., c:c + strip_cols].sum(-1) for c in col0s][:-1]
    out = torch.empty((n, bins, h, w))
    for s, r0 in enumerate(row0s):
        r1 = min(h, r0 + strip_rows)
        for j, c0 in enumerate(col0s):
            c1 = min(w, c0 + strip_cols)
            seed = torch.zeros((n, bins, c1 - c0))
            if carry is not None:
                seed = torch.diff(carry[..., c0:c1], dim=-1,
                                  prepend=torch.zeros((n, bins, 1)))
            for c in counts[:s]:
                seed = seed + c[..., c0:c1]
            V = seed[:, :, None] + torch.cumsum(oh[:, :, r0:r1, c0:c1], 2)
            if j > 0:
                corner = torch.zeros((n, bins))
                for t in corners[:s]:
                    corner = corner + t[..., :c0 // col_block].sum(-1)
                left = sum(rowcnt[:j])[:, :, r0:r1]
                V[..., 0] += corner[..., None] + torch.cumsum(left, 2)
            out[:, :, r0:r1, c0:c1] = torch.cumsum(V, 3)
    return out


_REAL = column_split(16385)[0]
#: (shape, bins, strip_rows, strip_cols, col_block): ragged last strips
#: both ways, one row strip, a strip of one column, and K1's own cut of a
#: 16,385-column frame (two strips of 8,704 columns, blocks of 512).
CUTS = [
    ((1, 12, 40), 5, 5, 16, 8),
    ((2, 9, 33), 3, 4, 8, 4),
    ((1, 7, 24), 4, 7, 8, 8),
    ((1, 6, 17), 2, 2, 16, 8),
    ((1, 3, 16385), 4, 2, _REAL, wf_tis._COL_BLOCK),
]


@pytest.mark.parametrize("with_carry", [False, True])
@pytest.mark.parametrize("shape,bins,strip_rows,strip_cols,col_block", CUTS)
def test_column_strip_decomposition_equals_reference(
        shape, bins, strip_rows, strip_cols, col_block, with_carry):
    """K1's cut into row and column strips gives the reference's integral
    histogram bit for bit, with a non-zero carry at every strip
    boundary."""
    img = _frames(6, shape)
    carry = _carry(6, shape, bins) if with_carry else None
    want = ref_ops.integral_histogram(
        jnp.asarray(img), bins, backend="jnp", carry_in=_ref_carry(carry))
    ids = binning.bin_indices(torch.as_tensor(img), bins)
    got = _k1_restated(ids, bins, strip_rows, strip_cols, col_block,
                       None if carry is None else torch.as_tensor(carry))
    assert np.array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("w", [16384, 16385, 20001, 32768, 40003, 600000,
                               1 << 24])
def test_every_launch_choice_takes_any_width(w):
    """Column strips of at most 16,384 columns, whole 512-column blocks
    but the last; K2 and K4's hscan take the width as it is (the hscan's
    launch does not depend on it)."""
    cols, threads, chunks = column_split(w)
    strips = -(-w // cols)
    assert cols <= 16384 and threads * 4 * chunks >= cols and threads <= 1024
    assert strips == -(-w // 16384)
    if strips > 1:
        assert cols % 512 == 0 and chunks == 4
    shape = launch_shape(w, 32, 4, h=480)
    assert shape.strip_cols == cols and shape.col_strips(w) == strips
    assert hscan_shape(32) == (8, 8)
    assert chunk_shape(w, 32, 4, 2, 480).threads == 512


@pytest.mark.parametrize("n", [1, 4, 64])
@pytest.mark.parametrize("bins", [1, 32, 256])
def test_launch_shape_keeps_the_strips_within_the_grid(n, bins):
    """K1's cut never asks for more than 65,535 row strips or bin blocks,
    nor more than 2^31 - 1 frames x column strips, for a frame of up to
    2^24 pixels at any width: only an explicit ``strip_rows`` can."""
    for w in (1, 640, 16385, 40003, 1 << 20, 1 << 24):
        for h in {1, 95, 96, 480, (1 << 24) // w}:
            shape = launch_shape(w, bins, n, h=h)
            assert shape.strips(h) <= 65535
            assert -(-bins // shape.bin_block) <= 65535
            assert n * shape.col_strips(w) < 2**31
    with pytest.raises(NotImplementedError, match="row strips"):
        launch_shape(640, 8, 1, h=1 << 20, strip_rows=1)


def test_hscan_takes_any_height():
    """Row groups lie on grid x: a 1 x 600,000 x 16 frame (9.6 Mpx) passes
    the hscan's checks (meta tensors: no memory, no launch)."""
    ids = torch.empty((1, 600000, 16), dtype=torch.int32, device="meta")
    hh = cw_tis_hscan_cuda(ids, 16)
    assert tuple(hh.shape) == (1, 16, 600000, 16)
