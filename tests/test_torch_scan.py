"""repro_torch scans and kernels held against the JAX reference.

The same numpy inputs go through ``repro`` (CPU, ``backend="jnp"`` or the
Pallas kernels in interpret mode) and through ``repro_torch`` on the CPU,
where the CUDA wrappers run their plain versions.  Every H value is an
integer below 2^24 held in fp32, so every comparison is bit-exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import binning as ref_binning
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.core import binning
from repro_torch.device import as_tensor
from repro_torch.kernels import ops, ref
from repro_torch.kernels.fused_rows import (
    chunk_plan,
    chunk_shape,
    fused_rows_cuda,
    fused_rows_plain,
)
from repro_torch.kernels.wf_tis import launch_shape, wf_tis_cuda, wf_tis_plain

torch.set_num_threads(1)

METHODS = ("cw_b", "cw_sts", "cw_tis", "wf_tis")
# (frame shape, bins): single frames and n = 3 stacks, ragged sizes.
GEOMS = [
    ((1, 1), 1),
    ((5, 7), 8),
    ((3, 32, 48), 32),
    ((3, 97, 131), 8),
]


def _frames(seed, shape, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.random(shape).astype(dtype)


def _carry(seed, shape, bins):
    """Integer-valued fp32 carry of the frame's leading axes."""
    rng = np.random.default_rng(seed + 1)
    return rng.integers(0, 1000, shape[:-2] + (bins, shape[-1])).astype(
        np.float32)


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("with_carry", [False, True])
@pytest.mark.parametrize("shape,bins", GEOMS)
@pytest.mark.parametrize("method", METHODS)
def test_integral_histogram_bit_exact(method, shape, bins, with_carry):
    img = _frames(0, shape)
    carry = _carry(0, shape, bins) if with_carry else None
    want = ref_ops.integral_histogram(
        jnp.asarray(img), bins, method=method, backend="jnp", tile=16,
        carry_in=None if carry is None else jnp.asarray(carry))
    got = ops.integral_histogram(img, bins, method=method, tile=16,
                                 carry_in=carry, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def _boundary_floats(shape, bins):
    """float64 values a hair under each bin edge: float32(x) rounds up
    onto the edge, float64 floor does not, so they pin the cast rule."""
    rng = np.random.default_rng(3)
    edges = rng.integers(1, bins, shape) / bins
    return edges - 1e-12


@pytest.mark.parametrize("kind", ["uint8", "int64", "float32", "float64",
                                  "float64_edges", "bin_ids"])
def test_binning_and_dtype_rules(kind):
    shape, bins = (3, 32, 48), 8
    value_range = 256
    if kind == "uint8":
        img = _frames(1, shape)
    elif kind == "int64":
        img = _frames(1, shape).astype(np.int64)
    elif kind == "float32":
        img = _frames(1, shape, np.float32)
    elif kind == "float64":
        img = _frames(1, shape, np.float64)
    elif kind == "float64_edges":
        img = _boundary_floats(shape, bins)
    else:   # value_range=None: the input is bin ids, PAD_BIN and strays
        img = np.random.default_rng(1).integers(-1, bins + 2, shape)
        value_range = None
    want_idx = ref_binning.bin_indices(jnp.asarray(img), bins, value_range)
    got_idx = binning.bin_indices(as_tensor(img, "cpu"), bins, value_range)
    assert got_idx.dtype == torch.int32
    np.testing.assert_array_equal(_np(got_idx), np.asarray(want_idx))
    want = ref_ops.integral_histogram(jnp.asarray(img), bins, backend="jnp",
                                      value_range=value_range)
    got = ops.integral_histogram(img, bins, value_range=value_range,
                                 device="cpu")
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_one_hot_and_pad_bin():
    assert binning.PAD_BIN == ref_binning.PAD_BIN == -1
    idx = np.array([[0, 2, -1], [1, 3, 2]], np.int32)
    want = ref_binning.one_hot_bins(jnp.asarray(idx), 3)
    got = binning.one_hot_bins(torch.as_tensor(idx), 3)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_oracles_match_reference():
    img = _frames(2, (32, 48))
    np.testing.assert_array_equal(
        _np(ref.integral_histogram_ref(torch.as_tensor(img), 16)),
        np.asarray(ref_ref.integral_histogram_ref(jnp.asarray(img), 16)))
    np.testing.assert_array_equal(
        _np(ref.region_histogram_ref(torch.as_tensor(img), 16, 3, 4, 20, 40)),
        np.asarray(ref_ref.region_histogram_ref(jnp.asarray(img), 16,
                                                3, 4, 20, 40)))


def test_k1_semantics_match_pallas_interpret():
    """K1's wrapper (its plain version on a CPU tensor) against the TPU
    kernel itself, run in interpret mode, carry-in included."""
    img = _frames(4, (2, 64, 96))
    carry = _carry(4, img.shape, 16)
    want = ref_ops.integral_histogram(
        jnp.asarray(img), 16, backend="pallas", tile=32, bin_block=8,
        interpret=True, carry_in=jnp.asarray(carry))
    idx = binning.bin_indices(torch.as_tensor(img), 16)
    got = wf_tis_cuda(idx, 16, carry=torch.as_tensor(carry))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_k2_semantics_match_pallas_interpret():
    img = _frames(5, (2, 64, 96))
    carry = _carry(5, img.shape, 16)
    rows = np.array([0, 7, 31, 32, 40, 63])     # crosses strip edges
    want = ref_ops.fused_corner_rows(
        jnp.asarray(img), 16, rows, backend="pallas", tile=32, bin_block=8,
        interpret=True, carry_in=jnp.asarray(carry))
    idx = binning.bin_indices(torch.as_tensor(img), 16)
    got = fused_rows_cuda(idx, 16, rows, carry=torch.as_tensor(carry))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("shape,rows,with_carry", [
    ((50, 70), (0, 7, 31, 49), False),          # 2D, h < tile
    ((3, 37, 53), (4, 36), True),               # stack, ragged
    ((3, 97, 41), (10, 20, 33, 60), True),      # several bands, early cut
])
def test_fused_corner_rows_bit_exact(shape, rows, with_carry):
    img = _frames(6, shape)
    carry = _carry(6, shape, 8) if with_carry else None
    want_stats, got_stats = {}, {}
    want = ref_ops.fused_corner_rows(
        jnp.asarray(img), 8, np.asarray(rows), backend="jnp", tile=16,
        carry_in=None if carry is None else jnp.asarray(carry),
        stats=want_stats)
    got = ops.fused_corner_rows(img, 8, rows, tile=16, carry_in=carry,
                                stats=got_stats, device="cpu")
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    want_stats["backend"] = "torch"
    assert got_stats == want_stats


def test_fused_early_cut_stats():
    img = _frames(7, (2, 97, 41))
    stats = {}
    ops.fused_corner_rows(img, 4, [3, 20], tile=16, stats=stats,
                          device="cpu")
    assert stats["bands_computed"] == 2 < stats["bands_total"] == 7


def test_row_slot_map_and_plain_k2():
    # The row -> slot map lives in the chunk plan: each chunk that ends a
    # requested row carries that row's output slot.
    first, slot = chunk_plan(np.array([2, 5, 6]), 8)
    assert first.dtype == slot.dtype == np.int32
    assert (first.tolist(), slot.tolist()) == ([0, 3, 6], [0, 1, 2])
    idx = binning.bin_indices(torch.as_tensor(_frames(8, (2, 8, 9))), 4)
    R = fused_rows_plain(idx, 4, [2, 5, 6])
    np.testing.assert_array_equal(_np(R), _np(wf_tis_plain(idx, 4)[..., [2, 5, 6], :]))
    np.testing.assert_array_equal(_np(fused_rows_cuda(idx, 4, [2, 5, 6])), _np(R))
    for bad in ([5, 2], [2, 2], [], [-1, 3], [3, 8]):
        with pytest.raises(ValueError, match="sorted unique"):
            fused_rows_cuda(idx, 4, bad)


# Row sets for K2's chunk plan, (h, rows): the first row, the last row,
# consecutive rows (chunks of one row), a single row, and long segments.
K2_ROW_SETS = {
    "first row": (64, (0, 17, 40)),
    "last row": (64, (5, 33, 63)),
    "consecutive": (64, (20, 21, 22, 23, 50)),
    "single row": (64, (31,)),
    "long segments": (64, (2, 61)),
}


@pytest.mark.parametrize("rows,chunk_rows,first,slot", [
    ((0, 5), 8, [0, 1], [0, 1]),                        # the first row is 0
    ((3, 63), 64, [0, 4], [0, 1]),                      # the last row is h - 1
    ((4, 5, 6), 10, [0, 5, 6], [0, 1, 2]),              # chunks of one row
    ((9,), 4, [0, 3, 6], [-1, -1, 0]),                  # a single row
    ((1, 20), 4, [0, 2, 5, 9, 13, 17], [0, -1, -1, -1, -1, 1]),  # cut at R
    ((1, 20), 64, [0, 2], [0, 1]),                      # whole segments
])
def test_chunk_plan(rows, chunk_rows, first, slot):
    """K2's chunks end at every requested row, hold at most ``chunk_rows``
    rows (a long segment in near-equal pieces), start at row 0, and carry
    every output slot once, in request order."""
    rows = np.asarray(rows)
    got_first, got_slot = chunk_plan(rows, chunk_rows)
    assert got_first.tolist() == first and got_slot.tolist() == slot
    ends = np.append(got_first[1:], rows[-1] + 1)       # one past each chunk
    assert got_first[0] == 0 and np.all(ends > got_first)
    assert np.all(ends - got_first <= chunk_rows)
    assert got_slot[got_slot >= 0].tolist() == list(range(rows.size))
    np.testing.assert_array_equal(ends[got_slot >= 0] - 1, rows)


@pytest.mark.parametrize("n,h,rows,chunks,ctas", [
    (16, 480, "clip", 62, 3968),    # the clip: whole segments, M = K
    (1, 480, "clip", 120, 480),     # one frame, the same rows: cut at 7
    (1, 480, (99, 219), 74, 296),   # one frame, one rect's rows: cut at 3
    (16, 480, "every 4", 120, 7680),    # the fuse bound, h / 4 rows
    (1, 1, (0,), 1, 4),             # a single row cannot be cut
])
def test_chunk_shape_fills_the_card(n, h, rows, chunks, ctas):
    """Pass A runs at least two CTAs an SM of the H100 (132 SMs) where the
    rows allow it: the requested rows' segments alone where they give
    that, else chunks of at most ``h_run // ceil(264 / CTAs a chunk)``
    rows.  The bin block is 8 at 32 bins, one CTA covers 640 columns."""
    rows = np.asarray({"clip": sorted(set(range(7, 480, 8)) | {99, 219}),
                       "every 4": range(3, 480, 4)}.get(rows, rows))
    shape = chunk_shape(640, 32, n, rows.size, int(rows[-1]) + 1)
    assert (shape.bin_block, shape.threads) == (8, 160)
    first, _ = chunk_plan(rows, shape.chunk_rows)
    assert first.size == chunks
    assert n * (32 // shape.bin_block) * chunks == ctas
    assert ctas >= 2 * 132 or rows[-1] + 1 < 264
    assert chunk_shape(5000, 3, 1, 1, 1) == (4, 512, 1)  # 3 slabs of columns
    assert chunk_shape(640, 32, 200, 2, 480).chunk_rows == 255   # one byte
    assert chunk_shape(640, 32, 1, 1, 1, bin_block=2).bin_block == 2
    with pytest.raises(ValueError, match="bin_block"):
        chunk_shape(640, 32, 1, 1, 1, bin_block=3)
    # Any width: pass A walks 20,000 columns in 10 slabs of 2048.
    assert chunk_shape(20000, 8, 1, 1, 1) == (8, 512, 1)


def _chunk_scan(ids, bins, rows, chunk_rows, carry=None):
    """K2's two passes, restated: pass A counts each chunk's hits of each
    bin in every column and scans the counts across the row (P); pass B
    sums P down the chunk axis from the carry row and writes the sum of
    every chunk that ends a requested row at that row's slot."""
    n, h, w = ids.shape
    first, slot = chunk_plan(np.asarray(rows), chunk_rows)
    ends = np.append(first[1:], rows[-1] + 1)
    onehot = (ids[:, None] == torch.arange(bins)[None, :, None, None])
    onehot = onehot.to(torch.float32)                  # (n, bins, h, w)
    P = torch.stack([torch.cumsum(onehot[:, :, a:b].sum(2), -1)
                     for a, b in zip(first, ends)], 2)  # (n, bins, M, w)
    acc = torch.zeros((n, bins, w)) if carry is None else carry.clone()
    out = torch.empty((n, bins, len(rows), w))
    for m in range(first.size):
        acc = acc + P[:, :, m]
        if slot[m] >= 0:
            out[:, :, slot[m]] = acc
    return out


@pytest.mark.parametrize("reference", ["pallas_interpret", "jnp"])
@pytest.mark.parametrize("with_carry", [False, True])
@pytest.mark.parametrize("chunk_rows", [3, 64])
@pytest.mark.parametrize("row_set", sorted(K2_ROW_SETS))
def test_chunk_decomposition_equals_reference(row_set, chunk_rows, with_carry,
                                              reference):
    """K2's chunk passes give the reference's fused corner rows bit for
    bit: its Pallas kernel in interpret mode and its jnp path, with and
    without a carry-in, with long segments cut (3 rows) and whole (64)."""
    h, rows = K2_ROW_SETS[row_set]
    img = _frames(18, (2, h, 96))
    carry = _carry(18, img.shape, 16) if with_carry else None
    kwargs = (dict(backend="pallas", tile=32, bin_block=8, interpret=True)
              if reference == "pallas_interpret" else dict(backend="jnp"))
    want = ref_ops.fused_corner_rows(
        jnp.asarray(img), 16, np.asarray(rows),
        carry_in=None if carry is None else jnp.asarray(carry), **kwargs)
    ids = binning.bin_indices(torch.as_tensor(img), 16)
    got = _chunk_scan(ids, 16, rows, chunk_rows,
                      None if carry is None else torch.as_tensor(carry))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_launch_shape_fits_the_card():
    # (bin_block, threads, 4-column chunks per thread, rows and columns a
    # CTA); no height, no row strips
    assert launch_shape(640, 32, 16) == (1, 160, 1, 0, 640)
    bb, threads, chunks, _, cols = launch_shape(1920, 64, 4)
    assert threads * 4 * chunks >= 1920 and threads <= 1024 and cols == 1920
    bb, threads, chunks, _, _ = launch_shape(8192, 128, 1)
    assert (threads, chunks) == (1024, 2)
    # Past 16,384 columns: two column strips of 10,240 (whole 512-column
    # blocks), the last ragged, 640 threads of 16 columns a strip.
    shape = launch_shape(20000, 8, 1)
    assert shape == (1, 640, 4, 0, 10240) and shape.col_strips(20000) == 2


@pytest.mark.parametrize("n,h,w,bins,strips", [
    (16, 480, 640, 32, 1),      # the clip: 512 CTAs of 5 warps
    (4, 1080, 1920, 64, 1),     # 1080p: 256 CTAs of 15 warps
    (1, 273, 3840, 128, 1),     # a band of the 4K frame: 128 of 30 warps
    (1, 480, 640, 32, 18),      # one frame: 32 CTAs of 5 warps unless cut
    (1, 96, 640, 32, 20),       # the lowest run that is cut
    (1, 95, 640, 32, 1),        # just below the threshold: one strip
    (1, 48, 640, 32, 1),        # a dirty run: a short walk, host-bound
    (1, 1, 640, 32, 1),         # a single row cannot be cut
])
def test_launch_shape_cuts_strips_where_the_card_is_not_filled(
        n, h, w, bins, strips):
    """K1 keeps one strip (one CUDA launch) where frames and bin blocks
    put 8 warps on each of the H100's 132 SMs or the frame is lower than
    96 rows (by the median of chip_smoke's sweeps, strips are slower at
    80 rows and faster at 96), and otherwise cuts the rows into strips so that at least two
    CTAs run per SM."""
    shape = launch_shape(w, bins, n, h=h)
    assert shape.strips(h) == strips
    ctas = shape.ctas(n, bins, h, w)
    if strips == 1:
        assert shape.strip_rows == h
    else:
        assert ctas >= 2 * 132
        assert shape.strip_rows >= 4                   # not needlessly thin
    assert launch_shape(w, bins, n, h=h, strip_rows=7).strip_rows == min(7, h)
    with pytest.raises(ValueError, match="strip_rows"):
        launch_shape(w, bins, n, h=h, strip_rows=0)


def _strip_scan(ids, bins, strip_rows, carry=None):
    """K1's strips, restated: a pre-pass counts each column's hits of each
    bin in every strip but the last; strip s seeds its column counts with
    the carry row's column differences plus the counts of strips above,
    walks its rows, and scans each row across the columns."""
    n, h, w = ids.shape
    onehot = (ids[:, None] == torch.arange(bins)[None, :, None, None])
    onehot = onehot.to(torch.float32)                  # (n, bins, h, w)
    starts = range(0, h, strip_rows)
    counts = [onehot[:, :, r:r + strip_rows].sum(2) for r in starts][:-1]
    seed0 = torch.zeros((n, bins, w))
    if carry is not None:
        seed0 = torch.diff(carry, dim=-1, prepend=torch.zeros((n, bins, 1)))
    out = []
    for s, r in enumerate(starts):
        seed = seed0 + sum(counts[:s], torch.zeros((n, bins, w)))
        V = seed[:, :, None] + torch.cumsum(onehot[:, :, r:r + strip_rows], 2)
        out.append(torch.cumsum(V, 3))
    return torch.cat(out, 2)


@pytest.mark.parametrize("shape,bins,strip_rows,with_carry", [
    ((1, 48, 70), 8, 5, True),       # ragged last strip (3 rows)
    ((1, 48, 70), 8, 48, False),     # one strip: no pre-pass
    ((2, 33, 41), 5, 1, True),       # a strip a row
    ((3, 32, 48), 32, 16, False),    # whole strips
    ((1, 97, 131), 3, 32, True),     # a last strip of one row
])
def test_strip_decomposition_equals_reference(shape, bins, strip_rows,
                                              with_carry):
    """The strip cut K1 makes (counts pre-pass + seeds) gives the
    reference's integral histogram bit for bit, carry-in included."""
    img = _frames(16, shape)
    carry = _carry(16, shape, bins) if with_carry else None
    want = ref_ops.integral_histogram(
        jnp.asarray(img), bins, method="wf_tis", backend="jnp", tile=16,
        carry_in=None if carry is None else jnp.asarray(carry))
    ids = binning.bin_indices(torch.as_tensor(img), bins)
    got = _strip_scan(ids, bins, strip_rows,
                      None if carry is None else torch.as_tensor(carry))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_backend_errors_and_default_device(monkeypatch):
    img = _frames(9, (8, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.integral_histogram(img, 4, backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        ops.integral_histogram(img, 4, backend="pallas", device="cpu")
    # A budget goes through the planner: one band fits, so it is the
    # monolithic H; a budget of two rows bands it, with the same result.
    whole = ops.integral_histogram(img, 4, device="cpu")
    for budget in (1 << 20, 2 * 4 * 4 * 8):
        np.testing.assert_array_equal(
            _np(ops.integral_histogram(img, 4, memory_budget_bytes=budget,
                                       device="cpu")), _np(whole))
    with pytest.raises(ValueError, match="carry_in shape"):
        ops.integral_histogram(img, 4, carry_in=np.zeros((4, 7)),
                               device="cpu")
    # On the card, cw_tis runs its own kernels (K4); an explicit "torch"
    # may still ask for the plain scan.
    card = torch.device("cuda")
    assert ops.resolve_backend("auto", "cw_tis", card) == "cuda"
    assert ops.resolve_backend("cuda", "cw_tis", card) == "cuda"
    assert ops.resolve_backend("torch", "cw_tis", card) == "torch"
    with pytest.raises(ValueError, match="no CUDA kernel"):
        ops.resolve_backend("cuda", "cw_sts", card)
    assert ops.resolve_backend("auto", "wf_tis", card) == "cuda"
    assert ops.resolve_backend("auto", "cw_sts", card) == "torch"
    # No device named and no GPU: raise, never compute on the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.integral_histogram(img, 4)


@pytest.mark.parametrize("bins", [2, 3, 8, 32, 100, 128, 256])
def test_every_byte_bins_as_the_reference(bins):
    """Each of the 256 byte values lands in the reference's bin, at bin
    counts that are powers of two (the two-pass shift) and others."""
    img = np.arange(256, dtype=np.uint8).reshape(16, 16)
    want = ref_binning.bin_indices(jnp.asarray(img), bins, 256)
    got = binning.bin_indices(torch.as_tensor(img), bins, 256)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_array_equal(_np(got), img.astype(np.int64) * bins
                                  // 256)
