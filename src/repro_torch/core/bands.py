"""Band-streamed integral histograms under a memory budget.

Port of ``repro/core/bands.py``.  The paper's scale scenario (§4.6) is a
frame whose (b, h, w) H does not fit beside everything else on the card.
This module streams it as row bands through the carry-aware kernels: an
integral histogram is a prefix sum over rows, so for a band starting at
row r0

    H[r, c, b] = H_band[r - r0, c, b] + H[r0 - 1, c, b]

and the whole cross-band dependency is one (..., b, w) bottom-row carry,
handed to the next band's launch of K1 (``kernels/wf_tis.py``) or K4
(``kernels/cw_tis.py``) as its ``carry``.  All arithmetic is
integer-valued fp32 (exact below 2**24 counts), so banded results equal
the monolithic ones bit for bit.

Three ways to consume the stream, none of which holds the (b, h, w) H:

  * stream — ``iter_banded_ih`` yields ``BandH`` chunks, each on the
    device that computed it;
  * spill  — ``spill_banded_ih`` copies every band to host memory under a
    storage policy (``float32``, or the modular ``uint32``/``uint16``);
  * reduce — ``reduce_banded_ih`` folds bands while holding one.

The band loop is ``runtime.FrameRuntime`` with the bottom-row carry
threaded between dispatches; ``prefetch >= 1`` stages the next bands' rows
through pinned buffers on a copy stream while the current band's kernel
runs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch.core.hsource import HSource, ShardedH
from repro_torch.kernels.ops import integral_histogram

# fp32 represents consecutive integers exactly only below 2**24; beyond it
# the accumulated counts themselves (not just a storage cast) are wrong.
FP32_EXACT_COUNT = 1 << 24

# Storage policies for spilled bands: numpy dtype + the largest region
# pixel count a four-corner query is guaranteed exact for.  Integer
# policies wrap modulo 2**bits, and modular arithmetic cancels the wrap
# for any query whose true count fits, so the bound is on the *queried
# region*, not the frame.
STORAGE_POLICIES = {
    "float32": (np.float32, FP32_EXACT_COUNT - 1),
    "uint32": (np.uint32, (1 << 32) - 1),
    "uint16": (np.uint16, (1 << 16) - 1),
}


def validate_storage_policy(storage: str, h: int, w: int) -> None:
    """Validate a spill policy against the count bound of an (h, w) frame.

    The kernels accumulate in fp32, so a frame of 2**24 pixels or more has
    inexact counts before storage even starts and no policy recovers
    them.  ``uint16``'s <= 65535-pixel *region* bound is enforced at query
    time (``HSource._check_region_bound``)."""
    if storage not in STORAGE_POLICIES:
        raise ValueError(
            f"unknown storage policy {storage!r} "
            f"(valid: {sorted(STORAGE_POLICIES)})")
    if h * w >= FP32_EXACT_COUNT:
        raise ValueError(
            f"{h}x{w} frame accumulates counts up to {h * w}, beyond the "
            f"fp32 exact-integer range 2**24; no storage policy recovers "
            "exactness — use spatial sharding (core/distributed.py)")


@dataclasses.dataclass(frozen=True)
class BandPlan:
    """Row-band decomposition of an (h, w) frame under a memory budget."""

    spans: tuple[tuple[int, int], ...]  # [r0, r1) per band
    band_h: int                         # nominal rows per band
    band_bytes: int                     # largest band's H footprint
    full_h_bytes: int                   # the monolithic (n, b, h, w) H

    @property
    def num_bands(self) -> int:
        return len(self.spans)


def plan_bands(
    h: int,
    w: int,
    num_bins: int,
    *,
    band_h: int | None = None,
    memory_budget_bytes: int | None = None,
    num_frames: int = 1,
    itemsize: int = 4,
    row_multiple: int = 1,
) -> BandPlan:
    """Choose band spans from an explicit ``band_h`` or a byte budget.

    The budget caps the per-band H footprint
    ``itemsize * num_frames * num_bins * band_h * w``; ``row_multiple``
    rounds the band height down to a multiple of it."""
    if band_h is None:
        if memory_budget_bytes is None:
            band_h = h
        else:
            per_row = itemsize * num_frames * num_bins * w
            band_h = memory_budget_bytes // per_row
            if band_h < max(1, row_multiple):
                raise ValueError(
                    f"memory_budget_bytes={memory_budget_bytes} below one "
                    f"{max(1, row_multiple)}-row band "
                    f"({per_row * max(1, row_multiple)} bytes at "
                    f"{num_frames}x{num_bins} bins x width {w})")
    band_h = min(int(band_h), h)
    if row_multiple > 1:
        band_h -= band_h % row_multiple
    if band_h < 1:
        raise ValueError(f"band_h must be >= 1, got {band_h}")
    spans = tuple((r, min(r + band_h, h)) for r in range(0, h, band_h))
    per_row = itemsize * num_frames * num_bins * w
    return BandPlan(spans=spans, band_h=band_h, band_bytes=per_row * band_h,
                    full_h_bytes=per_row * h)


@dataclasses.dataclass(frozen=True)
class BandH:
    """One streamed band of an integral histogram.

    ``H`` is the full-frame H restricted to rows [r0, r1), shape
    (..., b, r1 - r0, w), on the device that computed it; ``carry`` is its
    bottom row (..., b, w), the only state the next band needs.  A
    sharded band (``distributed.iter_banded_sharded_ih``) holds a
    ``ShardedH`` and one bottom row a bin shard.  ``frame_h`` is the full
    frame height."""

    index: int
    num_bands: int
    r0: int
    r1: int
    frame_h: int
    H: torch.Tensor
    carry: torch.Tensor

    @property
    def nbytes(self) -> int:
        return self.H.nbytes


def iter_banded_ih(
    image,
    num_bins: int,
    *,
    band_h: int | None = None,
    memory_budget_bytes: int | None = None,
    plan: BandPlan | None = None,
    carry_in=None,
    compute_fn: Callable | None = None,
    prefetch: int = 0,
    device=None,
    method: str = "wf_tis",
    backend: str = "auto",
    tile: int = 128,
    bin_block: int | None = None,
    value_range: int | None = 256,
) -> Iterator[BandH]:
    """Stream the integral histogram of ``image`` as row bands.

    ``image`` is (h, w) or (n, h, w), a numpy array or a tensor; a host
    frame stays on the host and only each band's rows are copied to
    ``device`` (``None`` = the card) when that band computes.  Bands follow
    ``plan`` or are planned from ``band_h`` / ``memory_budget_bytes``; the
    bottom row of each band is the next band's ``carry_in``.

    ``compute_fn(band_image, carry_in) -> H_band`` overrides the kernel
    call.  ``prefetch >= 1`` keeps that many band slices staged on the
    device ahead of the one computing (``runtime.Stager``: pinned host
    buffers, a copy stream, an event the compute stream waits on).
    ``device`` may be a ``runtime.MeshPlacement`` with a sharded
    ``compute_fn`` (``distributed.iter_banded_sharded_ih``): staged
    slices then reach it as ``Placed`` strips, as the single-device
    stream's reach its kernel."""
    from repro_torch.core.runtime import FrameRuntime, check_placement

    check_placement(device)
    h, w = image.shape[-2:]
    num_frames = int(np.prod(image.shape[:-2], dtype=np.int64)) or 1
    if plan is None:
        plan = plan_bands(h, w, num_bins, band_h=band_h,
                          memory_budget_bytes=memory_budget_bytes,
                          num_frames=num_frames)
    if compute_fn is None:
        def compute_fn(band_img, carry):
            return integral_histogram(
                band_img, num_bins, method=method, backend=backend,
                tile=tile, bin_block=bin_block, value_range=value_range,
                carry_in=carry, device=device)

    def step(band_img, carry):
        H_band = compute_fn(band_img, carry)
        if isinstance(H_band, ShardedH):
            return H_band, H_band.bottom_rows()
        return H_band, H_band[..., -1, :]

    runtime = FrameRuntime(
        step, depth=1, carry_in=carry_in, device=device,
        stage_inputs=prefetch >= 1, stage_ahead=max(prefetch, 0),
        block=False)
    slices = (image[..., r0:r1, :] for r0, r1 in plan.spans)
    for d in runtime.run(slices, batched=False,
                         meta=lambda i, c, ch: plan.spans[i]):
        r0, r1 = d.meta
        yield BandH(index=d.index, num_bands=plan.num_bands, r0=r0, r1=r1,
                    frame_h=h, H=d.out, carry=d.carry)


def banded_integral_histogram(image, num_bins: int, **kwargs) -> torch.Tensor:
    """Full H assembled from the band stream: the target of
    ``integral_histogram(memory_budget_bytes=...)``.  The result still
    materializes, but each launch's working set is one band.  Bands are
    copied into one preallocated H on their device as they arrive, so the
    peak is H plus one band."""
    out = None
    for band in iter_banded_ih(image, num_bins, **kwargs):
        if out is None:
            shape = band.H.shape[:-2] + (band.frame_h, band.H.shape[-1])
            out = band.H.new_empty(shape)
        out[..., band.r0:band.r1, :] = band.H
    return out


def reduce_banded_ih(image, num_bins: int, reduce_fn, init=None, **kwargs):
    """Fold ``reduce_fn(acc, band)`` over the band stream — O(band) memory."""
    acc = init
    for band in iter_banded_ih(image, num_bins, **kwargs):
        acc = reduce_fn(acc, band)
    return acc


def _modular_bits(storage: str) -> int | None:
    """2**bits wrap of an integer policy, ``None`` for float32."""
    dtype, _ = STORAGE_POLICIES[storage]
    if dtype is np.float32:
        return None
    return np.iinfo(dtype).bits


@dataclasses.dataclass
class SpilledIH(HSource):
    """A banded integral histogram spilled to host memory under a storage
    policy.

    ``bands[i]`` holds rows ``spans[i]`` as a host numpy array
    (..., b, bh, w) in the policy dtype.  Integer policies store H modulo
    2**bits; four-corner queries run in the same modular ring, so any
    region whose true count fits the dtype reads back exactly (``uint16``:
    <= 65535 pixels).

    torch has no arithmetic on ``uint16``/``uint32`` tensors, so ``rows()``
    widens integer policies to int64 and every query reduces its
    four-corner result modulo 2**bits before the fp32 cast: the values are
    those of the reference's arithmetic in the policy dtype itself.
    Queries run on the host, where the spill lives.

    ``carries`` keeps each band's true-valued fp32 bottom row (..., b, w):
    the carry chain the incremental video path (core/delta.py) threads
    through clean bands, which the wrapped integer bands cannot give back.
    ``None`` means not updatable."""

    num_bins: int
    height: int
    width: int
    lead: tuple
    storage: str
    spans: tuple[tuple[int, int], ...]
    bands: list
    carries: list | None = None

    device = torch.device("cpu")

    @property
    def nbytes(self) -> int:
        total = sum(b.nbytes for b in self.bands)
        if self.carries is not None:
            total += sum(c.nbytes for c in self.carries)
        return total

    @property
    def exact_region_bound(self) -> int:
        return STORAGE_POLICIES[self.storage][1]

    def _band_of(self, r: int) -> int:
        for i, (r0, r1) in enumerate(self.spans):
            if r0 <= r < r1:
                return i
        raise IndexError(f"row {r} outside frame of height {self.height}")

    def rows(self, row_ids) -> torch.Tensor:
        """Full-frame H rows (..., b, len(row_ids), w) on the host: fp32
        for ``float32``, the stored modular values widened to int64 for
        the integer policies."""
        dtype, _ = STORAGE_POLICIES[self.storage]
        wide = np.float32 if dtype is np.float32 else np.int64
        out = np.empty(self.lead + (self.num_bins, len(row_ids), self.width),
                       wide)
        for k, r in enumerate(row_ids):
            i = self._band_of(int(r))
            out[..., k, :] = self.bands[i][..., int(r) - self.spans[i][0], :]
        return torch.from_numpy(out)

    def _reduce(self, x: torch.Tensor) -> torch.Tensor:
        bits = _modular_bits(self.storage)
        return x if bits is None else torch.remainder(x, 1 << bits)

    def assemble(self) -> np.ndarray:
        """Materialize full (..., b, h, w) H as fp32 (small frames only)."""
        return np.concatenate([b.astype(np.float32) for b in self.bands],
                              axis=-2)

    def dense(self) -> torch.Tensor:
        return torch.from_numpy(self.assemble())

    def update_bands(self, next_frame, report, *, recompute,
                     apply_fn=None) -> "SpilledIH":
        """The incremental-video hook (core/delta.py): a new SpilledIH for
        ``next_frame`` in the same storage policy.  ``apply_fn`` is
        accepted for hook-signature uniformity; the spill updates on the
        host."""
        from repro_torch.core import delta as delta_mod

        del apply_fn
        return delta_mod.update_spilled_ih(self, next_frame, report,
                                           recompute=recompute)


def to_storage(H: torch.Tensor, storage: str) -> np.ndarray:
    """A band's fp32 H as a host array in the policy dtype: exact counts
    for ``float32``, reduced modulo 2**bits on H's own device for the
    integer policies (counts are exact integers below 2**24 there)."""
    dtype, _ = STORAGE_POLICIES[storage]
    bits = _modular_bits(storage)
    if bits is None:
        return H.to(torch.float32).cpu().numpy()
    wrapped = torch.remainder(H.to(torch.int64), 1 << bits)
    if bits < 32:
        wrapped = wrapped.to(torch.int32)     # half the bytes to the host
    return wrapped.cpu().numpy().astype(dtype)


def spill_banded_ih(image, num_bins: int, *, storage: str = "float32",
                    **kwargs) -> SpilledIH:
    """Compute the banded H and spill every band to the host under
    ``storage`` (validated against the count bound up front)."""
    h, w = image.shape[-2:]
    validate_storage_policy(storage, h, w)
    spans, bands, carries = [], [], []
    for band in iter_banded_ih(image, num_bins, **kwargs):
        # The true-valued bottom row, before any storage cast.
        carries.append(band.carry.to(torch.float32).cpu().numpy())
        bands.append(to_storage(band.H, storage))
        spans.append((band.r0, band.r1))
    return SpilledIH(num_bins=num_bins, height=h, width=w,
                     lead=tuple(image.shape[:-2]), storage=storage,
                     spans=tuple(spans), bands=bands, carries=carries)
