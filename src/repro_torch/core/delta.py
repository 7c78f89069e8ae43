"""Dirty-band invalidation and incremental H updates for video streams.

Port of ``repro/core/delta.py``.  Consecutive frames from a fixed camera
differ in a handful of rows, and every column of H is a prefix sum over
rows, so for a band starting at r0

    H[r, c, b] = H_band[r - r0, c, b] + H[r0 - 1, c, b]

and editing frame rows inside a band changes H *below* it only through
the band's bottom row.  The incremental walk over a band plan:

  * bands above the first dirty band are untouched;
  * a dirty band is recomputed from the new frame rows with the
    re-threaded carry-in (K1 or K4 on the card);
  * a clean band below a dirty one gets one broadcast correction,
    ``delta = new_bottom - old_bottom`` of the nearest dirty band above,
    added to every row (``kernels/ops.delta_apply``, K3 on the card); its
    new bottom row is ``old_bottom + delta``, so consecutive clean bands
    reuse the same delta without any rescan.

All H arithmetic is integer-valued fp32 (exact below 2**24), so the
updated H equals a full recompute bit for bit.  The integer spill
policies update in the modular arithmetic they store in; their fp32
carry chain is kept on the ``SpilledIH`` (``carries``) so the delta can
be formed without unwrapping stored bands.

``diff_bands`` is the detector; ``update_dense_ih`` /
``update_banded_factory`` / ``update_spilled_ih`` are the
per-representation walks, reached through the sources' ``update_bands``
hooks; the planner decision (dirty fraction vs threshold) lives in
``core/engine.plan``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.bands import STORAGE_POLICIES, BandPlan, to_storage
from repro_torch.kernels.delta_apply import delta_apply_plain

#: dirty-row fraction above which an incremental update stops paying
#: (the planner's threshold).
DEFAULT_DIRTY_THRESHOLD = 0.35


@dataclasses.dataclass(frozen=True)
class DirtyReport:
    """Per-band dirtiness of one frame transition under one band plan.

    ``spans`` are the [r0, r1) row bands the update walks; ``dirty[i]``
    says band i's frame rows changed.  The *fraction* counts rows of dirty
    bands (what the update recomputes), not raw changed rows — it is the
    planner's cost input."""

    spans: tuple[tuple[int, int], ...]
    dirty: tuple[bool, ...]
    frame_h: int

    @property
    def dirty_rows(self) -> int:
        return sum(r1 - r0 for (r0, r1), d in zip(self.spans, self.dirty)
                   if d)

    @property
    def dirty_fraction(self) -> float:
        return self.dirty_rows / self.frame_h if self.frame_h else 0.0

    @property
    def num_dirty(self) -> int:
        return sum(self.dirty)

    @property
    def all_clean(self) -> bool:
        return not any(self.dirty)


def _spans_of(band_plan) -> tuple[tuple[int, int], ...]:
    spans = getattr(band_plan, "spans", band_plan)
    return tuple((int(r0), int(r1)) for r0, r1 in spans)


def _row_dirty(prev, nxt) -> np.ndarray:
    """(h,) host bool: does any pixel of frame row r differ in any frame?

    Tensors are compared on their device and only this row mask comes
    back to the host; a numpy frame beside a tensor goes to the tensor's
    device first."""
    if isinstance(prev, torch.Tensor) or isinstance(nxt, torch.Tensor):
        dev = (prev if isinstance(prev, torch.Tensor) else nxt).device
        p = torch.as_tensor(np.asarray(prev) if not isinstance(
            prev, torch.Tensor) else prev, device=dev)
        n = torch.as_tensor(np.asarray(nxt) if not isinstance(
            nxt, torch.Tensor) else nxt, device=dev)
        changed = (p != n).movedim(-2, 0).reshape(p.shape[-2], -1)
        return changed.any(dim=1).cpu().numpy()
    changed = prev != nxt
    axes = tuple(i for i in range(changed.ndim) if i != changed.ndim - 2)
    return np.any(changed, axis=axes)


def diff_bands(prev_frame, next_frame,
               band_plan: BandPlan | tuple) -> DirtyReport:
    """Detect the dirty row bands between two frames (or frame stacks).

    A row is dirty when any pixel of any frame in the stack differs; a
    band is dirty when any of its rows is.  ``band_plan`` is a
    :class:`~repro_torch.core.bands.BandPlan` or a bare span sequence —
    the granularity the update will recompute at (a cached ``SpilledIH``
    hands its own spans here).  Frames may be numpy arrays or tensors;
    frames on the card are compared there."""
    tensors = isinstance(prev_frame, torch.Tensor) or isinstance(
        next_frame, torch.Tensor)
    prev = prev_frame if tensors else np.asarray(prev_frame)
    nxt = next_frame if tensors else np.asarray(next_frame)
    if tuple(prev.shape) != tuple(nxt.shape):
        raise ValueError(
            f"frame shapes differ: prev {tuple(prev.shape)} vs next "
            f"{tuple(nxt.shape)}")
    if prev.ndim < 2:
        raise ValueError(
            f"expected (h, w) or (n, h, w), got {tuple(prev.shape)}")
    spans = _spans_of(band_plan)
    h = prev.shape[-2]
    if not spans or spans[0][0] != 0 or spans[-1][1] != h or any(
            a1 != b0 for (_, a1), (b0, _) in zip(spans, spans[1:])):
        raise ValueError(f"band spans {spans[:4]}... do not tile [0, {h})")
    row_dirty = _row_dirty(prev, nxt)
    dirty = tuple(bool(row_dirty[r0:r1].any()) for r0, r1 in spans)
    return DirtyReport(spans=spans, dirty=dirty, frame_h=h)


def _merged_runs(report: DirtyReport):
    """Coalesce consecutive equally-dirty spans into maximal runs.

    The dense walk has no per-band storage to respect, so one recompute
    covers a whole dirty run and one broadcast apply covers a whole clean
    run: detection granularity (fine, to localise the change) decouples
    from launch granularity (coarse, to amortise per-launch overhead).
    The banded/spilled walks keep per-band steps: their storage IS the
    band structure."""
    runs: list[list] = []
    for (r0, r1), d in zip(report.spans, report.dirty):
        if runs and runs[-1][2] == d:
            runs[-1][1] = r1
        else:
            runs.append([r0, r1, d])
    return [(r0, r1, d) for r0, r1, d in runs]


def _assemble_dense(H, slabs, starts, stops, delta_steps):
    """Repair a dense H from recomputed dirty-run slabs: add the
    carry-correction steps below each dirty run, then splice the slabs
    in.  The reference fuses this into one jit dispatch; here it is a
    copy of H and in-place slice ops.

    ``delta_steps[i]`` is D_i - D_{i-1} (D_i = run i's new bottom minus its
    old bottom): clean rows between dirty runs i and i+1 accumulate
    exactly D_i, and dirty rows are overwritten by their slab afterwards.
    Integer-valued fp32 throughout, so the order of the adds does not
    change a bit."""
    out = H.clone()
    for r1, step in zip(stops, delta_steps):
        out[..., r1:, :] += step[..., None, :]
    for slab, r0 in zip(slabs, starts):
        out[..., r0:r0 + slab.shape[-2], :] = slab.to(out.dtype)
    return out


def update_dense_ih(
    H,
    next_frame,
    report: DirtyReport,
    *,
    recompute: Callable,
    apply_fn: Callable | None = None,
):
    """Repair a dense (..., b, h, w) H for ``next_frame``.

    ``recompute(band_rows, carry_in) -> H_band`` runs the real kernel
    launch (the engine builds it from its plan's kernel kwargs);
    ``apply_fn(slab, delta, out=dst)`` writes the broadcast correction of
    a clean run into ``dst``.  With ``apply_fn=None`` (the engine's
    ``"torch"`` plans) the repair is plain torch slice ops
    (``_assemble_dense``); an explicit ``apply_fn`` (``ops.delta_apply``
    for ``"cuda"`` plans, so K3 does the adds) takes the per-run walk,
    which allocates the new H once and writes every run into its own rows
    of it: the clean prefix and the recomputed runs are copied there, and
    the repaired rows below are written there by ``apply_fn``.  Returns
    the new dense H, bit-exact against a full recompute either way.  A
    numpy H becomes a host tensor."""
    if not isinstance(H, torch.Tensor):
        H = torch.as_tensor(np.asarray(H))
    if apply_fn is None:
        slabs, starts, stops, steps = [], [], [], []
        D_prev = None          # cumulative carry delta of dirty runs above
        for r0, r1, is_dirty in _merged_runs(report):
            if not is_dirty:
                continue
            carry = None
            if r0 > 0:
                carry = H[..., r0 - 1, :]
                if D_prev is not None:
                    carry = carry + D_prev
            slab = recompute(next_frame[..., r0:r1, :], carry)
            D = slab[..., -1, :] - H[..., r1 - 1, :]
            steps.append(D if D_prev is None else D - D_prev)
            slabs.append(slab)
            starts.append(r0)
            stops.append(r1)
            D_prev = D
        if not slabs:
            return H
        return _assemble_dense(H, slabs, starts, stops, steps)

    runs = _merged_runs(report)
    if len(runs) == 1:                      # all clean, or all dirty
        return recompute(next_frame, None).to(H.dtype) if runs[0][2] else H
    out = torch.empty(H.shape, dtype=H.dtype, device=H.device)
    new_carry = None      # bottom row of the run above, updated values
    delta = None          # correction for clean runs below a dirty one
    for r0, r1, is_dirty in runs:
        old_bottom = H[..., r1 - 1, :]
        dst = out[..., r0:r1, :]
        if is_dirty:
            slab = recompute(next_frame[..., r0:r1, :], new_carry)
            dst.copy_(slab)
            new_carry = slab[..., -1, :]
            delta = new_carry - old_bottom
        elif delta is None:
            dst.copy_(H[..., r0:r1, :])     # untouched prefix of the frame
            new_carry = old_bottom
        else:
            apply_fn(H[..., r0:r1, :], delta, out=dst)
            new_carry = old_bottom + delta
    return out


def update_banded_factory(
    factory: Callable,
    next_frame,
    report: DirtyReport,
    *,
    recompute: Callable,
    apply_fn: Callable | None = None,
) -> Callable:
    """Lift a replayable band-stream factory to the next frame.

    Returns a new zero-arg factory whose stream replays ``factory``'s
    bands, recomputing dirty ones from ``next_frame`` with the re-threaded
    carry and correcting clean ones below with the carry delta; each
    yielded ``BandH`` is what a fresh banded compute of ``next_frame``
    would yield, band for band."""
    if apply_fn is None:
        apply_fn = delta_apply_plain

    def replay():
        new_carry = None
        delta = None
        for band in factory():
            i = band.index
            if i >= len(report.spans) or \
                    report.spans[i] != (band.r0, band.r1):
                raise ValueError(
                    f"band {i} spans [{band.r0}, {band.r1}) but the dirty "
                    f"report was built for "
                    f"{report.spans[i] if i < len(report.spans) else None} "
                    "— detection and update must share one band plan")
            if report.dirty[i]:
                Hb = recompute(next_frame[..., band.r0:band.r1, :],
                               new_carry)
                new_carry = Hb[..., -1, :]
                delta = new_carry - band.carry
                yield dataclasses.replace(band, H=Hb, carry=new_carry)
            elif delta is None:
                new_carry = band.carry
                yield band
            else:
                new_carry = band.carry + delta
                yield dataclasses.replace(
                    band, H=apply_fn(band.H, delta), carry=new_carry)

    return replay


def update_spilled_ih(src, next_frame, report: DirtyReport, *,
                      recompute: Callable):
    """Repair a host-spilled H (``core/bands.SpilledIH``) in its own
    storage policy.

    Dirty bands are recomputed in fp32 (true counts) and re-spilled
    through the policy cast; clean bands below take the delta in int64
    modular arithmetic on the host, so wrapped uint16/uint32 values stay
    exactly what a fresh spill of the new frame would store.  The retained
    fp32 ``carries`` both supply the old bottoms the delta needs and are
    updated alongside, so a further update can chain off the result."""
    if src.carries is None:
        raise ValueError(
            "this SpilledIH has no `carries`; re-spill the frame before "
            "updating incrementally")
    if tuple(src.spans) != report.spans:
        raise ValueError(
            f"spill spans {tuple(src.spans)[:4]}... do not match the dirty "
            f"report's {report.spans[:4]}... — detection must run on the "
            "source's own band plan")
    dtype, _ = STORAGE_POLICIES[src.storage]
    bands_new, carries_new = [], []
    new_carry = None
    delta = None
    for i, ((r0, r1), is_dirty) in enumerate(zip(report.spans,
                                                 report.dirty)):
        if is_dirty:
            Hb = recompute(next_frame[..., r0:r1, :], new_carry)
            bottom = Hb[..., -1, :].to(torch.float32).cpu().numpy()
            delta = bottom - src.carries[i]
            bands_new.append(to_storage(Hb, src.storage))
            carries_new.append(bottom)
            new_carry = bottom
        elif delta is None:
            bands_new.append(src.bands[i])
            carries_new.append(src.carries[i])
            new_carry = src.carries[i]
        else:
            if dtype is np.float32:
                bands_new.append(src.bands[i] + delta[..., None, :])
            else:
                # Deltas are exact integers in fp32; add them in the
                # policy's modular ring so wrapped values stay aligned
                # with what a fresh spill would store.
                mod = np.int64(np.iinfo(dtype).max) + 1
                stepped = src.bands[i].astype(np.int64) \
                    + np.rint(delta[..., None, :]).astype(np.int64)
                bands_new.append(np.mod(stepped, mod).astype(dtype))
            carry = src.carries[i] + delta
            carries_new.append(carry)
            new_carry = carry
    return dataclasses.replace(src, bands=bands_new, carries=carries_new)
