"""One H-representation protocol for every way the port holds an H.

Port of ``repro/core/hsource.py`` for the dense, band-streamed,
host-spilled (``core/bands.SpilledIH``), mesh-sharded and query-fused
representations.  Eq. 2 only ever reads corner
*rows* of H, so one protocol serves every representation:

    class HSource:
        num_bins / height / width / lead     # metadata
        exact_region_bound                   # storage-policy count bound
        rows(row_ids) -> (..., b, k, w)      # tensor on the source's device
        dense() -> (..., b, h, w)            # assemble (when it exists)

Every analytics function has one generic implementation against
``rows()``; ``DenseH`` overrides with the direct dense paths.  Results are
bit-exact either way because all H arithmetic is integer-valued: fp32
below 2**24, modular for the integer spill policies.

The reference returns host (numpy) rows to dodge a jax 0.4.37 bug in
concatenating row-sharded device arrays; torch has no such bug, so rows
stay on the source's device here (the host, for a spill; the first
shard's device, for a sharded H).
"""

from __future__ import annotations

import abc
import itertools
import warnings

import numpy as np
import torch

from repro_torch.core import region_query as rq
from repro_torch.device import as_tensor


class MissingRowsError(KeyError):
    """A row-restricted source was asked for rows it does not hold.

    Raised by :class:`PrefetchedRowsH` (a prefetch missed a query's rows —
    a caller bug) and :class:`FusedRowsH` (a fused result holds ONLY its
    request's corner rows; asking for more means the request changed and
    the engine must recompute)."""


def _lookup(held: np.ndarray, row_ids: np.ndarray, what: str) -> np.ndarray:
    """Positions of ``row_ids`` in the sorted ``held`` rows, or raise."""
    idx = np.searchsorted(held, row_ids)
    n = len(held)
    bad = ((idx >= n) | (held[np.minimum(idx, n - 1)] != row_ids)
           if n else np.ones(row_ids.shape, bool))
    if row_ids.size and bad.any():
        raise MissingRowsError(f"rows {row_ids[bad].tolist()} {what}")
    return idx


class HSource(abc.ABC):
    """Corner-row access + metadata over any integral-histogram holder."""

    num_bins: int
    height: int
    width: int
    lead: tuple      # leading frame axes of the H stack (() for a frame)

    @property
    def exact_region_bound(self) -> int | None:
        """Largest region pixel count a query is guaranteed exact for, or
        ``None`` when unbounded (fp32 sources are bounded upstream by the
        2**24 query validation)."""
        return None

    @property
    def nbytes(self) -> int:
        """Size estimate: the full fp32 H footprint."""
        nlead = int(np.prod(self.lead, dtype=np.int64) or 1)
        return 4 * nlead * self.num_bins * self.height * self.width

    # -- the one representation primitive -----------------------------------
    @abc.abstractmethod
    def rows(self, row_ids) -> torch.Tensor:
        """Full-frame H restricted to ``row_ids`` (sorted, ascending):
        (..., b, len(row_ids), w) on the source's device."""

    def dense(self) -> torch.Tensor:
        """Materialize (..., b, h, w) as fp32 — small frames only."""
        return self.rows(np.arange(self.height)).to(torch.float32)

    def _reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Bring a four-corner combination of ``rows()`` values back to
        true counts: the identity, except for the modular spill policies
        (``bands.SpilledIH``)."""
        return x

    # -- unified analytics (Eq. 2 against rows()) ---------------------------
    def _check_region_bound(self, max_area: int, what: str = "region") -> None:
        bound = self.exact_region_bound
        if bound is not None and max_area > bound:
            raise ValueError(
                f"{what} of {max_area} pixels exceeds the {self.storage} "
                f"storage policy's exact-count bound {bound}; spill with a "
                "wider policy")

    def region_histogram(self, rects) -> torch.Tensor:
        """``region_query.region_histogram`` semantics; returns fp32."""
        rects = np.asarray(rects)
        area = (rects[..., 2] - rects[..., 0] + 1) * (
            rects[..., 3] - rects[..., 1] + 1)
        self._check_region_bound(int(np.max(area)))
        needed = rq.corner_rows(rects)
        Hc = self.rows(needed)
        out = rq.compressed_region_histogram(Hc, needed, rects)
        return self._reduce(out).to(torch.float32)

    def _window_lattices(self, window, stride):
        """The two corner-row lattices of the regular window grid."""
        wh, ww = window
        n_r = (self.height - wh) // stride + 1
        n_c = (self.width - ww) // stride + 1
        bot = wh - 1 + np.arange(max(n_r, 0)) * stride
        top = np.arange(max(n_r, 0)) * stride - 1     # row -1 is virtual
        return n_r, n_c, bot, top

    def _windows_from_rows(self, R, needed, window, stride):
        """Four-corner arithmetic over prefetched corner rows ``R =
        self.rows(needed)``."""
        n_r, n_c, bot_rows, top_rows = self._window_lattices(window, stride)
        sel = torch.as_tensor(np.searchsorted(needed, bot_rows),
                              device=R.device)
        bot = R[..., sel, :]
        top = torch.zeros_like(bot)
        real = top_rows >= 0
        sel = torch.as_tensor(np.searchsorted(needed, top_rows[real]),
                              device=R.device)
        top[..., torch.as_tensor(real, device=R.device), :] = R[..., sel, :]
        diff = bot - top                               # (..., b, n_r, w)
        s = stride
        ww = window[1]
        d = diff[..., ww - 1 :: s][..., :n_c]
        c = torch.zeros_like(d)                        # virtual zero column
        c[..., 1:] = diff[..., s - 1 :: s][..., : n_c - 1]
        out = self._reduce(d - c).to(torch.float32)
        return torch.movedim(out, -3, -1)

    def _empty_windows(self, n_r, n_c, device):
        return torch.zeros(
            self.lead + (max(n_r, 0), max(n_c, 0), self.num_bins),
            dtype=torch.float32, device=device)

    def sliding_window_histograms(
        self, window, stride: int = 1, *, stats: dict | None = None
    ) -> torch.Tensor:
        """One O(1) query per window position, one ``rows()`` pass."""
        n_r, n_c, bot_rows, top_rows = self._window_lattices(window, stride)
        if n_r <= 0 or n_c <= 0:
            return self._empty_windows(n_r, n_c, self.device)
        self._check_region_bound(window[0] * window[1], "window")
        needed = np.unique(np.concatenate([bot_rows, top_rows[top_rows >= 0]]))
        self._warn_if_slabs_dominate(n_r, stride)
        R = self.rows(needed)
        out = self._windows_from_rows(R, needed, window, stride)
        if stats is not None:
            self._fill_stats(stats, R)
        return out

    def likelihood_map(
        self, target_hist, window, metric, stride: int = 1,
        *, stats: dict | None = None,
    ):
        hists = self.sliding_window_histograms(window, stride, stats=stats)
        return metric(hists, rq._target(target_hist, hists))

    def multi_scale_search(self, target_hist, windows, metric,
                           stride: int = 1):
        """The union of all scales' corner-row lattices is fetched in ONE
        ``rows()`` pass."""
        lattices = [self._window_lattices(wnd, stride) for wnd in windows]
        # Scales that do not fit the frame query nothing, so they must not
        # trip the storage-policy bound either.
        live = [wh * ww for (wh, ww), (n_r, n_c, _, _) in zip(windows, lattices)
                if n_r > 0 and n_c > 0]
        self._check_region_bound(max(live, default=0), "window")
        all_rows = [
            np.concatenate([bot, top[top >= 0]])
            for (n_r, n_c, bot, top) in lattices
            if n_r > 0 and n_c > 0
        ]
        needed = (np.unique(np.concatenate(all_rows))
                  if all_rows else np.zeros((0,), np.int64))
        R = self.rows(needed) if needed.size else None
        maps = []
        for wnd, (n_r, n_c, _, _) in zip(windows, lattices):
            if n_r <= 0 or n_c <= 0:
                hists = self._empty_windows(n_r, n_c, self.device)
            else:
                hists = self._windows_from_rows(R, needed, wnd, stride)
            maps.append(metric(hists, rq._target(target_hist, hists)))
        best_rect, best_score = rq.reduce_scale_maps(
            maps, windows, stride, self.lead)
        return best_rect, best_score, maps

    def _warn_if_slabs_dominate(self, n_r: int, stride: int) -> None:
        """Streaming sources warn when the corner-row slabs are no smaller
        than the monolithic H they avoid (stride-1 sliding windows)."""

    def _fill_stats(self, stats: dict, R: torch.Tensor) -> None:
        nlead = int(np.prod(self.lead, dtype=np.int64) or 1)
        stats.update(
            slab_bytes=2 * R.numel() * R.element_size(),
            full_h_bytes=4 * nlead * self.num_bins * self.height * self.width,
        )
        stats.setdefault("num_bands", 1)
        stats.setdefault("band_bytes", 0)
        stats["peak_bytes"] = stats["band_bytes"] + stats["slab_bytes"]


class DenseH(HSource):
    """A materialized (..., b, h, w) H; analytics take the direct dense
    paths of core/region_query.py.

    ``H`` may be a tensor (kept where it is) or a numpy array, e.g. an H
    the reference computed; a numpy H goes to ``device`` (``None`` = the
    card)."""

    def __init__(self, H, device=None):
        if isinstance(H, torch.Tensor) and device is None:
            self.H = H
        else:
            self.H = as_tensor(H, device)
        if self.H.ndim < 3:
            raise ValueError(
                f"DenseH wants (..., b, h, w), got {tuple(self.H.shape)}")

    @property
    def num_bins(self) -> int:
        return self.H.shape[-3]

    @property
    def height(self) -> int:
        return self.H.shape[-2]

    @property
    def width(self) -> int:
        return self.H.shape[-1]

    @property
    def lead(self) -> tuple:
        return tuple(self.H.shape[:-3])

    @property
    def device(self) -> torch.device:
        return self.H.device

    @property
    def nbytes(self) -> int:
        return self.H.numel() * self.H.element_size()

    def rows(self, row_ids) -> torch.Tensor:
        return self.H[..., torch.as_tensor(np.asarray(row_ids, np.int64),
                                           device=self.H.device), :]

    def dense(self) -> torch.Tensor:
        return self.H

    def update_bands(self, next_frame, report, *, recompute,
                     apply_fn=None) -> "DenseH":
        """The incremental-video hook (core/delta.py): a new DenseH for
        ``next_frame``, recomputing only the report's dirty bands and
        carry-correcting the clean rows below, bit-exact against a full
        recompute."""
        from repro_torch.core import delta as delta_mod

        return DenseH(delta_mod.update_dense_ih(
            self.H, next_frame, report, recompute=recompute,
            apply_fn=apply_fn))

    def region_histogram(self, rects) -> torch.Tensor:
        return rq.region_histogram(self.H, rects)

    def sliding_window_histograms(
        self, window, stride: int = 1, *, stats: dict | None = None
    ) -> torch.Tensor:
        return rq.sliding_window_histograms(self.H, window, stride,
                                            stats=stats)

    def multi_scale_search(self, target_hist, windows, metric,
                           stride: int = 1):
        return rq.multi_scale_search(self.H, target_hist, windows, metric,
                                     stride)


class BandedH(HSource):
    """An H held as a ``BandH`` stream (core/bands.py): the full H never
    exists at once.

    ``bands`` is either an iterable/iterator of ``BandH`` (single-shot: a
    second query raises with a pointer to the factory form) or a zero-arg
    callable returning a fresh stream per query (replayable — what
    ``HistogramEngine`` builds).  ``rows()`` streams the bands once and
    keeps only the requested rows, on the bands' device."""

    def __init__(self, bands):
        self._factory = bands if callable(bands) else None
        self._tail = None if callable(bands) else iter(bands)
        self._meta = None
        self.last_stream_stats: dict = {}

    # -- stream management ---------------------------------------------------
    def _take_stream(self):
        # A stashed stream (from a meta peek) is used first; otherwise the
        # factory opens a fresh one, and a single-shot iterator that was
        # already taken has nothing left to give.
        if self._tail is not None:
            stream, self._tail = self._tail, None
        elif self._factory is not None:
            stream = self._factory()
        else:
            raise RuntimeError(
                "this BandedH wraps a single-shot band iterator that was "
                "already consumed; construct it with a zero-arg factory "
                "(e.g. BandedH(lambda: ih.map_bands(img, ...))) to run "
                "multiple queries")
        first = next(stream)
        if self._meta is None:
            self._meta = (first.frame_h, tuple(first.H.shape), first.H.device)
        return itertools.chain([first], stream)

    def _peek_meta(self):
        if self._meta is None:
            # Hand the un-consumed stream back so the peek costs nothing:
            # the next query picks it up before asking the factory again.
            self._tail = self._take_stream()
        return self._meta

    # -- metadata ------------------------------------------------------------
    num_bins = property(lambda self: self._peek_meta()[1][-3])
    height = property(lambda self: self._peek_meta()[0])
    width = property(lambda self: self._peek_meta()[1][-1])
    lead = property(lambda self: self._peek_meta()[1][:-3])
    device = property(lambda self: self._peek_meta()[2])

    # -- protocol ------------------------------------------------------------
    def rows(self, row_ids) -> torch.Tensor:
        row_ids = np.asarray(row_ids, np.int64)
        out = None
        num_bands = 0
        peak_band = 0
        for band in self._take_stream():
            Hb = as_hsource(band.H)          # a tensor, or a ShardedH band
            if out is None:
                out = torch.zeros(Hb.lead + (Hb.num_bins, len(row_ids),
                                             Hb.width),
                                  dtype=torch.float32, device=Hb.device)
            num_bands = band.num_bands
            peak_band = max(peak_band, band.nbytes)
            pos = np.flatnonzero((row_ids >= band.r0) & (row_ids < band.r1))
            if pos.size:
                out[..., torch.as_tensor(pos, device=Hb.device), :] = \
                    Hb.rows(row_ids[pos] - band.r0)
        self.last_stream_stats = {"num_bands": num_bands,
                                  "band_bytes": peak_band}
        return out

    def dense(self) -> torch.Tensor:
        """Assemble the full H on the bands' device."""
        return torch.cat([as_hsource(band.H).dense()
                          for band in self._take_stream()], dim=-2)

    def update_bands(self, next_frame, report, *, recompute,
                     apply_fn=None) -> "BandedH":
        """The incremental-video hook (core/delta.py): a new replayable
        BandedH whose stream replays this one's bands, recomputing dirty
        bands from ``next_frame`` and carry-correcting clean bands below.
        Only factory-backed (replayable) sources can be updated."""
        from repro_torch.core import delta as delta_mod

        if self._factory is None:
            raise RuntimeError(
                "cannot update a single-shot BandedH — only factory-"
                "backed (replayable) band streams support incremental "
                "updates; the engine falls back to a full recompute")
        return BandedH(delta_mod.update_banded_factory(
            self._factory, next_frame, report, recompute=recompute,
            apply_fn=apply_fn))

    # -- stats / warnings ----------------------------------------------------
    def _warn_if_slabs_dominate(self, n_r: int, stride: int) -> None:
        nlead = int(np.prod(self.lead, dtype=np.int64) or 1)
        slab_bytes = 2 * 4 * nlead * self.num_bins * n_r * self.width
        full_bytes = 4 * nlead * self.num_bins * self.height * self.width
        if slab_bytes >= full_bytes:
            warnings.warn(
                f"banded sliding windows at stride {stride} need "
                f"{slab_bytes} B of corner-row slabs >= the {full_bytes} B "
                "monolithic H they avoid; increase the stride (slabs scale "
                "with 1/stride) or use the monolithic path for frames this "
                "size", stacklevel=4)

    def _fill_stats(self, stats: dict, R: torch.Tensor) -> None:
        stats.update(self.last_stream_stats)
        super()._fill_stats(stats, R)


class PrefetchedRowsH(HSource):
    """A view over corner rows already fetched from another source: a
    request's union of rows is fetched in ONE ``rows()`` pass and each
    query is served from it.  Asking for other rows raises."""

    def __init__(self, base: HSource, needed, R: torch.Tensor):
        self._base = base
        self._needed = np.asarray(needed)
        self._R = R

    num_bins = property(lambda self: self._base.num_bins)
    height = property(lambda self: self._base.height)
    width = property(lambda self: self._base.width)
    lead = property(lambda self: self._base.lead)
    device = property(lambda self: self._R.device)
    exact_region_bound = property(lambda self: self._base.exact_region_bound)
    storage = property(lambda self: getattr(self._base, "storage", "float32"))

    def _reduce(self, x: torch.Tensor) -> torch.Tensor:
        return self._base._reduce(x)

    def rows(self, row_ids) -> torch.Tensor:
        row_ids = np.asarray(row_ids)
        idx = _lookup(self._needed, row_ids,
                      "were not prefetched; the engine's row union must "
                      "cover every query")
        return self._R[..., torch.as_tensor(idx, device=self._R.device), :]


class FusedRowsH(HSource):
    """The result of a query-fused dispatch: corner rows WITHOUT an H.

    A fused plan never builds the (n, b, h, w) integral histogram —
    ``kernels.ops.fused_corner_rows`` emits exactly the rows the request's
    queries read, and this source serves those queries from that slab.
    ``rows()`` outside the fused set and ``dense()`` raise
    :class:`MissingRowsError`: there is no H to go back to."""

    def __init__(self, row_ids, R, *, height: int, width: int):
        self._row_ids = np.asarray(row_ids, np.int64).reshape(-1)
        self._R = R if isinstance(R, torch.Tensor) else torch.as_tensor(R)
        if self._R.ndim < 3 or self._R.shape[-2] != self._row_ids.size:
            raise ValueError(
                f"R {tuple(self._R.shape)} does not hold "
                f"{self._row_ids.size} rows (want (..., b, k, w))")
        self.height = height
        self.width = width

    @property
    def num_bins(self) -> int:
        return self._R.shape[-3]

    @property
    def lead(self) -> tuple:
        return tuple(self._R.shape[:-3])

    @property
    def device(self) -> torch.device:
        return self._R.device

    @property
    def row_ids(self) -> np.ndarray:
        return self._row_ids

    @property
    def nbytes(self) -> int:
        return self._R.numel() * self._R.element_size()

    def rows(self, row_ids) -> torch.Tensor:
        row_ids = np.asarray(row_ids)
        idx = _lookup(self._row_ids, row_ids,
                      "were not part of the fused request; a fused plan "
                      "computes only its declared corner rows — re-run the "
                      "engine with the new queries")
        return self._R[..., torch.as_tensor(idx, device=self._R.device), :]

    def dense(self):
        raise MissingRowsError(
            "this H was query-fused: only the requested corner rows were "
            "ever computed and the dense (b, h, w) H does not exist; "
            "re-plan without query fusion to materialize it")


class ShardedH(HSource):
    """A mesh-sharded H (core/distributed.py), one tensor a shard.

    ``kind="bin"``: ``shards[j]`` holds bins ``j * b/D ..`` of every row
    (``bin_sharded_ih``).  ``kind="spatial"``: ``shards[r][j]`` holds row
    strip ``r`` of bin shard ``j`` (``spatial_sharded_ih``).  ``rows()``
    takes each shard's rows where it lives (bin shards index their own
    rows, row shards give the rows they own) and concatenates them on the
    first shard's device, so the only copy is the (.., b, k, w) slab.
    Region queries on a bin-sharded H run per shard and concatenate over
    bins.  ``mesh`` is the ``device.Mesh`` the shards came from."""

    def __init__(self, shards, mesh, *, kind: str = "bin"):
        if kind not in ("bin", "spatial"):
            raise ValueError(f"unknown sharding kind {kind!r} (bin|spatial)")
        self.grid = ([list(shards)] if kind == "bin"
                     else [list(strip) for strip in shards])
        self.mesh = mesh
        self.kind = kind

    @property
    def num_bins(self) -> int:
        return sum(s.shape[-3] for s in self.grid[0])

    @property
    def height(self) -> int:
        return sum(strip[0].shape[-2] for strip in self.grid)

    @property
    def width(self) -> int:
        return self.grid[0][0].shape[-1]

    @property
    def lead(self) -> tuple:
        return tuple(self.grid[0][0].shape[:-3])

    @property
    def shape(self) -> tuple:
        return self.lead + (self.num_bins, self.height, self.width)

    @property
    def device(self) -> torch.device:
        return self.grid[0][0].device

    @property
    def nbytes(self) -> int:
        # The real footprint, summed over shards: the service's byte-aware
        # cache eviction charges sources by it.
        return sum(s.nbytes for strip in self.grid for s in strip)

    def bottom_rows(self) -> list:
        """The last row of every bin shard, on its device: the carry a
        band stream hands the next band."""
        return [s[..., -1, :] for s in self.grid[-1]]

    def rows(self, row_ids) -> torch.Tensor:
        row_ids = np.asarray(row_ids, np.int64).reshape(-1)
        out = torch.empty(self.lead + (self.num_bins, row_ids.size,
                                       self.width),
                          dtype=self.grid[0][0].dtype, device=self.device)
        r0 = 0
        for strip in self.grid:
            hs = strip[0].shape[-2]
            pos = np.flatnonzero((row_ids >= r0) & (row_ids < r0 + hs))
            if pos.size:
                dst = torch.as_tensor(pos, device=self.device)
                b0 = 0
                for s in strip:
                    b1 = b0 + s.shape[-3]
                    local = torch.as_tensor(row_ids[pos] - r0,
                                            device=s.device)
                    out[..., b0:b1, dst, :] = s[..., local, :].to(self.device)
                    b0 = b1
            r0 += hs
        return out

    def dense(self) -> torch.Tensor:
        return torch.cat([torch.cat([s.to(self.device) for s in strip],
                                    dim=-3) for strip in self.grid], dim=-2)

    def region_histogram(self, rects) -> torch.Tensor:
        if self.kind != "bin":
            return super().region_histogram(rects)
        return torch.cat([rq.region_histogram(s, rects).to(self.device)
                          for s in self.grid[0]], dim=-1)


def as_hsource(H, device=None) -> HSource:
    """Coerce a representation to the protocol: an ``HSource`` as-is, a
    dense (..., b, h, w) tensor or numpy array as ``DenseH`` (a numpy H
    goes to ``device``), a ``BandH`` iterable/iterator or a zero-arg
    band-stream factory as ``BandedH``."""
    if isinstance(H, HSource):
        return H
    if callable(H):
        return BandedH(H)
    if hasattr(H, "ndim") and hasattr(H, "shape"):
        return DenseH(H, device)
    if hasattr(H, "__iter__") or hasattr(H, "__next__"):
        return BandedH(H)
    raise TypeError(
        f"cannot interpret {type(H).__name__} as an integral-histogram "
        "source (want an HSource, a dense (..., b, h, w) array, or a "
        "BandH stream/factory)")
