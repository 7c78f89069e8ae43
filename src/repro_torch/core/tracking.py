"""Fragments-based visual tracking on integral histograms.

Port of ``repro/core/tracking.py``.  The paper's motivating application
(ref. [13], Adam et al. CVPR'06): a target template is split into a grid
of fragments; every frame, each fragment votes for the target position by
matching its histogram against candidate windows.  Every candidate
histogram comes from the frame's integral histogram in O(1), which is
what makes exhaustive local search real-time.

The tracker is batched along three axes:

  * **targets**: ``init`` accepts a single ``(4,)`` bbox or a ``(t, 4)``
    stack; every step scores the (t, candidates, fragments) rects of all
    targets in one ``region_histogram`` against the frame's one H.
  * **frames**: ``track`` consumes a whole clip through
    ``runtime.FrameRuntime``: each chunk's integral histograms come from
    one K1 launch and a loop over the chunk's H threads the tracker state
    (the reference's ``lax.scan``), the state riding between dispatches
    as the runtime's carry.
  * **cameras**: ``init_fleet`` and ``step_fleet`` take a fleet's capture
    tick, one frame a camera, ``(n, h, w)``, and ``(n, t, 4)`` boxes.  A
    tick is ONE ``HistogramEngine.run(frames, [TrackQuery])``: one K1
    launch for every camera's frame, then one vote for every target, each
    reading only its own camera's H, so the launches of a tick do not grow
    with the cameras.  ``init_fleet`` reads the reference fragments by
    paired region queries (``region_histogram(..., paired=True)``).

Every vote goes through ``engine.TrackQuery`` (``step_on_h`` and
``track`` with a leading axis of one frame): on a dense H on the card it
is one launch of the vote kernel (``kernels/track_vote.py``); elsewhere
``vote_plain``, torch ops over each candidate's fragment corner lattice
(``vote_geometry``) scored by ``distances.intersection``.

The vote takes the median of the fragments' similarities the way
``jnp.median`` does (the mean of the two middle values of an even count)
and the first maximal candidate (``argmax``), so boxes equal the
reference's bit for bit.  ``step_fused`` is one engine request whose
corner rows the planner fuses into K2; ``track(incremental=True)`` chains
``engine.run(prev=...)``: K1 on the dirty rows, K3 below them.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import distances
from repro_torch.core.region_query import region_histogram
from repro_torch.device import as_tensor, resolve_device
from repro_torch.kernels.ops import integral_histogram


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    num_bins: int = 16
    fragments: tuple[int, int] = (2, 2)     # fragment grid over the template
    search_radius: int = 12                 # candidate offsets per axis
    method: str = "wf_tis"
    backend: str = "auto"                   # "cuda" on the card


def _clamp_bbox(bbox: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Clamp [r0, c0, r1, c1] (inclusive) fully inside an (h, w) frame.

    A bbox taller or wider than the frame collapses to the frame edge
    rather than escaping it."""
    r0 = bbox[..., 0].clamp(0, h - 1)
    c0 = bbox[..., 1].clamp(0, w - 1)
    r1 = torch.minimum(torch.maximum(bbox[..., 2], r0), r0.new_tensor(h - 1))
    c1 = torch.minimum(torch.maximum(bbox[..., 3], c0), c0.new_tensor(w - 1))
    return torch.stack([r0, c0, r1, c1], dim=-1)


def _fragment_rects(bbox: torch.Tensor, grid: tuple[int, int]) -> torch.Tensor:
    """Split bboxes (..., 4) into (..., gr*gc, 4) grids of fragments."""
    r0, c0, r1, c1 = (bbox[..., i] for i in range(4))
    gr, gc = grid
    hh = (r1 - r0 + 1) // gr
    ww = (c1 - c0 + 1) // gc
    steps_r = torch.arange(gr, device=bbox.device, dtype=bbox.dtype)
    steps_c = torch.arange(gc, device=bbox.device, dtype=bbox.dtype)
    rows = r0[..., None] + steps_r * hh[..., None]            # (..., gr)
    cols = c0[..., None] + steps_c * ww[..., None]            # (..., gc)
    rr = rows[..., :, None].expand(*rows.shape, gc)
    cc = cols[..., None, :].expand(*cols.shape[:-1], gr, gc)
    hh = hh[..., None, None].expand_as(rr)
    ww = ww[..., None, None].expand_as(rr)
    rects = torch.stack([rr, cc, rr + hh - 1, cc + ww - 1], dim=-1)
    return rects.reshape(*bbox.shape[:-1], gr * gc, 4)


def _median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` over the last axis: the two middle values of the
    sorted axis, (low + high) * 0.5 (``torch.median`` takes the low one)."""
    n = x.shape[-1]
    s = torch.sort(x, dim=-1).values
    return (s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5


def _offsets(rad: int, device) -> torch.Tensor:
    """(n_cand, 4) candidate offsets [dr, dc, dr, dc] over the search
    square, rows outer (the reference's meshgrid order)."""
    d = torch.arange(-rad, rad + 1, device=device, dtype=torch.int64)
    drr, dcc = torch.meshgrid(d, d, indexing="ij")
    return torch.stack([drr, dcc, drr, dcc], dim=-1).reshape(-1, 4)


class VoteGeometry(NamedTuple):
    """Where the vote of t targets in each of n frames reads H, from the
    boxes alone: each target's 2 R + 1 clamped candidate tops and lefts
    (the candidates are their cross product, rows outer, the reference's
    meshgrid order) and each candidate's fragment corner lattice,
    ``top + k * hh - 1`` for k = 0..gr and ``left + j * ww - 1`` for
    j = 0..gc (-1 is the virtual zero row or column).  Fragment (i, j) of a
    candidate has its corners at lattice points (i, j) to (i + 1, j + 1).
    Its size is targets x (2 R + 1) x (grid + 1): no fragment rect is
    built.  int64 tensors on the boxes' device."""

    top: torch.Tensor        # (n, t, 2R + 1)
    left: torch.Tensor       # (n, t, 2R + 1)
    rows: torch.Tensor       # (n, t, 2R + 1, gr + 1)
    cols: torch.Tensor       # (n, t, 2R + 1, gc + 1)
    height: torch.Tensor     # (n, t): r1 - r0 of every candidate
    width: torch.Tensor      # (n, t): c1 - c0


def vote_geometry(bbox: torch.Tensor, grid: tuple[int, int], radius: int,
                  h: int, w: int) -> VoteGeometry:
    """The ``VoteGeometry`` of boxes (n, t, 4) in (h, w) frames.  A
    candidate is its box moved by an offset of the search square and
    clamped fully inside the frame; the upper bound is floored at 0 so a
    template as large as the frame pins to the origin."""
    b = bbox.to(torch.int64)
    gr, gc = (int(g) for g in grid)
    d = torch.arange(-radius, radius + 1, device=b.device)
    bh = b[..., 2] - b[..., 0]
    bw = b[..., 3] - b[..., 1]
    top = torch.minimum((b[..., :1] + d).clamp(min=0),
                        (h - 1 - bh).clamp(min=0)[..., None])
    left = torch.minimum((b[..., 1:2] + d).clamp(min=0),
                         (w - 1 - bw).clamp(min=0)[..., None])
    hh = torch.div(bh + 1, gr, rounding_mode="floor")[..., None, None]
    ww = torch.div(bw + 1, gc, rounding_mode="floor")[..., None, None]
    return VoteGeometry(
        top, left,
        top[..., None] + torch.arange(gr + 1, device=b.device) * hh - 1,
        left[..., None] + torch.arange(gc + 1, device=b.device) * ww - 1,
        bh, bw)


def candidate_rows(geom: VoteGeometry, h: int) -> np.ndarray:
    """The sorted H rows the vote reads, within [0, h)."""
    seen = np.zeros(h, bool)
    rows = np.minimum(geom.rows.cpu().numpy().ravel(), h - 1)  # as clamped
    seen[rows[rows >= 0]] = True
    return np.flatnonzero(seen)


def fragment_hists(H: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """Every candidate's fragment histograms: (n, t, C_r, C_c, gr, gc, b)
    from H (n, b, k, w), each target reading only its own frame.  ``rows``
    (n, t, C_r, gr + 1) and ``cols`` (n, t, C_c, gc + 1) index H's rows
    and columns (clamped in range), ``valid`` (n, t, C_r, C_c, gr + 1,
    gc + 1) is 1 where neither is virtual, else 0.  The lattice is read in
    one gather, each point as ``region_query._corner`` reads it, and each
    fragment combines its four corners in ``region_histogram``'s order,
    so it equals that fragment's region histogram bit for bit."""
    n = H.shape[0]
    frame = torch.arange(n, device=H.device).view(n, 1, 1, 1, 1, 1)
    L = H[frame, :, rows[:, :, :, None, :, None],
          cols[:, :, None, :, None, :]] * valid[..., None]
    return (L[..., 1:, 1:, :] - L[..., :-1, 1:, :] - L[..., 1:, :-1, :]
            + L[..., :-1, :-1, :])


def pick(sims: torch.Tensor, top: torch.Tensor, left: torch.Tensor,
         height: torch.Tensor, width: torch.Tensor):
    """The vote over ``sims`` (n, t, C_r, C_c, f), each candidate's
    fragment similarities: the median of the fragments, the first maximal
    candidate (rows outer).  Returns (its box (n, t, 4) int32, its score
    (n, t))."""
    n, t, c_r, c_c, f = sims.shape
    score = _median(sims.reshape(n, t, c_r * c_c, f))      # (n, t, C)
    best = torch.argmax(score, dim=-1, keepdim=True)         # (n, t, 1)
    r0 = torch.take_along_dim(top, torch.div(best, c_c,
                                             rounding_mode="floor"), -1)
    c0 = torch.take_along_dim(left, best % c_c, -1)
    box = torch.cat([r0, c0, r0 + height[..., None], c0 + width[..., None]],
                    dim=-1)
    return (box.to(torch.int32),
            torch.take_along_dim(score, best, dim=-1)[..., 0])


def vote_plain(H: torch.Tensor, bbox: torch.Tensor, ref: torch.Tensor,
               grid: tuple[int, int], radius: int, *, height: int | None = None,
               slot=None, reduce=None):
    """The vote in plain torch ops: (boxes (n, t, 4) int32, scores (n, t))
    for boxes ``bbox`` (n, t, 4) on H (n, b, k, w) against ``ref``
    ((n, t, gr gc, b) or broadcast).  A row slab of H gives the frame's
    ``height`` and ``slot``, the slab row of each frame row the lattice
    reads; ``reduce`` brings a slab's corner differences back to counts
    (``HSource._reduce``)."""
    from repro_torch.core import distances

    n, nb, k, w = H.shape
    h = k if height is None else height
    gr, gc = grid
    g = vote_geometry(bbox, grid, radius, h, w)
    rows = g.rows.clamp(0, h - 1)
    if slot is not None:
        rows = slot[rows]
    t, c = g.top.shape[1:]
    valid = ((g.rows >= 0)[:, :, :, None, :, None]
             & (g.cols >= 0)[:, :, None, :, None, :]).to(H.dtype)
    hists = fragment_hists(H, rows, g.cols.clamp(0, w - 1), valid)
    if reduce is not None:
        hists = reduce(hists).to(torch.float32)
    hists = hists.reshape(n, t, c * c, gr * gc, nb)
    ref = ref.to(H.device).broadcast_to((n, t, gr * gc, nb))
    sims = distances.intersection(hists, ref[:, :, None])
    return pick(sims.reshape(n, t, c, c, gr * gc), g.top, g.left, g.height,
                g.width)


class FragmentTracker:
    """Track template bbox(es) across frames via fragment histogram voting.

    State is a dict {"bbox", "ref_hists", "frag_offsets"} of tensors on
    the tracker's device; every field grows a leading target axis when
    ``init`` is given ``(t, 4)`` bboxes.  Boxes are int32.

    ``engine`` (a ``HistogramEngine``, core/engine.py) optionally supplies
    the H computation so the tracker shares one planned configuration with
    the rest of a pipeline; its bin count must match the config's, and the
    tracker runs on its device.  ``device=None`` is the card.
    """

    def __init__(self, config: TrackerConfig = TrackerConfig(), engine=None,
                 device=None):
        self.config = config
        if engine is not None:
            if engine.num_bins != config.num_bins:
                raise ValueError(
                    f"engine num_bins {engine.num_bins} != tracker "
                    f"num_bins {config.num_bins}")
            device = engine.device
        self._engine = engine
        self.device = None if device is None else str(device)
        self._dev = resolve_device(self.device)
        self._step_engine = None    # lazy default engine for fused/video

    # -- H computation (shared by init/step/track) --------------------------
    def _compute_h(self, frames) -> torch.Tensor:
        if self._engine is not None:
            return self._engine.compute_dense(frames)
        cfg = self.config
        return integral_histogram(frames, cfg.num_bins, method=cfg.method,
                                  backend=cfg.backend, device=self.device)

    def _default_engine(self):
        from repro_torch.core.engine import HistogramEngine

        if self._engine is not None:
            return self._engine
        if self._step_engine is None:
            cfg = self.config
            self._step_engine = HistogramEngine(
                num_bins=cfg.num_bins, method=cfg.method,
                backend=cfg.backend, device=self.device)
        return self._step_engine

    # -- public -------------------------------------------------------------
    def init(self, frame, bbox) -> dict:
        """bbox: [r0, c0, r1, c1] inclusive, (4,) or (t, 4) for t targets.

        The bbox is clamped fully inside the frame (an out-of-frame or
        oversized template has no pixels to describe)."""
        cfg = self.config
        h, w = frame.shape[-2:]
        bbox = _clamp_bbox(as_tensor(bbox, self._dev).to(torch.int32), h, w)
        H = self._compute_h(frame)
        frag_rects = _fragment_rects(bbox, cfg.fragments)     # ([t,] f, 4)
        frag_offsets = frag_rects - bbox[..., None, :]
        ref_hists = region_histogram(H, frag_rects)           # ([t,] f, b)
        return {"bbox": bbox, "ref_hists": ref_hists,
                "frag_offsets": frag_offsets}

    def step(self, state: dict, frame) -> dict:
        """Advance one frame (computes this frame's H, then votes)."""
        return self.step_on_h(state, self._compute_h(frame))

    def step_fused(self, state: dict, frame) -> dict:
        """``step`` without ever building the frame's H.

        The vote's candidate-fragment rects are enumerable on the host
        (bbox, search radius and fragment offsets are known between
        frames), so the whole step is ONE engine request: a
        ``RegionQuery`` over every candidate fragment, whose corner-row
        union the planner sees up front.  Small search radii fuse
        (``representation == "fused"``: K2 computes only those rows of
        H), large ones fall back to the dense vote.  The rects are built
        as ``_vote`` builds them, so the bbox equals ``step``'s.  Reading
        the bbox on the host syncs once a frame.

        Single-target only: a ``(t, 4)`` state delegates to ``step``.
        """
        if state["bbox"].ndim != 1:
            return self.step(state, frame)
        from repro_torch.core.engine import RegionQuery

        cfg = self.config
        h, w = np.shape(frame)[-2:]
        bbox = np.asarray(state["bbox"].cpu(), np.int64)
        cand = bbox[None, :] + _offsets(cfg.search_radius, "cpu").numpy()
        bh = int(bbox[2] - bbox[0])
        bw = int(bbox[3] - bbox[1])
        r0 = np.clip(cand[:, 0], 0, max(h - 1 - bh, 0))
        c0 = np.clip(cand[:, 1], 0, max(w - 1 - bw, 0))
        cand = np.stack([r0, c0, r0 + bh, c0 + bw], axis=-1)
        frag = cand[:, None, :] + np.asarray(state["frag_offsets"].cpu())

        out = self._default_engine().run(frame, [RegionQuery(frag)])
        hists = out.results[0]                               # (n, f, b)
        sims = distances.intersection(hists, state["ref_hists"][None])
        best = torch.argmax(_median(sims))
        new_bbox = as_tensor(cand, hists.device).to(torch.int32)[best]
        return {"bbox": new_bbox, "ref_hists": state["ref_hists"],
                "frag_offsets": state["frag_offsets"]}

    def init_fleet(self, frames, bbox) -> dict:
        """A fleet's first capture tick: ``frames`` (n, h, w), one frame a
        camera, and ``bbox`` (n, t, 4), t targets a camera, each clamped
        fully inside the frame.  One K1 launch for the tick; each target's
        fragment histograms are read from its own camera's H.  The state
        is ``init``'s with leading (n, t) axes, on the tracker's device."""
        cfg = self.config
        shape = tuple(np.shape(frames))
        if len(shape) != 3:
            raise ValueError(
                f"init_fleet wants (n, h, w) frames, one a camera, got "
                f"{shape}")
        bbox = as_tensor(bbox, self._dev).to(torch.int32)
        if bbox.ndim != 3 or bbox.shape[0] != shape[0] or bbox.shape[-1] != 4:
            raise ValueError(
                f"init_fleet wants (n, t, 4) boxes for {shape[0]} cameras, "
                f"got {tuple(bbox.shape)}")
        bbox = _clamp_bbox(bbox, *shape[-2:])
        H = self._compute_h(frames)                          # (n, b, h, w)
        frag_rects = _fragment_rects(bbox, cfg.fragments)    # (n, t, f, 4)
        ref_hists = region_histogram(H, frag_rects, paired=True)
        return {"bbox": bbox, "ref_hists": ref_hists,
                "frag_offsets": frag_rects - bbox[..., None, :]}

    def fleet_query(self, state: dict):
        """The ``engine.TrackQuery`` that steps every target of a fleet
        state once."""
        from repro_torch.core.engine import TrackQuery

        cfg = self.config
        return TrackQuery(state["bbox"], state["ref_hists"],
                          fragments=cfg.fragments, radius=cfg.search_radius)

    def step_fleet(self, state: dict, frames) -> dict:
        """Step every camera's targets through one capture tick: ``frames``
        (n, h, w), one frame a camera, in ONE ``HistogramEngine.run(frames,
        [fleet_query(state)])`` of the tracker's engine.  The boxes stay on
        the device; the host reads them once, for the plan's corner rows.
        The new state carries ``"score"`` (n, t), each winner's median
        fragment intersection, beside ``init_fleet``'s fields; it equals a
        loop of ``step_on_h`` over the cameras, bit for bit."""
        out = self._default_engine().run(frames, [self.fleet_query(state)])
        bbox, score = out.results[0]
        return {"bbox": bbox, "score": score,
                "ref_hists": state["ref_hists"],
                "frag_offsets": state["frag_offsets"]}

    def step_on_h(self, state: dict, H) -> dict:
        """Advance one frame given its precomputed H: the hook for
        pipelines that already stream integral histograms
        (``IntegralHistogram.map_frames`` / ``HistogramEngine``).  ``H``
        is a (b, h, w) tensor or any ``HSource`` (densified: the vote's
        candidate rects depend on the state, so corner-row compression
        does not apply)."""
        from repro_torch.core.hsource import HSource

        if isinstance(H, HSource):
            H = H.dense()
        return self._step_state(state, H)

    def track(self, state: dict, frames, *, batch_size: int | str = "auto",
              incremental: bool = False):
        """Track through a whole clip.

        Args:
          state: tracker state from ``init``.
          frames: (n, h, w) array or tensor, or any iterable of (h, w)
            frames.
          batch_size: frames per K1 launch (the chunk one dispatch
            tracks through).  ``"auto"`` asks the planner (core/engine.py)
            to size the chunk from the per-frame H footprint.
          incremental: thread each frame's H off its predecessor's through
            the engine's video-delta path (core/delta.py): a host loop
            hands ``prev=(frame_t, source_t)`` to ``HistogramEngine.run``
            so low-motion clips *update* the cached H, bit for bit.
            Ignores ``batch_size`` (the chain is sequential).

        The clip loop is ``runtime.FrameRuntime`` with the tracker state
        as the carry: a clip on the card is chunked by slicing; host
        frames are staged through pinned buffers on a copy stream.

        Returns:
          (final_state, boxes) with boxes (n, [t,] 4) int32: the bbox
          *after* each frame's update, equal to a per-frame ``step`` loop.
        """
        from repro_torch.core import engine as _engine
        from repro_torch.core.runtime import FrameRuntime

        if batch_size != "auto" and (
            not isinstance(batch_size, int) or batch_size < 1
        ):
            raise ValueError(
                f'batch_size must be a positive int or "auto", '
                f"got {batch_size!r}")
        if incremental:
            return self._track_incremental(state, frames)

        def empty():
            return state, state["bbox"].new_zeros(
                (0,) + tuple(state["bbox"].shape))

        if hasattr(frames, "shape"):
            if frames.ndim != 3:
                raise ValueError(
                    f"track expects an (n, h, w) clip, got "
                    f"{tuple(frames.shape)}; use step() for a single frame")
            if frames.shape[0] == 0:
                return empty()
            hw = frames.shape[-2:]
        else:
            it = iter(frames)
            try:
                first = next(it)
            except StopIteration:
                return empty()
            hw = first.shape[-2:]
            frames = itertools.chain([first], it)
        if batch_size == "auto":
            cfg = self.config
            batch_size = _engine.plan(_engine.WorkloadSpec(
                height=hw[0], width=hw[1], num_bins=cfg.num_bins,
                num_frames=None, method=cfg.method, backend=cfg.backend,
                device=self.device)).microbatch

        def step(chunk, st):
            st, chunk_boxes = self._track_chunk(st, chunk)
            return chunk_boxes, st

        runtime = FrameRuntime(step, depth=2, microbatch=batch_size,
                               carry_in=state, device=self.device)
        boxes, state = runtime.fold(frames, batched=True)
        return state, torch.cat(boxes, dim=0)

    def _track_incremental(self, state: dict, frames):
        """The video-delta clip loop: each frame's H is offered its
        predecessor's ``(frame, source)`` pair, so the engine updates
        dirty bands in place when motion is low.  Sequential by
        construction: the H of frame t seeds frame t+1."""
        engine = self._default_engine()
        boxes = []
        prev = None
        for frame in frames:
            out = engine.run(frame, prev=prev)
            state = self.step_on_h(state, out.source)
            boxes.append(state["bbox"])
            prev = (frame, out.source)
        if not boxes:
            return state, state["bbox"].new_zeros(
                (0,) + tuple(state["bbox"].shape))
        return state, torch.stack(boxes, dim=0)

    # -- internals ----------------------------------------------------------
    def _track_chunk(self, state: dict, frames):
        """One K1 launch for the chunk, then the state through its H's."""
        Hs = self._compute_h(frames)                  # (k, b, h, w)
        boxes = []
        for H in Hs:
            state = self._step_state(state, H)
            boxes.append(state["bbox"])
        return state, torch.stack(boxes, dim=0)

    def _step_state(self, state: dict, H: torch.Tensor) -> dict:
        single = state["bbox"].ndim == 1
        new_bbox = self._vote(
            H[None], state["bbox"].reshape(1, -1, 4),
            state["ref_hists"].reshape(1, -1,
                                       *state["ref_hists"].shape[-2:]))[0]
        return {"bbox": new_bbox[0] if single else new_bbox,
                "ref_hists": state["ref_hists"],
                "frag_offsets": state["frag_offsets"]}

    def _vote(self, H, bbox, ref_hists) -> torch.Tensor:
        """Candidate search for n frames' t targets at once, each on its
        own frame, through ``engine.TrackQuery``: H (n, b, h, w), bbox
        (n, t, 4), ref_hists (n, t, f, b).  Returns the new (n, t, 4)
        boxes."""
        from repro_torch.core.hsource import DenseH

        boxes, _ = self.fleet_query({"bbox": bbox, "ref_hists": ref_hists}
                                    ).apply(DenseH(H))
        return boxes
