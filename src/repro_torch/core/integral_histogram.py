"""Public API: the integral histogram as a configured operator.

Port of ``repro/core/integral_histogram.py``:

>>> ih = IntegralHistogram(num_bins=32)
>>> H = ih(image)                          # (32, h, w) on the GPU
>>> Hs = ih(stack)                         # (n, 32, h, w), one launch
>>> hist = ih.query(H, [r0, c0, r1, c1])   # O(1) region histogram
>>> wins = ih.sliding_windows(Hs, (24, 24))  # (n, n_r, n_c, 32)

>>> bands = ih.map_bands(big, memory_budget_bytes=512 << 20)  # BandH stream
>>> for H in ih.map_frames(video_frames):  # streamed, §4.4 overlap
...     ...
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable, Iterator

from repro_torch.core import region_query
from repro_torch.kernels.ops import integral_histogram as _compute


@dataclasses.dataclass(frozen=True)
class IntegralHistogram:
    """Configured integral-histogram operator.

    Attributes:
      num_bins: histogram bins b.
      method: "cw_b" | "cw_sts" | "cw_tis" | "wf_tis" (paper's four).
      backend: "auto" | "cuda" | "torch" (kernels/ops.py).
      tile: strip height of the plain scans.
      bin_block: bins per CTA of the CUDA kernel (None = from the shape).
      value_range: integer pixel range (floats are binned over [0, 1)).
      device: where it runs (None = the GPU, "cpu" for the plain path).
    """

    num_bins: int = 32
    method: str = "wf_tis"
    backend: str = "auto"
    tile: int = 128
    bin_block: int | None = None
    value_range: int | None = 256
    device: str | None = None

    def __call__(self, image):
        """(h, w) -> (num_bins, h, w); (n, h, w) -> (n, num_bins, h, w)."""
        return _compute(
            image,
            self.num_bins,
            method=self.method,
            backend=self.backend,
            tile=self.tile,
            bin_block=self.bin_block,
            value_range=self.value_range,
            device=self.device,
        )

    def map_frames(
        self,
        frames: Iterable,
        *,
        batch_size: int | str = "auto",
        depth: int = 2,
    ) -> Iterator:
        """Stream integral histograms over a frame sequence.

        Microbatches ``batch_size`` frames per dispatch and keeps ``depth``
        dispatches in flight (paper §4.4's dual-buffering, through
        ``core/runtime.py``: host frames are staged through pinned buffers
        on a copy stream), yielding one (num_bins, h, w) H per frame in
        order.  ``batch_size="auto"`` asks the planner (core/engine.py) to
        size the microbatch from the per-frame H footprint;
        ``"adaptive"`` starts from the planner's size and lets the runtime
        retune it online from measured per-dispatch latency.
        """
        from repro_torch.core.runtime import FrameRuntime

        frames = iter(frames)
        try:
            first = next(frames)
        except StopIteration:
            return iter(())
        adaptive = batch_size == "adaptive"
        if isinstance(batch_size, str):
            if batch_size not in ("auto", "adaptive"):
                raise ValueError(
                    f'batch_size must be an int, "auto" or "adaptive", '
                    f"got {batch_size!r}")
            from repro_torch.core import engine as _engine

            h, w = first.shape[-2:]
            batch_size = _engine.plan(_engine.WorkloadSpec(
                height=h, width=w, num_bins=self.num_bins, num_frames=None,
                method=self.method, backend=self.backend,
                device=self.device)).microbatch
        runtime = FrameRuntime(
            FrameRuntime.stateless(self), depth=depth, device=self.device,
            microbatch=batch_size, adaptive=adaptive)
        return runtime.map_frames(itertools.chain([first], frames))

    def map_bands(
        self,
        image,
        *,
        band_h: int | None = None,
        memory_budget_bytes: int | None = None,
        prefetch: int = 0,
    ):
        """Stream H as row bands under a memory budget (core/bands.py).

        For frames whose (num_bins, h, w) H does not fit on the card this
        yields ``BandH`` chunks, each with the band's H and its (b, w)
        bottom-row carry, equal bit for bit to the monolithic result.
        Wrap the stream in ``BandedH`` (or hand a zero-arg factory of it)
        for O(1) analytics that never hold H.  ``prefetch >= 1`` stages
        the next band's rows while the current band computes.
        """
        from repro_torch.core import bands

        return bands.iter_banded_ih(
            image, self.num_bins,
            band_h=band_h, memory_budget_bytes=memory_budget_bytes,
            prefetch=prefetch, device=self.device,
            method=self.method, backend=self.backend, tile=self.tile,
            bin_block=self.bin_block, value_range=self.value_range,
        )

    def engine(self, **overrides):
        """A ``HistogramEngine`` sharing this operator's configuration."""
        from repro_torch.core.engine import HistogramEngine

        kwargs = dict(
            method=self.method, backend=self.backend, tile=self.tile,
            bin_block=self.bin_block, value_range=self.value_range,
            device=self.device,
        )
        kwargs.update(overrides)
        return HistogramEngine(self.num_bins, **kwargs)

    # ---- O(1) analytics on a computed H (tensor or any HSource) ----
    query = staticmethod(region_query.region_histogram)
    sliding_windows = staticmethod(region_query.sliding_window_histograms)
    likelihood_map = staticmethod(region_query.likelihood_map)
    multi_scale_search = staticmethod(region_query.multi_scale_search)

    # ---- deprecated: the unified entry points above accept a BandedH ----
    # analysis: allow-shim-use(public deprecated aliases kept until their removal release; they re-export, not consume)
    banded_query = staticmethod(region_query.banded_region_histogram)
    banded_sliding_windows = staticmethod(
        # analysis: allow-shim-use(public deprecated aliases kept until their removal release; they re-export, not consume)
        region_query.banded_sliding_window_histograms)
    # analysis: allow-shim-use(public deprecated aliases kept until their removal release; they re-export, not consume)
    banded_likelihood_map = staticmethod(region_query.banded_likelihood_map)
