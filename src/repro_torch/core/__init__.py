"""Core: integral histograms and their O(1) queries, in torch.

The engine, HSource, runtime and tracker names are re-exported lazily, as
in ``repro.core``: ``core.engine`` imports ``kernels.ops``, which imports
this package.
"""

from repro_torch.core.binning import PAD_BIN, bin_indices, one_hot_bins
from repro_torch.core.scans import (
    METHODS, apply_carry, cw_b, cw_sts, cw_tis, wf_tis,
)

_ENGINE_EXPORTS = {
    "WorkloadSpec", "ExecutionPlan", "MeshLayout", "plan", "HistogramEngine",
    "EngineResult", "RegionQuery", "SlidingWindowQuery", "LikelihoodQuery",
    "MultiScaleQuery",
}
_HSOURCE_EXPORTS = {"HSource", "DenseH", "BandedH", "FusedRowsH", "ShardedH",
                    "as_hsource"}
_RUNTIME_EXPORTS = {"FrameRuntime", "AdaptiveMicrobatch", "RuntimeStats",
                    "DispatchResult", "stage_stream"}
_TRACKING_EXPORTS = {"FragmentTracker", "TrackerConfig"}

__all__ = [
    "PAD_BIN", "bin_indices", "one_hot_bins",
    "METHODS", "apply_carry", "cw_b", "cw_sts", "cw_tis", "wf_tis",
    *sorted(_ENGINE_EXPORTS), *sorted(_HSOURCE_EXPORTS),
    *sorted(_RUNTIME_EXPORTS), *sorted(_TRACKING_EXPORTS),
]


def __getattr__(name):
    if name in _ENGINE_EXPORTS:
        from repro_torch.core import engine

        return getattr(engine, name)
    if name in _HSOURCE_EXPORTS:
        from repro_torch.core import hsource

        return getattr(hsource, name)
    if name in _RUNTIME_EXPORTS:
        from repro_torch.core import runtime

        return getattr(runtime, name)
    if name in _TRACKING_EXPORTS:
        from repro_torch.core import tracking

        return getattr(tracking, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
