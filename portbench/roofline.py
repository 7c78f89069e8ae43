"""The yardstick of the roofline metrics: the card's peaks and the least
work of a request, counted from the cell's shapes and queries alone.

The count is of what the *request* needs, not of what a kernel does, so a
later kernel that replaces K1 or K2 is read against the same work:

* bytes: every pixel read once as handed over (1 B each), and of H only
  the rows the request's queries read (every row where they read every
  row, or where the request has no queries and asks for H itself),
  written once as fp32;
* operations: every pixel counted into its bin once, and every needed
  row's bins summed across the columns once.

The least time is the larger of bytes over the card's bandwidth and
operations over its fp32 rate.
"""

from __future__ import annotations

import numpy as np

from portbench import check

# NVIDIA H100 SXM data sheet (dense, at the 700 W power limit); the only
# card these peaks are read against.
CARD = "NVIDIA H100 80GB HBM3"
BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def needed_rows(queries: list, h: int) -> np.ndarray:
    """The sorted union of H rows a request's query specs read; every row
    for a request without queries, which asks for the whole H."""
    if not queries:
        return np.arange(h, dtype=np.int64)
    parts = [np.asarray(check.kind(q["kind"]).rows(q, h), np.int64)
             for q in queries]
    rows = np.unique(np.concatenate(parts))
    return rows[(rows >= 0) & (rows < h)]


def request_work(frames: int, h: int, w: int, num_bins: int,
                 rows: int) -> dict:
    """Least bytes and operations of one request of ``frames`` frames whose
    queries read ``rows`` rows of H."""
    pixels = frames * h * w
    out = frames * num_bins * rows * w
    return {"bytes": pixels + 4 * out, "ops": pixels + out}


def least_seconds(work: dict, kind: str | None) -> float:
    """The least time of ``work`` on the card named ``kind``; refuses any
    card but the one whose peaks are stated here."""
    if kind != CARD:
        raise ValueError(f"no peaks for the card {kind!r}; only {CARD!r}")
    return max(work["bytes"] / BYTES_PER_S, work["ops"] / FP32_FLOP_PER_S)
