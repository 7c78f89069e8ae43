"""A likelihood map: every window of one size at a stride scored against
the target histogram (``LikelihoodQuery``).

  ``{"kind": "likelihood", "window": [wh, ww], "stride": s}``
"""

from __future__ import annotations

import numpy as np

from portbench import check
from portbench.reference import plain

NUMBERS = ("map_gap",)
KEYS = {"kind", "window", "stride"}


def window_rows(h: int, window, stride: int) -> np.ndarray:
    """Corner rows the (wh, ww) window grid at ``stride`` reads."""
    wh = int(window[0])
    n_r = (h - wh) // stride + 1
    if n_r <= 0:
        return np.zeros((0,), np.int64)
    i = np.arange(n_r) * stride
    return np.concatenate([wh - 1 + i, i - 1])


def resolve(q: dict, h: int, w: int, gen: np.random.Generator) -> dict:
    if set(q) != KEYS:
        raise ValueError(f"a likelihood query takes {sorted(KEYS)}, got {q}")
    return {"kind": "likelihood",
            "window": tuple(int(v) for v in q["window"]),
            "stride": int(q["stride"])}


def program(spec: dict, target):
    from repro_torch.core import engine

    return engine.LikelihoodQuery(target, spec["window"],
                                  stride=spec["stride"])


def rows(spec: dict, h: int) -> np.ndarray:
    return window_rows(h, spec["window"], spec["stride"])


def reference(ids, num_bins: int, spec: dict, target, h_dtype=None):
    return plain.likelihood_map(ids, num_bins, target, spec["window"],
                                spec["stride"], h_dtype)


def answer(result, one_frame: bool):
    return result[None] if one_frame else result


def compare(got, want, spec: dict) -> dict:
    return {"map_gap": check.gap(got, want)}
