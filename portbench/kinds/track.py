"""A fleet's tracker tick: every camera's targets stepped once by fragment
voting, each on its own camera's frame (``TrackQuery``).

  ``{"kind": "track", "cameras": n, "targets": t, "template": [th, tw],
     "fragments": [gr, gc], "radius": r}``

A request's frames are the tick's, one a camera, so ``cameras`` is the
traffic's ``frames_per_request``.  Each camera's ``targets`` boxes of
``template`` pixels are seeded inside the frame; every fragment's
reference histogram is the traffic's target.  The answer is the new boxes
(n, t, 4) and their median fragment intersections (n, t).
"""

from __future__ import annotations

import numpy as np

from portbench import check
from portbench.reference import track

NUMBERS = ("box_gap", "score_gap")
KEYS = {"kind", "cameras", "targets", "template", "fragments", "radius"}


def resolve(q: dict, h: int, w: int, gen: np.random.Generator) -> dict:
    if set(q) != KEYS:
        raise ValueError(f"a track query takes {sorted(KEYS)}, got {q}")
    n, t = int(q["cameras"]), int(q["targets"])
    th, tw = (int(v) for v in q["template"])
    if not (0 < th <= h and 0 < tw <= w):
        raise ValueError(f"a {th}x{tw} template does not fit {h}x{w}")
    r0 = gen.integers(0, h - th + 1, (n, t))
    c0 = gen.integers(0, w - tw + 1, (n, t))
    boxes = np.stack([r0, c0, r0 + th - 1, c0 + tw - 1], axis=-1)
    return {"kind": "track", "boxes": boxes.astype(np.int64),
            "fragments": tuple(int(v) for v in q["fragments"]),
            "radius": int(q["radius"])}


def program(spec: dict, target):
    from repro_torch.core import engine

    return engine.TrackQuery(spec["boxes"], target,
                             fragments=spec["fragments"],
                             radius=spec["radius"])


def rows(spec: dict, h: int) -> np.ndarray:
    """The corner rows of every candidate's fragments: for each of a box's
    2 r + 1 clamped candidate tops, the gr + 1 rows top + k * (box height
    // gr) - 1."""
    boxes = spec["boxes"].reshape(-1, 4)
    gr, rad = spec["fragments"][0], spec["radius"]
    bh = boxes[:, 2] - boxes[:, 0]
    top = np.clip(boxes[:, :1] + np.arange(-rad, rad + 1), 0,
                  np.maximum(h - 1 - bh, 0)[:, None])
    step = ((bh + 1) // gr)[:, None, None]
    out = np.unique(top[:, :, None] + np.arange(gr + 1) * step - 1)
    return out[(out >= 0) & (out < h)]


def reference(ids, num_bins: int, spec: dict, target, h_dtype=None):
    return track.tick(ids, num_bins, spec["boxes"], target,
                      spec["fragments"], spec["radius"], h_dtype)


def answer(result, one_frame: bool):
    boxes, scores = result
    return (boxes[None], scores[None]) if one_frame else (boxes, scores)


def compare(got, want, spec: dict) -> dict:
    if got is None:
        return dict.fromkeys(NUMBERS, float("inf"))
    return {"box_gap": check.gap(got[0], want[0]),
            "score_gap": check.gap(got[1], want[1])}
