"""The plain reference of a fleet's tracker tick: every camera's targets
stepped once by fragment voting (Adam et al., CVPR 2006), in plain torch.

Imports nothing of the port: it works from the frames' bin ids and the
boxes, grid, radius and reference histogram the harness hands to both
sides, and loops over cameras and targets.  For each camera it builds the
frame's integral histogram (``plain.h_rows`` of every row, exact in int64),
pads it with the virtual zero row and column, and for each target reads
every candidate's fragment counts by the four-corner rule:

* candidates: the box moved by each offset (dr, dc) of the search square,
  dr outer, each clamped fully inside the frame (the upper bound floored
  at 0);
* fragments: the box cut into a gr x gc grid of (h // gr) x (w // gc)
  cells, row-major, the remainder rows and columns left out;
* the vote: each fragment's intersection with its reference histogram
  (``plain.intersection``, bins summed in order), the median of the
  fragments (the mean of the two middle values of an even count), the
  first candidate with the largest median.

``h_dtype`` rounds H through a float type before any count is read, as
every function of ``plain`` does: the control.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import plain


def _candidate_boxes(box, radius: int, h: int, w: int) -> torch.Tensor:
    """(C, 4) int64 candidates of one box, offsets dr outer."""
    r0, c0, r1, c1 = (int(v) for v in box)
    bh, bw = r1 - r0, c1 - c0
    d = torch.arange(-radius, radius + 1, dtype=torch.int64)
    rr = (r0 + d).clamp(0, max(h - 1 - bh, 0))
    cc = (c0 + d).clamp(0, max(w - 1 - bw, 0))
    r, c = torch.meshgrid(rr, cc, indexing="ij")
    r, c = r.reshape(-1), c.reshape(-1)
    return torch.stack([r, c, r + bh, c + bw], dim=-1)


def _fragments(cand: torch.Tensor, grid) -> torch.Tensor:
    """(C, gr * gc, 4) fragment rects of each candidate, row-major."""
    gr, gc = (int(g) for g in grid)
    hh = (cand[:, 2] - cand[:, 0] + 1) // gr
    ww = (cand[:, 3] - cand[:, 1] + 1) // gc
    out = []
    for i in range(gr):
        for j in range(gc):
            r = cand[:, 0] + i * hh
            c = cand[:, 1] + j * ww
            out.append(torch.stack([r, c, r + hh - 1, c + ww - 1], dim=-1))
    return torch.stack(out, dim=1)


def _counts(Hp: torch.Tensor, rects: torch.Tensor) -> torch.Tensor:
    """(..., b) counts of inclusive rects over a zero-padded H (b, h+1,
    w+1), in H's dtype."""
    rects = rects.to(Hp.device)
    r0, c0 = rects[..., 0], rects[..., 1]
    r1, c1 = rects[..., 2] + 1, rects[..., 3] + 1
    out = Hp[:, r1, c1] - Hp[:, r0, c1] - Hp[:, r1, c0] + Hp[:, r0, c0]
    return out.movedim(0, -1)


def _median(x: torch.Tensor) -> torch.Tensor:
    s = torch.sort(x, dim=-1).values
    n = x.shape[-1]
    return (s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5


def tick(ids: torch.Tensor, num_bins: int, boxes, target, grid, radius: int,
         h_dtype=None):
    """One tick: ``ids`` (n, h, w) bin ids, one frame a camera; ``boxes``
    (n, t, 4).  Returns (new boxes (n, t, 4) int32, their median
    intersections (n, t) fp32), on ``ids``' device."""
    n, h, w = ids.shape
    boxes = torch.as_tensor(boxes, dtype=torch.int64).cpu()
    t = torch.as_tensor(target, dtype=torch.float32, device=ids.device)
    out_boxes = torch.empty((n, boxes.shape[1], 4), dtype=torch.int32)
    out_scores = torch.empty((n, boxes.shape[1]), dtype=torch.float32,
                             device=ids.device)
    for i in range(n):
        H = plain.h_rows(ids[i:i + 1], num_bins, torch.arange(h), h_dtype)[0]
        Hp = F.pad(H, (1, 0, 1, 0))
        del H
        for j in range(boxes.shape[1]):
            cand = _candidate_boxes(boxes[i, j], radius, h, w)
            hists = _counts(Hp, _fragments(cand, grid)).to(torch.float32)
            score = _median(plain.intersection(hists, t))       # (C,)
            best = int(torch.argmax(score))
            out_boxes[i, j] = cand[best].to(torch.int32)
            out_scores[i, j] = score[best]
        del Hp
    return out_boxes.to(ids.device), out_scores
