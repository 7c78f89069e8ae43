"""The one traffic generator: a cell's frames and queries from ``--seed``.

A traffic file (``traffic/<name>.json``) holds parameters only; this
module is the one reader of them, so a new mix is a new data file.

Frames are seeded images with spatial structure: octaves of uniform noise
on coarse grids, each grid upsampled bilinearly to the frame and the
octaves summed, so neighbouring pixels agree and the bins are uneven, as
in real imagery.  They are made on the device in a few large calls and
copied once into a pool of page-locked host memory, ``pool_requests``
distinct requests' worth: the capture ring a GPU pipeline is fed from.
Request ``i`` hands over slot ``i % pool_requests``, so consecutive
requests carry different frames.

Each query of a traffic file names its kind, a module ``kinds/<kind>.py``
that resolves its parameters.  The likelihood kinds score windows
against one target histogram: the counts of a ``target.window`` patch of
the pool's first frame at a seeded place.  A traffic file without
queries asks for the frames' whole integral histogram.  Every seed gets
the same sizes and the same kinds of query; only the pixel values, the
boxes' places and the target change.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from portbench import check
from portbench.reference import plain

# Octaves of the frame generator: (grid cell in pixels, amplitude).
OCTAVES = ((256, 0.45), (48, 0.3), (8, 0.15), (1, 0.1))
# Pixels generated per device call.
_CHUNK_PIXELS = 1 << 26

# Streams of one seed: each use of randomness draws from its own.
FRAMES, QUERIES, TARGET, SAMPLE, ROWS = range(5)


def _entropy(seed: int, stream: int) -> list:
    """(seed, stream) as the non-negative words a SeedSequence takes; any
    whole seed, negative ones too."""
    return [int(seed) % (1 << 64), stream]


def rng(seed: int, stream: int) -> np.random.Generator:
    """The numpy generator of ``stream`` under ``seed``."""
    return np.random.default_rng(_entropy(seed, stream))


def torch_generator(seed: int, stream: int, device) -> torch.Generator:
    """A torch generator on ``device`` seeded from (seed, stream)."""
    state = np.random.SeedSequence(_entropy(seed, stream)).generate_state(2)
    g = torch.Generator(device=device)
    g.manual_seed(int(state[0]) << 31 | int(state[1]) >> 1)
    return g


def num_bins(cfg: dict) -> int:
    """The bins a configuration's engine counts into."""
    return int(cfg["engine"]["num_bins"])


def value_range(cfg: dict) -> int:
    """The pixel values a configuration's engine bins over."""
    return int(cfg["engine"]["value_range"])


@dataclasses.dataclass
class Inputs:
    """What the harness hands to the program and to the reference."""

    pool: torch.Tensor            # (slots, n, h, w) uint8, pinned on a card
    queries: list                 # query specs (dicts), resolved
    target: np.ndarray | None     # (num_bins,) float32 counts, or None

    def frames(self, slot: int, frames_per_request: int) -> np.ndarray:
        """The host frames of a slot as a NumPy view: (h, w) for a
        one-frame request, else (n, h, w)."""
        x = self.pool[slot]
        return (x[0] if frames_per_request == 1 else x).numpy()


def structured_frames(n: int, h: int, w: int, gen: torch.Generator,
                      device) -> torch.Tensor:
    """(n, h, w) uint8 frames with spatial structure, made on ``device``."""
    out = torch.empty((n, h, w), dtype=torch.uint8, device=device)
    per_call = max(1, _CHUNK_PIXELS // (h * w))
    total = sum(a for _, a in OCTAVES)
    for f0 in range(0, n, per_call):
        m = min(per_call, n - f0)
        x = torch.zeros((m, 1, h, w), dtype=torch.float32, device=device)
        for cell, amp in OCTAVES:
            grid = torch.rand((m, 1, -(-h // cell) + 1, -(-w // cell) + 1),
                              generator=gen, device=device)
            x += amp * F.interpolate(grid, size=(h, w), mode="bilinear",
                                     align_corners=True)
        out[f0:f0 + m] = (x[:, 0] * (256.0 / total)).clamp_(0, 255).to(
            torch.uint8)
    return out


def make_pool(cfg: dict, traffic: dict, seed: int, device) -> torch.Tensor:
    """The pool of frames, pinned in host memory when ``device`` is a card.

    Raises when a frame puts 2^24 pixels or more into one bin: its counts
    would leave the range in which fp32 holds integers exactly, which the
    configuration's guarantee excludes."""
    slots = int(traffic["pool_requests"])
    n = int(traffic["frames_per_request"])
    h, w = int(cfg["height"]), int(cfg["width"])
    gen = torch_generator(seed, FRAMES, device)
    made = structured_frames(slots * n, h, w, gen, device)
    bound = int(cfg["guarantees"]["exact_below"])
    nb, vr = num_bins(cfg), value_range(cfg)
    ids = plain.bin_ids(made, nb, vr)
    ids += torch.arange(ids.shape[0], device=ids.device).view(-1, 1, 1) * nb
    most = int(torch.bincount(ids.reshape(-1),
                              minlength=ids.shape[0] * nb).max())
    del ids
    if most >= bound:
        raise ValueError(
            f"a frame puts {most} pixels into one bin, past the exact "
            f"bound {bound}")
    pinned = torch.device(device).type == "cuda"
    pool = torch.empty((slots, n, h, w), dtype=torch.uint8,
                       pin_memory=pinned)
    pool.copy_(made.view(slots, n, h, w))
    return pool


def make_queries(cfg: dict, traffic: dict, seed: int) -> list:
    """The traffic's queries as specs, each resolved by its kind's module
    from the seed."""
    h, w = int(cfg["height"]), int(cfg["width"])
    gen = rng(seed, QUERIES)
    return [check.kind(q["kind"]).resolve(q, h, w, gen)
            for q in traffic["queries"]]


def make_target(cfg: dict, traffic: dict, seed: int,
                pool: torch.Tensor) -> np.ndarray | None:
    """The target histogram: counts of a seeded patch of the first frame."""
    spec = traffic.get("target")
    if spec is None:
        return None
    th, tw = (int(v) for v in spec["window"])
    h, w = int(cfg["height"]), int(cfg["width"])
    gen = rng(seed, TARGET)
    r0 = int(gen.integers(0, h - th + 1))
    c0 = int(gen.integers(0, w - tw + 1))
    patch = pool[0, 0, r0:r0 + th, c0:c0 + tw].numpy().astype(np.int64)
    nb = num_bins(cfg)
    ids = np.clip(patch * nb // value_range(cfg), 0, nb - 1)
    return np.bincount(ids.ravel(), minlength=nb).astype(np.float32)


def make_inputs(cfg: dict, traffic: dict, seed: int, device) -> Inputs:
    pool = make_pool(cfg, traffic, seed, device)
    return Inputs(pool=pool, queries=make_queries(cfg, traffic, seed),
                  target=make_target(cfg, traffic, seed, pool))
