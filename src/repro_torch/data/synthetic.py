"""Deterministic video frames for the integral-histogram pipeline.

The port's own copy of ``repro/data/synthetic.py::video_frames``: numpy
only, so the same seed gives the same frames in both packages.
"""

from __future__ import annotations

import numpy as np


def video_frames(h: int, w: int, num_frames: int, seed: int = 0,
                 num_blobs: int = 3) -> np.ndarray:
    """Deterministic uint8 frame sequence: moving Gaussian blobs over
    banded texture.  Shape (num_frames, h, w)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = (
        40.0 * (1 + np.sin(2 * np.pi * yy / 64))
        + 40.0 * (1 + np.sin(2 * np.pi * xx / 96))
    )
    pos = rng.uniform(0.2, 0.8, (num_blobs, 2)) * [h, w]
    vel = rng.uniform(-4, 4, (num_blobs, 2))
    amp = rng.uniform(60, 120, (num_blobs,))
    sig = rng.uniform(h / 16, h / 6, (num_blobs,))
    frames = np.empty((num_frames, h, w), np.uint8)
    for t in range(num_frames):
        img = base + 8.0 * rng.standard_normal((h, w)).astype(np.float32)
        for i in range(num_blobs):
            cy, cx = pos[i]
            img += amp[i] * np.exp(
                -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig[i] ** 2))
            pos[i] += vel[i]
            pos[i] %= [h, w]
        frames[t] = np.clip(img, 0, 255).astype(np.uint8)
    return frames
