"""Deterministic, seekable synthetic data (numpy only).

The port's own copy of ``repro/data/synthetic.py``:

* ``TokenStream``: synthetic LM batches.  ``batch_at(step)`` is a pure
  function of (seed, step), so resuming training from a checkpoint at step
  k replays exactly the batches k, k+1, ... with no stored cursor: the
  data-side half of checkpoint/restart (train/fault.py).  The mix is the
  reference's (an arithmetic pattern in ``pattern_frac`` of the rows,
  uniform noise in the rest), drawn from a numpy ``Generator`` seeded with
  (seed, step): not ``jax.random``'s bits, which torch cannot reproduce,
  so tests hand both packages the same numpy batch.
* ``video_frames``: the integral-histogram frames, numpy in both packages,
  so the same seed gives the same frames.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TokenStream:
    """Synthetic LM data: shifted-label random tokens + structure.

    Tokens mix a deterministic arithmetic pattern with noise so the loss
    is learnable.  ``batch_at`` returns int32 CPU tensors "tokens" and
    "labels" (batch, seq_len); the train step moves them to the card.
    """
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    pattern_frac: float = 0.7

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng([self.seed, step])
        b, s, v = self.batch, self.seq_len, self.vocab_size
        # arithmetic progressions (learnable) + uniform noise (not)
        start = rng.integers(0, v, (b, 1))
        stride = rng.integers(1, 7, (b, 1))
        pattern = (start + stride * np.arange(s + 1)[None, :]) % v
        noise = rng.integers(0, v, (b, s + 1))
        use_pattern = rng.random((b, 1)) < self.pattern_frac
        toks = torch.as_tensor(
            np.where(use_pattern, pattern, noise).astype(np.int32))
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_stream(cfg, batch: int, seq_len: int, seed: int = 0):
    """The stream for a ModelConfig of a ported family.  The reference's
    ``MultimodalStream`` (vlm and audio) comes with their training (ROADMAP
    1.9c)."""
    if cfg.family in ("vlm", "audio"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family's stream is not ported "
            "yet (ROADMAP 1.9c)")
    return TokenStream(cfg.vocab_size, batch, seq_len, seed)


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
