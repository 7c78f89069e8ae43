"""Deterministic synthetic data (numpy only)."""

from repro_torch.data.synthetic import video_frames

__all__ = ["video_frames"]
