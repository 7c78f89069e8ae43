"""Deterministic synthetic data (numpy only)."""

from repro_torch.data.synthetic import TokenStream, make_stream, video_frames

__all__ = ["TokenStream", "make_stream", "video_frames"]
