"""Deterministic synthetic data (numpy only)."""

from repro_torch.data.synthetic import (
    MultimodalStream, TokenStream, make_stream, video_frames,
)

__all__ = ["MultimodalStream", "TokenStream", "make_stream", "video_frames"]
