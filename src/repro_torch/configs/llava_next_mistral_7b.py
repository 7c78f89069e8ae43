"""LLaVA-NeXT (Mistral-7B backbone): VLM with anyres patch tiling.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.  The vision tower
is a stub: 576 precomputed patch embeddings per image arrive as a
sequence prefix.
Weights are random from a seed.  A copy of
``repro/configs/llava_next_mistral_7b.py``.
"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    modality="vision",
    num_prefix_embeds=576,
    rope_theta=1000000.0,
)
