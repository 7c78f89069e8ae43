"""Qwen3-4B: dense GQA decoder LM with qk_norm. [hf:Qwen/Qwen3-*; hf]
36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936.
Weights are random from a seed.  A copy of
``repro/configs/qwen3_4b.py``.
"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1000000.0,
)
