"""SeamlessM4T-large-v2: multimodal encoder-decoder backbone.
[arXiv:2308.11596; hf]
24L (encoder) + 24L (decoder) d_model=1024 16H (kv=16, i.e. MHA,
head_dim=64) d_ff=8192 vocab=256206, LayerNorm.  The speech frontend is a
stub: the encoder takes precomputed frame embeddings (B, S_src, d_model).
Weights are random from a seed.  A copy of
``repro/configs/seamless_m4t_large_v2.py``.
"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    use_layer_norm=True,
    is_encoder_decoder=True,
    num_encoder_layers=24,
    num_decoder_layers=24,
    modality="audio",
    tie_embeddings=True,
)
