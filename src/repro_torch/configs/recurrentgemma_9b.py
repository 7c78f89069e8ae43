"""RecurrentGemma-9B (Griffin): RG-LRU + local attention, 1 attn : 2 rec.
[arXiv:2402.19427; unverified]
38L d_model=4096 16H (GQA kv=1 = MQA, head_dim=256) d_ff=12288
vocab=256000, sliding window 2048, rnn width 4096.
Weights are random from a seed.  A copy of
``repro/configs/recurrentgemma_9b.py``.
"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    sliding_window=2048,
    block_pattern=("rec", "rec", "attn"),
    rnn_width=4096,
    rnn_scan_chunk=256,
    conv_kernel=4,
    scale_embeddings=True,
    logits_softcap=30.0,
)
