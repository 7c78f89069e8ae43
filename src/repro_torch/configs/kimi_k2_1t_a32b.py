"""Kimi-K2: trillion-parameter MoE (paper-table). [arXiv:2501.kimi2; unverified]
61L d_model=7168 64H (GQA kv=8) expert_d_ff=2048
vocab=163840, 384 routed experts top-8 + 1 shared, first layer dense.
Weights are random from a seed.  A copy of
``repro/configs/kimi_k2_1t_a32b.py``.
"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=18432,                 # the single dense layer (DeepSeek-V3 style)
    vocab_size=163840,
    num_experts=384,
    num_experts_per_token=8,
    expert_d_ff=2048,
    num_shared_experts=1,
    first_k_dense=1,
    rope_theta=50000.0,
)
