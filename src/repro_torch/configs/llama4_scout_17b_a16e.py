"""Llama-4-Scout-17B-16E: early-fusion MoE decoder LM.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
48L d_model=5120 40H (GQA kv=8) expert_d_ff=8192 vocab=202048, 16 routed
experts top-1 + 1 shared expert (source config).
Weights are random from a seed.  A copy of
``repro/configs/llama4_scout_17b_a16e.py``.
"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    num_experts=16,
    num_experts_per_token=1,
    expert_d_ff=8192,
    num_shared_experts=1,
    rope_theta=500000.0,
)
