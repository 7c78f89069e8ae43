"""Architecture registry: one module per arch, exact configs.

Port of ``repro/configs/__init__.py``.  ``ARCH_IDS`` lists every
architecture of the reference; ``get_config`` returns the full published
config of one whose family the port runs (ssm, dense, moe, vlm), and
raises ``NotImplementedError`` for the rest (the hybrid and encdec
families, ROADMAP 1.9c).  ``smoke_config(...)`` returns the reduced
same-family config the CPU tests run, computed as the reference computes
it.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.config import ModelConfig, SHAPES, ShapeConfig, cell_is_runnable

ARCH_IDS = (
    "llama4-scout-17b-a16e",
    "kimi-k2-1t-a32b",
    "qwen2.5-3b",
    "qwen3-4b",
    "llama3-8b",
    "qwen2-1.5b",
    "llava-next-mistral-7b",
    "seamless-m4t-large-v2",
    "mamba2-130m",
    "recurrentgemma-9b",
)

# Architectures whose model family has been ported (ROADMAP 1.9).
PORTED = (
    "llama4-scout-17b-a16e",
    "kimi-k2-1t-a32b",
    "qwen2.5-3b",
    "qwen3-4b",
    "llama3-8b",
    "qwen2-1.5b",
    "llava-next-mistral-7b",
    "mamba2-130m",
)


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    if arch_id not in PORTED:
        raise NotImplementedError(
            f"{arch_id!r}: its model family is not ported yet (ROADMAP "
            f"1.9c: Griffin, then encdec); ported: {PORTED}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_module_name(arch_id)}")
    return mod.CONFIG


def smoke_config(arch_id: str) -> ModelConfig:
    """Reduced same-family config: runs a real forward step on CPU."""
    cfg = get_config(arch_id)
    r = dict(
        num_layers=max(2, min(4, cfg.num_layers // 12)),
        d_model=128,
        vocab_size=512,
        head_dim=32,
        flash_min_seq=64,            # exercise the chunked-attention path
        attn_block_kv=32,
        remat="dots",
    )
    if cfg.num_heads:
        r["num_heads"] = 4
        r["num_kv_heads"] = min(2, cfg.num_kv_heads)
    if cfg.d_ff:
        r["d_ff"] = 256
    if cfg.is_moe:
        r.update(num_experts=4,
                 num_experts_per_token=min(2, cfg.num_experts_per_token),
                 expert_d_ff=64,
                 num_shared_experts=min(1, cfg.num_shared_experts),
                 first_k_dense=min(1, cfg.first_k_dense),
                 num_layers=3)
    if cfg.family == "ssm":
        r.update(ssm_state=16, ssm_chunk=16, ssm_head_dim=16)
    if cfg.family == "hybrid":
        r.update(rnn_width=128, rnn_scan_chunk=16, num_layers=5,
                 sliding_window=32)
    if cfg.sliding_window and cfg.family != "hybrid":
        r["sliding_window"] = 32
    if cfg.is_encoder_decoder:
        r.update(num_encoder_layers=2, num_decoder_layers=2, num_layers=2)
    if cfg.num_prefix_embeds:
        r["num_prefix_embeds"] = 8
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **r)


__all__ = ["ARCH_IDS", "PORTED", "get_config", "smoke_config",
           "SHAPES", "ShapeConfig", "cell_is_runnable", "ModelConfig"]
