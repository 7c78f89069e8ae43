"""Configuration system: model configs and input-shape cells.

Port of ``repro/config.py``: ``ModelConfig`` with every field and
property, ``ShapeConfig``, ``SHAPES`` and ``cell_is_runnable``, unchanged.
Every architecture is a ``ModelConfig`` in repro_torch/configs/<id>.py.
The reference's ``HW`` table (TPU peak and bandwidth figures for its
roofline) is left out: the port states no TPU number.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 128
    d_ff: int = 0
    vocab_size: int = 32000

    # attention options
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: Optional[int] = None   # local attention window (tokens)
    rope_theta: float = 10000.0
    logits_softcap: float = 0.0

    # MoE
    num_experts: int = 0
    num_experts_per_token: int = 0
    expert_d_ff: int = 0
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    first_k_dense: int = 0            # leading dense (non-MoE) layers
    router_aux_coef: float = 0.01

    # SSM (Mamba-2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_groups: int = 1
    conv_kernel: int = 4
    # sequence parallelism for the SSD scan: shard the sequence over the
    # model axis; chunk-boundary states propagate via a ppermute carry
    # wavefront (the paper's tiled-scan carry at ICI scale — §Perf C)
    ssm_seq_parallel: bool = False

    # hybrid (Griffin / RecurrentGemma)
    block_pattern: tuple = ()         # e.g. ("rec", "rec", "attn")
    rnn_width: int = 0
    rnn_scan_chunk: int = 256
    # sequence parallelism for the RG-LRU scan (same ppermute carry
    # wavefront as ssm_seq_parallel; local-attn layers stay as-is)
    rnn_seq_parallel: bool = False

    # encoder-decoder
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    num_decoder_layers: int = 0

    # multimodal stub frontend (assignment: precomputed patch/frame embeds)
    modality: Optional[str] = None    # "vision" | "audio"
    num_prefix_embeds: int = 0        # patches/frames occupying prefix positions

    # numerics / layout
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    use_layer_norm: bool = False      # LayerNorm (enc-dec) vs RMSNorm
    tie_embeddings: bool = False
    scale_embeddings: bool = False
    remat: str = "full"               # "none" | "dots" | "full"
    scan_layers: bool = True
    attn_block_kv: int = 1024         # flash/chunked attention KV block
    flash_min_seq: int = 8192         # use chunked attention at/above this

    # training defaults
    optimizer: str = "adamw"          # "adamw" | "adafactor"

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 2048 so the unembed TP shard
        is lane-aligned on every mesh (param shapes use this; the loss
        masks the padding; 6ND uses the exact vocab_size)."""
        return -(-self.vocab_size // 2048) * 2048

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid-with-local-attn only)."""
        return self.family in ("ssm", "hybrid")

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def param_count(self) -> int:
        """Approximate total parameter count N (for 6ND model-FLOPs)."""
        d, v = self.d_model, self.vocab_size
        embed = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            d_in = self.ssm_expand * d
            nheads = d_in // self.ssm_head_dim
            per = (
                d * (2 * d_in + 2 * self.ssm_groups * self.ssm_state + nheads)
                + d_in * d + self.conv_kernel * (d_in + 2 * self.ssm_groups * self.ssm_state)
            )
            return embed + self.num_layers * per
        hd, hq, hkv = self.head_dim, self.num_heads, self.num_kv_heads
        attn = d * hd * (hq + 2 * hkv) + hq * hd * d
        if self.is_moe:
            ff = 3 * d * self.expert_d_ff * (
                self.num_experts + self.num_shared_experts
            ) + d * self.num_experts
        else:
            ff = 3 * d * self.d_ff
        if self.family == "hybrid":
            # mix of recurrent and attention mixers, plus MLPs
            n_attn = sum(1 for b in self._pattern() if b == "attn")
            n_rec = self.num_layers - n_attn
            w = self.rnn_width
            rec = d * w * 2 + w * d + 3 * w  # branches + out + gates/conv approx
            return embed + n_attn * (attn + 3 * d * self.d_ff) + n_rec * (rec + 3 * d * self.d_ff)
        layers = self.num_layers * (attn + ff)
        if self.is_encoder_decoder:
            layers = (self.num_encoder_layers + self.num_decoder_layers) * (attn + ff)
            layers += self.num_decoder_layers * attn  # cross-attention
        return embed + layers

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k + shared experts only)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        total = self.param_count()
        all_ff = 3 * d * self.expert_d_ff * self.num_experts * self.num_layers
        active_ff = (
            3 * d * self.expert_d_ff * self.num_experts_per_token * self.num_layers
        )
        return total - all_ff + active_ff

    def _pattern(self) -> tuple:
        if not self.block_pattern:
            return ()
        reps = -(-self.num_layers // len(self.block_pattern))
        return (self.block_pattern * reps)[: self.num_layers]


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                          # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def cell_is_runnable(model: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not model.sub_quadratic:
        return False, (
            "skipped: pure full-attention architecture has no sub-quadratic "
            "path for 512k context (DESIGN.md §Arch-applicability)"
        )
    return True, ""
