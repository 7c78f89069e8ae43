"""Mamba2-130M: attention-free SSD (state-space duality).

The published Mamba2-130M (Dao and Gu, arXiv:2405.21060; the
``state-spaces/mamba2-130m`` checkpoint): 24 layers, d_model 768,
vocabulary 50280, ssm_state 128, expand 2, head_dim 64, tied embeddings.
Weights are random from a seed until the checkpoint's files are in the
repository.  A copy of ``repro/configs/mamba2_130m.py``.
"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    ssm_groups=1,
    conv_kernel=4,
    tie_embeddings=True,
)
