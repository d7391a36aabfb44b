"""mamba2-130m — SSD (state-space duality) [arXiv:2405.21060].

24L d_model=768, attn-free, vocab=50280, ssm_state=128.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_head=0,
    d_ff=0,
    vocab_size=50_280,
    tie_embeddings=True,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_chunk=256,
    ssm_conv=4,
    ssm_ngroups=1,
    optimizer="adamw",
)

SMOKE_CONFIG = CONFIG.replace(
    name="mamba2-smoke",
    n_layers=2,
    d_model=64,
    vocab_size=256,
    ssm_state=16,
    ssm_headdim=16,
    ssm_chunk=16,
)
