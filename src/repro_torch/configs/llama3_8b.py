"""llama3-8b — GQA, 128k vocab [arXiv:2407.21783]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4_096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14_336,
    vocab_size=128_256,
    activation="silu",
    gated_mlp=True,
    rope_theta=500_000.0,
    train_microbatches=4,
)

SMOKE_CONFIG = CONFIG.replace(
    name="llama3-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab_size=256,
)
