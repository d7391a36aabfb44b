"""nemotron-4-15b — GQA, squared-ReLU (ungated) MLP [arXiv:2402.16819]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6_144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=24_576,
    vocab_size=256_000,
    activation="sq_relu",
    gated_mlp=False,  # nemotron uses a plain (ungated) squared-ReLU MLP
    rope_theta=10_000.0,
    train_microbatches=4,
)

SMOKE_CONFIG = CONFIG.replace(
    name="nemotron-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=256,
    vocab_size=256,
)
