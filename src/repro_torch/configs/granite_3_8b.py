"""granite-3-8b — GQA [hf:ibm-granite/granite-3.0-8b-base]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4_096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=12_800,
    vocab_size=49_155,
    activation="silu",
    gated_mlp=True,
    tie_embeddings=True,  # granite-3 ties input/output embeddings
    rope_theta=10_000.0,
    train_microbatches=4,
)

SMOKE_CONFIG = CONFIG.replace(
    name="granite-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab_size=255,  # deliberately non-divisible vocab (exercises shard gating)
)
