"""yi-34b — llama-architecture GQA [arXiv:2403.04652; hf:01-ai/Yi-34B]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7_168,
    n_heads=56,
    n_kv_heads=8,
    d_head=128,
    d_ff=20_480,
    vocab_size=64_000,
    activation="silu",
    gated_mlp=True,
    rope_theta=5_000_000.0,
    train_microbatches=8,
)

SMOKE_CONFIG = CONFIG.replace(
    name="yi-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=160,
    vocab_size=256,
    train_microbatches=1,
)
