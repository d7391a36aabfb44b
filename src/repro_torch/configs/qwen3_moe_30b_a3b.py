"""qwen3-moe-30b-a3b — 128 experts, top-8 [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2_048,
    n_heads=32,
    n_kv_heads=4,
    d_head=128,
    d_ff=768,          # per-expert intermediate size (MoE-only stack)
    moe_d_ff=768,
    vocab_size=151_936,
    activation="silu",
    gated_mlp=True,
    n_experts=128,
    experts_per_token=8,
    n_shared_experts=0,
    n_dense_layers=0,
    rope_theta=1_000_000.0,
    capacity_factor=1.25,
    train_microbatches=4,
)

SMOKE_CONFIG = CONFIG.replace(
    name="qwen3-moe-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=96,
    moe_d_ff=96,
    vocab_size=256,
    n_experts=8,
    experts_per_token=2,
    train_microbatches=1,
)
