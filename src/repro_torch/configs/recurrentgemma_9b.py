"""recurrentgemma-9b — RG-LRU + local attention, 1:2 pattern [arXiv:2402.19427].

38 blocks in a repeating (RG-LRU, RG-LRU, local-attn) pattern, d_model=4096,
MQA (kv=1), d_ff=12288, 2048-token attention window, lru_width=4096.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4_096,
    n_heads=16,
    n_kv_heads=1,
    d_head=256,
    d_ff=12_288,
    vocab_size=256_000,
    activation="gelu",
    gated_mlp=True,
    block_pattern=("rglru", "rglru", "local"),
    window=2_048,
    lru_width=4_096,
    ssm_conv=4,
    tie_embeddings=True,
    logit_softcap=30.0,
    train_microbatches=4,
)

SMOKE_CONFIG = CONFIG.replace(
    name="recurrentgemma-smoke",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_head=16,
    d_ff=128,
    vocab_size=256,
    window=16,
    lru_width=64,
)
