"""deepseek-v3-671b — MLA, 1 shared + 256 routed experts top-8 [arXiv:2412.19437].

61 layers: 3 leading dense-FFN layers (d_ff=18432), 58 MoE layers with
256 routed experts (d_ff=2048, top-8) + 1 shared expert.  Multi-head latent
attention: q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64, v_head=128,
128 heads.  Optimizer defaults to Adafactor — Adam state for 671B params
(~8 TB) exceeds a single v5e pod's HBM; see DESIGN.md §7.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7_168,
    n_heads=128,
    n_kv_heads=128,     # assignment sheet value; MLA shares one latent KV
    d_head=128,
    d_ff=18_432,        # dense-FFN layers
    moe_d_ff=2_048,     # routed/shared expert intermediate
    vocab_size=129_280,
    activation="silu",
    gated_mlp=True,
    n_experts=256,
    experts_per_token=8,
    n_shared_experts=1,
    n_dense_layers=3,
    use_mla=True,
    q_lora_rank=1_536,
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    rope_theta=10_000.0,
    optimizer="adafactor",
    capacity_factor=1.25,
    train_microbatches=8,
)

SMOKE_CONFIG = CONFIG.replace(
    name="deepseek-v3-smoke",
    n_layers=3,          # 1 dense + 2 MoE
    n_dense_layers=1,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    moe_d_ff=48,
    vocab_size=256,
    n_experts=8,
    experts_per_token=2,
    q_lora_rank=32,
    kv_lora_rank=32,
    qk_rope_dim=8,
    qk_nope_dim=16,
    v_head_dim=16,
    train_microbatches=1,
)
