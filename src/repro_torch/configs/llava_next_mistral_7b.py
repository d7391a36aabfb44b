"""llava-next-mistral-7b — anyres tiling VLM [hf:llava-hf/llava-v1.6-mistral-7b-hf].

Mistral-7B backbone (32L d_model=4096, GQA kv=8, d_ff=14336, vocab=32000).
The vision frontend (CLIP tower + anyres tiling + projector) is a STUB per
the assignment: ``input_specs()`` provides precomputed patch embeddings of
shape (batch, n_patches, d_model) which are scattered into the token
sequence at the image-token positions.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4_096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14_336,
    vocab_size=32_000,
    activation="silu",
    gated_mlp=True,
    rope_theta=1_000_000.0,
    frontend="vision_patches",
    n_frontend_tokens=2_880,  # anyres: (4 tiles + 1 base) x 576 patches
    train_microbatches=4,
)

SMOKE_CONFIG = CONFIG.replace(
    name="llava-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab_size=256,
    n_frontend_tokens=8,
)
