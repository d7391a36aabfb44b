"""seamless-m4t-large-v2 — encoder-decoder, multimodal [arXiv:2308.11596].

24L encoder + 24L decoder transformer backbone, d_model=1024, 16 heads,
d_ff=8192, vocab=256206.  The audio frontend (conformer feature extractor)
is a STUB per the assignment: ``input_specs()`` provides precomputed frame
embeddings of shape (batch, frames, d_model).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=48,          # 24 enc + 24 dec
    n_enc_layers=24,
    n_dec_layers=24,
    d_model=1_024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=8_192,
    vocab_size=256_206,
    activation="gelu",
    gated_mlp=False,
    frontend="audio_frames",
    train_microbatches=2,
    rope_theta=10_000.0,
)

SMOKE_CONFIG = CONFIG.replace(
    name="seamless-smoke",
    n_layers=4,
    n_enc_layers=2,
    n_dec_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab_size=256,
)
