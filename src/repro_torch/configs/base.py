"""Architecture + shape configuration system.

Every assigned architecture is a frozen :class:`ArchConfig`; the four
assigned input shapes are :class:`ShapeSpec` entries in ``SHAPES``.  The
(arch x shape) grid drives the per-arch smoke tests, the multi-pod dry-run
and the roofline table.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Shapes (assigned input-shape set; same four for every LM-family arch)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input shape.

    ``kind`` selects which step function the cell lowers:
      * ``train``   -> ``train_step``  (forward+backward+optimizer)
      * ``prefill`` -> ``serve_prefill`` (builds the KV cache / state)
      * ``decode``  -> ``serve_step``  (one new token, cache of ``seq_len``)
    """

    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


# ---------------------------------------------------------------------------
# Architecture configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int

    activation: str = "silu"  # silu | gelu | sq_relu
    gated_mlp: bool = True
    norm_eps: float = 1e-5
    rope_theta: float = 500_000.0
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    n_dense_layers: int = 0  # leading dense-FFN layers (deepseek-v3: 3)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001

    # --- MLA (deepseek-v3) ---------------------------------------------------
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # --- SSM (mamba2 / SSD) --------------------------------------------------
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv: int = 4
    ssm_ngroups: int = 1

    # --- hybrid (recurrentgemma) ----------------------------------------------
    block_pattern: Tuple[str, ...] = ()  # repeating, e.g. ("rglru","rglru","local")
    window: int = 0  # local-attention window
    lru_width: int = 0

    # --- encoder-decoder -------------------------------------------------------
    n_enc_layers: int = 0
    n_dec_layers: int = 0

    # --- modality frontend stubs -----------------------------------------------
    frontend: str = "none"  # none | audio_frames | vision_patches
    n_frontend_tokens: int = 0

    # --- training/runtime knobs -------------------------------------------------
    optimizer: str = "adamw"  # adamw | adafactor
    remat: str = "block"  # none | block
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    attn_chunk: int = 1024  # KV-block size for chunked (flash-style) attention
    train_microbatches: int = 1  # gradient-accumulation factor for train_4k

    # -------------------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def sub_quadratic(self) -> bool:
        """True when the architecture supports O(1)/O(window) decode state
        (required for the ``long_500k`` cell)."""
        return self.family in ("ssm", "hybrid")

    def supports_shape(self, shape: ShapeSpec) -> bool:
        if shape.name == "long_500k":
            return self.sub_quadratic
        return True

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # --- parameter counting (for MODEL_FLOPS = 6*N*D roofline term) ---------
    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count. ``active_only`` counts the per-token
        active parameters for MoE (routed top-k + shared)."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        H, KV, Dh = self.n_heads, self.n_kv_heads, self.d_head

        def attn_params() -> int:
            if self.use_mla:
                q = D * self.q_lora_rank + self.q_lora_rank * H * (
                    self.qk_nope_dim + self.qk_rope_dim
                )
                kv = D * (self.kv_lora_rank + self.qk_rope_dim)
                kv += self.kv_lora_rank * H * (self.qk_nope_dim + self.v_head_dim)
                o = H * self.v_head_dim * D
                return q + kv + o
            return D * (H + 2 * KV) * Dh + H * Dh * D

        def mlp_params(f: int) -> int:
            mult = 3 if self.gated_mlp else 2
            return mult * D * f

        def moe_layer_params(active: bool) -> int:
            n_e = self.experts_per_token if active else self.n_experts
            p = n_e * mlp_params(self.moe_d_ff)
            p += self.n_shared_experts * mlp_params(self.moe_d_ff)
            p += D * self.n_experts  # router
            return p

        total = V * D  # embeddings
        if not self.tie_embeddings:
            total += D * V  # lm head

        if self.family == "ssm":
            d_in = self.d_inner
            per_layer = (
                D * (2 * d_in + 2 * self.ssm_ngroups * self.ssm_state + self.n_ssm_heads)
                + (d_in + 2 * self.ssm_ngroups * self.ssm_state) * self.ssm_conv
                + self.n_ssm_heads * 2  # A_log, D skip
                + d_in * D  # out proj
                + 2 * D  # norms
            )
            return total + self.n_layers * per_layer

        if self.family == "hybrid":
            n_blocks = self.n_layers
            pattern = self.block_pattern
            per_attn = attn_params() + mlp_params(F) + 3 * D
            W = self.lru_width or D
            per_lru = (
                D * 2 * W  # x/gate input projections
                + W * self.ssm_conv  # temporal conv
                + 2 * W * W  # input gate + recurrence gate
                + W  # Lambda
                + W * D  # out proj
                + mlp_params(F)
                + 3 * D
            )
            n_attn = sum(1 for i in range(n_blocks) if pattern[i % len(pattern)] == "local")
            return total + n_attn * per_attn + (n_blocks - n_attn) * per_lru

        if self.family == "encdec":
            enc = self.n_enc_layers * (attn_params() + mlp_params(F) + 4 * D)
            dec = self.n_dec_layers * (2 * attn_params() + mlp_params(F) + 6 * D)
            return total + enc + dec

        # dense / moe / vlm decoder stack
        per_dense_layer = attn_params() + mlp_params(F) + 4 * D
        if self.family == "moe":
            n_moe = self.n_layers - self.n_dense_layers
            dense = self.n_dense_layers * per_dense_layer
            moe = n_moe * (attn_params() + moe_layer_params(active_only) + 4 * D)
            return total + dense + moe
        return total + self.n_layers * per_dense_layer


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_IDS = (
    "mamba2-130m",
    "llama3-8b",
    "nemotron-4-15b",
    "yi-34b",
    "granite-3-8b",
    "qwen3-moe-30b-a3b",
    "deepseek-v3-671b",
    "recurrentgemma-9b",
    "seamless-m4t-large-v2",
    "llava-next-mistral-7b",
)

_MODULE_FOR = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULE_FOR:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULE_FOR)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR[arch_id]}")
    return mod.CONFIG


def get_smoke_config(arch_id: str) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests."""
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR[arch_id]}")
    return mod.SMOKE_CONFIG


def grid():
    """Yield every assigned (arch, shape) cell with its skip status."""
    for arch_id in ARCH_IDS:
        cfg = get_config(arch_id)
        for shape in SHAPES.values():
            yield arch_id, shape.name, cfg.supports_shape(shape)
