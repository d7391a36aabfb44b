"""Model assembly: the dense (GQA decoder) and ssm (Mamba-2) families.

The counterpart of ``repro.models.transformer`` for serving: parameters
(``init_params``), ``forward_hidden`` (inference only, no remat),
``init_cache``, ``prefill`` and ``decode_step``, as methods of the
:class:`Transformer` module.  Parameters are float32 in the JAX package's
layout, one :class:`~repro_torch.models.layers.ParamTree` per block in an
``nn.ModuleList`` (the JAX package stacks them along a leading layer axis
and scans; here the layer scan is a Python loop).  Two pieces of the JAX
module are not carried over, because they do nothing on one card:
``scan_util`` (its unrolled mode only serves XLA's cost analysis) and
``_x_constraint`` (sharding annotations for a device mesh).

Caches hold the JAX package's leaves, stacked over layers, with ``pos`` a
Python int.  ``decode_step`` writes the new K/V (dense) into the cache's
tensors in place and returns a new dict; the serving engine, like the JAX
one that donates its cache, never reuses the old one.

The moe, hybrid, encdec and vlm families raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from repro_torch.core.carry import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import layers, ssm
from repro_torch.models.layers import ParamTree, cdtype

Cache = Dict[str, Any]

PORTED_FAMILIES = ("dense", "ssm")


def _check_family(cfg):
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet (ROADMAP "
            "§1, still-to-port item 6.5: moe, hybrid, encdec, vlm)")


# ===========================================================================
# Init
# ===========================================================================


def _dense_block_init(gen, cfg, device):
    return {
        "ln1": layers.norm_init(cfg.d_model, device),
        "attn": attn.attn_init(gen, cfg, device),
        "ln2": layers.norm_init(cfg.d_model, device),
        "mlp": layers.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp,
                               device),
    }


def _ssm_block_init(gen, cfg, device):
    return {"ln": layers.norm_init(cfg.d_model, device),
            "ssm": ssm.ssm_init(gen, cfg, device)}


# ===========================================================================
# Block bodies
# ===========================================================================


def _dense_block_apply(p, x, positions, cfg, collect_kv=False):
    h = layers.rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
    kv = None
    if collect_kv:
        h, kv = _attn_with_kv(p["attn"], h, positions, cfg)
    else:
        h = attn.attn_apply_train(p["attn"], h, positions, cfg)
    x = x + h
    h = layers.rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
    x = x + layers.mlp_apply(p["mlp"], h, cfg)
    return (x, kv) if collect_kv else x


def _attn_with_kv(p, h, positions, cfg):
    """Like attn_apply_train but also returns the rope'd K/V (prefill)."""
    q, k, v = attn._project_qkv(p, h, cfg)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    o = attn.blocked_attention(q, k, v, q_chunk=cfg.attn_chunk,
                               kv_chunk=cfg.attn_chunk)
    o = o.reshape(*o.shape[:-2], cfg.n_heads * cfg.d_head)
    out = o @ p["wo"].to(cdtype(cfg))
    return out, (k, v)


def _ssm_block_apply(p, x, cfg, collect_state=False):
    h = layers.rms_norm(x, p["ln"]["scale"], cfg.norm_eps)
    if collect_state:
        y, st = ssm.ssm_apply_train(p["ssm"], h, cfg, return_state=True)
        return x + y, st
    return x + ssm.ssm_apply_train(p["ssm"], h, cfg)


# ===========================================================================
# The model
# ===========================================================================


def init_cache(cfg, batch: int, capacity: int, device=None) -> Cache:
    """Zeroed serving cache of ``batch`` sequences of ``capacity``
    positions (dense: K/V; ssm: state and conv tail)."""
    _check_family(cfg)
    device = resolve_device(device)
    dt = cdtype(cfg)
    L = cfg.n_layers
    if cfg.family == "dense":
        KV, Dh = cfg.n_kv_heads, cfg.d_head
        shape = (L, batch, capacity, KV, Dh)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device), "pos": 0}
    H, N, Pd = cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_headdim
    conv_dim = cfg.d_inner + 2 * cfg.ssm_ngroups * N
    return {"state": torch.zeros((L, batch, H, N, Pd), dtype=torch.float32,
                                 device=device),
            "conv": torch.zeros((L, batch, cfg.ssm_conv - 1, conv_dim),
                                dtype=dt, device=device),
            "pos": 0}


class Transformer(nn.Module):
    """A dense or ssm LM with random weights drawn from ``generator``.

    ``device=None`` means the CUDA card (raises without one); pass
    ``device="cpu"`` for the CPU.  ``generator`` (a ``torch.Generator`` on
    that device) defaults to one seeded with 0."""

    def __init__(self, cfg, device=None, generator=None):
        super().__init__()
        _check_family(cfg)
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.cfg = cfg
        gen = generator
        self.embed = ParamTree({"tok": layers.embed_param(
            gen, cfg.vocab_size, cfg.d_model, device)})
        self.final_norm = ParamTree(layers.norm_init(cfg.d_model, device))
        if not cfg.tie_embeddings:
            self.lm_head = ParamTree({"w": layers.dense_param(
                gen, (cfg.d_model, cfg.vocab_size), cfg.d_model, device)})
        block_init = (_dense_block_init if cfg.family == "dense"
                      else _ssm_block_init)
        self.blocks = nn.ModuleList(
            ParamTree(block_init(gen, cfg, device))
            for _ in range(cfg.n_layers))

    # the JAX package's top-level keys, for layers.logits_apply
    def __getitem__(self, key):
        return getattr(self, key)

    @property
    def device(self) -> torch.device:
        return self.embed["tok"].device

    def init_cache(self, batch: int, capacity: int) -> Cache:
        return init_cache(self.cfg, batch, capacity, self.device)

    def logits(self, x):
        return layers.logits_apply(self, x, self.cfg)

    @torch.no_grad()
    def forward_hidden(self, tokens):
        """tokens (B,S) -> (hidden (B,S,D), aux loss 0.0)."""
        cfg = self.cfg
        x = layers.embed_apply(self.embed["tok"], tokens, cfg)
        B, S = x.shape[0], x.shape[1]
        positions = torch.arange(S, device=x.device).expand(B, S)
        for p in self.blocks:
            if cfg.family == "dense":
                x = _dense_block_apply(p, x, positions, cfg)
            else:
                x = _ssm_block_apply(p, x, cfg)
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

    @torch.no_grad()
    def prefill(self, batch) -> tuple:
        """Process the prompt ``batch["tokens"]`` (B,S); returns
        (last-position logits (B,V), cache of S positions)."""
        cfg = self.cfg
        dt = cdtype(cfg)
        x = layers.embed_apply(self.embed["tok"], batch["tokens"], cfg)
        B, S = x.shape[0], x.shape[1]
        positions = torch.arange(S, device=x.device).expand(B, S)
        if cfg.family == "dense":
            ks, vs = [], []
            for p in self.blocks:
                x, (k, v) = _dense_block_apply(p, x, positions, cfg,
                                               collect_kv=True)
                ks.append(k.to(dt))
                vs.append(v.to(dt))
            cache = {"k": torch.stack(ks), "v": torch.stack(vs), "pos": S}
        else:
            states, convs = [], []
            for p in self.blocks:
                x, (st, conv) = _ssm_block_apply(p, x, cfg, collect_state=True)
                states.append(st)
                convs.append(conv.to(dt))
            cache = {"state": torch.stack(states), "conv": torch.stack(convs),
                     "pos": S}
        return self.logits(x[:, -1]), cache

    @torch.no_grad()
    def decode_step(self, cache: Cache, tokens) -> tuple:
        """One token for the whole batch.  tokens: (B,) int.  Returns
        (logits (B,V), new cache at ``pos + 1``).

        Consumes ``cache``: both families write the step into its tensors
        in place (the dense K/V at ``pos``, the ssm state and conv buffer
        whole), and the new cache holds those same tensors.  A caller
        that needs the old cache afterwards (a branch, a retry) clones it
        first.  The JAX package's ``decode_step`` is functional instead."""
        cfg = self.cfg
        pos = int(cache["pos"])
        x = layers.embed_apply(self.embed["tok"], tokens, cfg)  # (B, D)
        new_cache = dict(cache)
        if cfg.family == "dense":
            for p, k, v in zip(self.blocks, cache["k"], cache["v"]):
                h = layers.rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
                h, _, _ = attn.attn_apply_decode(p["attn"], h, pos, k, v, cfg)
                x = x + h
                h = layers.rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
                x = x + layers.mlp_apply(p["mlp"], h, cfg)
        else:
            for p, st, cb in zip(self.blocks, cache["state"], cache["conv"]):
                h = layers.rms_norm(x, p["ln"]["scale"], cfg.norm_eps)
                y, new_st, new_cb = ssm.ssm_apply_decode(p["ssm"], h, st, cb,
                                                         cfg)
                x = x + y
                st.copy_(new_st)
                cb.copy_(new_cb)
        new_cache["pos"] = pos + 1
        return self.logits(x), new_cache
