"""Attention: blocked (flash-style) prefill path and exact decode path,
GQA / MQA; :func:`blocked_attention` also takes a local window.

The counterpart of ``repro.models.attention``.  :func:`blocked_attention`
is where the flash-attention kernel runs: on a CUDA tensor it launches
``repro_torch.kernels.flash_attention`` (the kernel's own 64-row tiles
replace ``q_chunk`` / ``kv_chunk``); on the CPU it is the plain port of the
JAX function, with its blocking and its casts.  The GQA layer is the
causal self-attention of the dense family; cross-attention, MLA and the
windowed layer of the hybrid family are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import layers
from repro_torch.models.layers import cdtype, dense_param

_NEG = -1e30


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP §1, still-to-port item 6.5: "
        "MLA, cross-attention, encdec and vlm)")


def cross_attn_project_kv(*args, **kwargs):
    _not_ported("cross-attention")


def cross_attn_decode(*args, **kwargs):
    _not_ported("cross-attention")


def mla_init(*args, **kwargs):
    _not_ported("MLA")


def mla_apply_train(*args, **kwargs):
    _not_ported("MLA")


def mla_apply_decode(*args, **kwargs):
    _not_ported("MLA")


# ---------------------------------------------------------------------------
# Core blocked attention (no projections)
# ---------------------------------------------------------------------------


def blocked_attention(q, k, v, *, causal=True, window=0, q_chunk=1024,
                      kv_chunk=1024):
    """q: (B,S,H,Dk)  k: (B,S,KV,Dk)  v: (B,S,KV,Dv) -> (B,S,H,Dv) in
    v's dtype.

    H must be a multiple of KV (GQA).  ``window>0`` restricts attention to
    the trailing ``window`` positions (sliding-window / local attention)."""
    B, S, H, Dk = q.shape
    KV = k.shape[2]
    Dv = v.shape[-1]
    G = H // KV
    qc = min(q_chunk, S)
    kc = min(kv_chunk, S)
    assert S % qc == 0 and S % kc == 0, (S, qc, kc)
    if q.device.type == "cuda":
        out = flash_ops.flash_attention(q.contiguous(), k.contiguous(),
                                        v.contiguous(), causal=causal,
                                        window=window)
        return out.to(v.dtype)
    nq, nk = S // qc, S // kc
    scale = Dk ** -0.5
    f32 = torch.float32
    dev = q.device

    qb = q.reshape(B, nq, qc, KV, G, Dk).transpose(0, 1)
    kb = k.reshape(B, nk, kc, KV, Dk).transpose(0, 1)
    vb = v.reshape(B, nk, kc, KV, Dv).transpose(0, 1)

    # static KV-block range per query block (exact for local attention)
    if window > 0:
        n_back = -(-window // kc) + 1  # blocks that can intersect the window
        n_steps = min(n_back, nk)
    else:
        n_steps = nk

    # every query block at once (the JAX package vmaps over them)
    qi = torch.arange(nq, device=dev)
    qpos = qi[:, None] * qc + torch.arange(qc, device=dev)  # (nq, qc)
    m = torch.full((nq, B, qc, KV, G), _NEG, dtype=f32, device=dev)
    l = torch.zeros((nq, B, qc, KV, G), dtype=f32, device=dev)
    acc = torch.zeros((nq, B, qc, KV, G, Dv), dtype=f32, device=dev)
    for step in range(n_steps):
        if window > 0:
            ki = torch.clamp_min(qi - (n_steps - 1) + step, 0)
        else:
            ki = torch.full_like(qi, step)
        kblk, vblk = kb[ki], vb[ki]  # (nq, B, kc, KV, D*)
        kpos = ki[:, None] * kc + torch.arange(kc, device=dev)  # (nq, kc)
        s = torch.einsum("nbqkgd,nbckd->nbqkgc", qb.to(f32),
                         kblk.to(f32)) * scale
        allowed = torch.ones((nq, qc, kc), dtype=torch.bool, device=dev)
        if causal:
            allowed = kpos[:, None, :] <= qpos[:, :, None]
        if window > 0:
            allowed = allowed & (qpos[:, :, None] - kpos[:, None, :] < window)
        allowed = allowed[:, None, :, None, None, :]
        s = torch.where(allowed, s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(allowed, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "nbqkgc,nbckd->nbqkgd", p.to(vblk.dtype).to(f32), vblk.to(f32))
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    out = out.transpose(0, 1).reshape(B, S, H, Dv)
    return out.to(v.dtype)


def decode_attention(q, k_cache, v_cache, pos):
    """q: (B,H,Dk)  caches: (B,Smax,KV,D*)  pos: filled length-1 index.

    Attends to cache positions [0, pos]; exact softmax (memory is O(S)).
    Plain torch on every device (the JAX package runs it outside any
    Pallas kernel)."""
    f32 = torch.float32
    B, H, Dk = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, Dk)
    s = torch.einsum("bkgd,bskd->bkgs", qg.to(f32), k_cache.to(f32)) \
        * (Dk ** -0.5)
    idx = torch.arange(k_cache.shape[1], device=q.device)
    s = torch.where(idx <= pos, s, _NEG)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(f32), v_cache.to(f32))
    return o.reshape(B, H, -1).to(v_cache.dtype)


# ---------------------------------------------------------------------------
# Standard GQA attention layer (projections + rope + cache plumbing)
# ---------------------------------------------------------------------------


def attn_init(gen, cfg, device):
    D, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    return {
        "wq": dense_param(gen, (D, H * Dh), D, device),
        "wk": dense_param(gen, (D, KV * Dh), D, device),
        "wv": dense_param(gen, (D, KV * Dh), D, device),
        "wo": dense_param(gen, (H * Dh, D), H * Dh, device),
    }


def _project_qkv(p, x, cfg):
    dt = cdtype(cfg)
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    q = q.reshape(*q.shape[:-1], H, Dh)
    k = k.reshape(*k.shape[:-1], KV, Dh)
    v = v.reshape(*v.shape[:-1], KV, Dh)
    return q, k, v


def attn_apply_train(p, x, positions, cfg):
    """Full-sequence causal self-attention (prefill)."""
    q, k, v = _project_qkv(p, x, cfg)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    o = blocked_attention(q, k, v, q_chunk=cfg.attn_chunk,
                          kv_chunk=cfg.attn_chunk)
    o = o.reshape(*o.shape[:-2], cfg.n_heads * cfg.d_head)
    return o @ p["wo"].to(cdtype(cfg))


def attn_apply_decode(p, x, pos: int, cache_k, cache_v, cfg):
    """One-token decode. x: (B, D).  Returns (out, cache_k, cache_v).

    Writes the new K/V into ``cache_k`` / ``cache_v`` in place (the JAX
    package returns updated copies; the serving engine donates them).  As
    in ``jax.lax.dynamic_update_index_in_dim``, a slot past the cache's
    end is clamped onto its last position."""
    dt = cdtype(cfg)
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (x @ p["wq"].to(dt)).reshape(-1, H, Dh)
    k = (x @ p["wk"].to(dt)).reshape(-1, KV, Dh)
    v = (x @ p["wv"].to(dt)).reshape(-1, KV, Dh)
    posv = torch.tensor([pos], device=x.device)
    q = layers.apply_rope(q, posv, cfg.rope_theta)
    k = layers.apply_rope(k, posv, cfg.rope_theta)
    slot = min(max(pos, 0), cache_k.shape[1] - 1)
    cache_k[:, slot] = k.to(cache_k.dtype)
    cache_v[:, slot] = v.to(cache_v.dtype)
    o = decode_attention(q, cache_k, cache_v, pos)
    o = o.reshape(-1, H * Dh)
    return o @ p["wo"].to(dt), cache_k, cache_v
