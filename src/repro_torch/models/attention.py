"""Attention: blocked (flash-style) prefill path and exact decode path,
GQA / MQA / local-window / cross / MLA variants.

The counterpart of ``repro.models.attention``.  :func:`blocked_attention`
is where the flash-attention kernel runs: on a CUDA tensor it launches
``repro_torch.kernels.flash_attention`` (the kernel's own 64-row tiles
replace ``q_chunk`` / ``kv_chunk``; in training its autograd Function,
whose backward is the hand-written backward kernel; on a meta tensor, the
dry-run's, the custom op that stands for the kernel); on the CPU it is the
plain port of the JAX function, with its blocking and its casts, which
autograd differentiates as ``jax.value_and_grad`` does the JAX one.  Every prefill variant
(causal, windowed, bidirectional, cross-attention at equal lengths, MLA
with Dk != Dv) goes through it; the decode paths (:func:`decode_attention`,
:func:`cross_attn_decode`, MLA's absorbed-matrix :func:`mla_apply_decode`)
are plain torch on every device, as the JAX package computes them outside
any Pallas kernel.

On the ranks of a mesh (``models.transformer``'s sharded decode) a cache
may be split along its sequence over a group of ranks (``cache_sharding``'s
``sp``): each decode path then takes ``shard``, a :class:`SeqShard`, and
each rank computes its block's partial softmax, merged across the group
by all-reduces: the partial maximum, then the partial sum of the
exponentials, then the partial P·V (:func:`decode_attention_sharded`);
only the rank whose block holds the written slot writes the new K/V.

Tensor parallelism (``models.layers``): the projections are
column-parallel over heads (q's heads over ``model``; k's and v's where
the axis divides the KV heads, else every rank computes all of them and
takes the ones its q heads read), the attention runs on the rank's heads
(the flash kernel at H / model heads), and ``wo`` is row-parallel.  A
sharded decode step gathers the step's q, k and v heads over ``model``
(B_loc x H x Dh), attends over the rank's block of the cache's sequence,
and keeps the rank's heads for ``wo``.  MLA: ``wq_a`` column-parallel and
gathered (its norm spans the rank), ``wq_b``, ``wk_b`` and ``wv_b`` over
heads, ``wkv_a`` whole.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import layers
from repro_torch.models.layers import cdtype, dense_param
from repro_torch.parallel import api as par
from repro_torch.parallel import collectives as coll

_NEG = -1e30


class SeqShard(NamedTuple):
    """This rank's block of a cache split along its sequence: its first
    position ``off``, the whole sequence's length ``length``, and the
    group of ranks that hold the blocks (None: this rank alone)."""

    off: int
    length: int
    group: object


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
    if q.device.type in ("cuda", "meta"):
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


def _merged_softmax(s, shard: SeqShard, pos):
    """The softmax over the whole sequence of the scores ``s`` (..., S_blk)
    of this rank's block (positions past ``pos`` masked), in float32: the
    maximum and the sum of the exponentials all-reduced over the group."""
    idx = shard.off + torch.arange(s.shape[-1], device=s.device)
    s = torch.where(idx <= pos, s, _NEG)
    m = coll.max_over(s.amax(dim=-1), shard.group)
    e = torch.exp(s - m[..., None])
    return e / coll.sum_over(e.sum(dim=-1), shard.group)[..., None]


def decode_attention_sharded(q, k_blk, v_blk, pos, shard: SeqShard):
    """:func:`decode_attention` over a cache split along its sequence:
    ``k_blk`` / ``v_blk`` (B, S_blk, KV, D*) are this rank's positions
    ``shard.off ..``; P·V of the block summed over the group."""
    f32 = torch.float32
    B, H, Dk = q.shape
    KV = k_blk.shape[2]
    qg = q.reshape(B, KV, H // KV, Dk)
    s = torch.einsum("bkgd,bskd->bkgs", qg.to(f32), k_blk.to(f32)) \
        * (Dk ** -0.5)
    p = _merged_softmax(s, shard, pos).to(v_blk.dtype)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(f32), v_blk.to(f32))
    o = coll.sum_over(o, shard.group)
    return o.reshape(B, H, -1).to(v_blk.dtype)


def _write_slot(cache, slot: int, value, shard):
    """``cache[:, slot] = value`` of the whole cache's ``slot``: on this
    rank's block only where it holds that slot (``shard``)."""
    if shard is not None:
        slot -= shard.off
        if not 0 <= slot < cache.shape[1]:
            return
    cache[:, slot] = value.to(cache.dtype)


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


def _project_qkv(p, x, kv_x, cfg):
    """(q, its first head, k, v): x and kv_x whole along their sequence;
    q the rank's heads, k and v the rank's KV heads or all of them
    (:func:`layers.heads`)."""
    dt = cdtype(cfg)
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q, q0 = layers.heads(x @ p["wq"].to(dt), H, Dh)
    k, _ = layers.heads(kv_x @ p["wk"].to(dt), KV, Dh)
    v, _ = layers.heads(kv_x @ p["wv"].to(dt), KV, Dh)
    return q, q0, k, v


def kv_of(q, q0, k, v, cfg):
    """The KV heads the q heads ``q0 ..`` read (GQA): ``k`` and ``v``
    as they are where they hold exactly those, else the slice of all
    ``n_kv_heads`` of them."""
    H, KV = cfg.n_heads, cfg.n_kv_heads
    if k.shape[-2] != KV or q.shape[-2] == H:
        return k, v
    G = H // KV
    lo, hi = q0 // G, (q0 + q.shape[-2] - 1) // G + 1
    return k[..., lo:hi, :], v[..., lo:hi, :]


def attn_apply_train(p, x, positions, cfg, *, causal=True, window=0,
                     kv_x=None, use_rope=True, collect_kv=False):
    """Full-sequence attention (prefill), x the residual stream (normed);
    ``positions`` (B, S) of the whole sequence.  kv_x != None =>
    cross-attention (kv_x whole along its sequence; its length must equal
    x's: see :func:`blocked_attention`).  ``collect_kv``: also returns the
    rope'd (k, v) (the rank's KV heads or all of them)."""
    x = layers.seq_gather(x)
    kv_inp = x if kv_x is None else kv_x
    q, q0, k, v = _project_qkv(p, x, kv_inp, cfg)
    if use_rope and kv_x is None:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    ka, va = kv_of(q, q0, k, v, cfg)
    o = blocked_attention(q, ka, va, causal=causal, window=window,
                          q_chunk=cfg.attn_chunk, kv_chunk=cfg.attn_chunk)
    o = o.flatten(-2)
    out = layers.row_linear(o, p["wo"], cdtype(cfg),
                            cfg.n_heads * cfg.d_head)
    return (out, (k, v)) if collect_kv else out


def whole_heads(t, n: int):
    """``t`` (..., n_loc, D) of all ``n`` heads (the rank's heads
    all-gathered over ``model``; ``t`` where it holds them all)."""
    if t.shape[-2] == n:
        return t
    return coll.all_gather(t, -2, par.model_axis().group)


def _cache_slot(pos: int, cache, shard=None):
    """``jax.lax.dynamic_update_index_in_dim``'s index: a slot past the
    cache's end (the whole cache's, ``shard.length``, when split) is
    clamped onto its last position."""
    n = cache.shape[1] if shard is None else shard.length
    return min(max(pos, 0), n - 1)


def attn_apply_decode(p, x, pos: int, cache_k, cache_v, cfg, *, window=0,
                      shard=None):
    """One-token decode. x: (B, D).  Returns (out, cache_k, cache_v).

    Writes the new K/V into ``cache_k`` / ``cache_v`` in place (the JAX
    package returns updated copies; the serving engine donates them), at
    ``pos`` or, with ``window > 0``, at ``pos % window`` of a ring of the
    last ``window`` positions.  ``shard``: the caches are this rank's
    blocks of a cache split along its sequence (:class:`SeqShard`)."""
    dt = cdtype(cfg)
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q, _, k, v = _project_qkv(p, x, x, cfg)
    q, k, v = whole_heads(q, H), whole_heads(k, KV), whole_heads(v, KV)
    posv = torch.tensor([pos], device=x.device)
    q = layers.apply_rope(q, posv, cfg.rope_theta)
    k = layers.apply_rope(k, posv, cfg.rope_theta)
    if window > 0:
        slot, eff_pos = pos % window, min(pos, window - 1)
    else:
        slot, eff_pos = pos, pos
    slot = _cache_slot(slot, cache_k, shard)
    if shard is None:
        cache_k[:, slot] = k.to(cache_k.dtype)
        cache_v[:, slot] = v.to(cache_v.dtype)
        o = decode_attention(q, cache_k, cache_v, eff_pos)
    else:
        _write_slot(cache_k, slot, k, shard)
        _write_slot(cache_v, slot, v, shard)
        o = decode_attention_sharded(q, cache_k, cache_v, eff_pos, shard)
    o = o.reshape(-1, H * Dh)
    return layers.row_linear(o, p["wo"], dt, H * Dh), cache_k, cache_v


def cross_attn_project_kv(p, enc_mem, cfg):
    """Precompute cross-attention K/V from encoder memory (for decode):
    the rank's KV heads or all of them (:func:`layers.heads`)."""
    dt = cdtype(cfg)
    KV, Dh = cfg.n_kv_heads, cfg.d_head
    k, _ = layers.heads(enc_mem @ p["wk"].to(dt), KV, Dh)
    v, _ = layers.heads(enc_mem @ p["wv"].to(dt), KV, Dh)
    return k, v


def cross_attn_decode(p, x, k_mem, v_mem, cfg, shard=None):
    """One decoder token against the whole encoder memory (B,Ssrc,KV,Dh);
    an empty memory (Ssrc 0) contributes zeros, as in the JAX package.
    ``shard``: the memory is this rank's block of it."""
    dt = cdtype(cfg)
    H, Dh = cfg.n_heads, cfg.d_head
    q = whole_heads(layers.heads(x @ p["wq"].to(dt), H, Dh)[0], H)
    if shard is None:
        o = decode_attention(q, k_mem, v_mem, k_mem.shape[1] - 1)
    else:
        o = decode_attention_sharded(q, k_mem, v_mem, shard.length - 1,
                                     shard)
    return layers.row_linear(o.reshape(-1, H * Dh), p["wo"], dt, H * Dh)


# ---------------------------------------------------------------------------
# Multi-head Latent Attention (deepseek-v3)
# ---------------------------------------------------------------------------


def mla_init(gen, cfg, device):
    D = cfg.d_model
    H = cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "wq_a": dense_param(gen, (D, qr), D, device),
        "q_norm": layers.norm_init(qr, device),
        "wq_b": dense_param(gen, (qr, H * (dn + dr)), qr, device),
        "wkv_a": dense_param(gen, (D, kvr + dr), D, device),
        "kv_norm": layers.norm_init(kvr, device),
        "wk_b": dense_param(gen, (kvr, H * dn), kvr, device),
        "wv_b": dense_param(gen, (kvr, H * dv), kvr, device),
        "wo": dense_param(gen, (H * dv, D), H * dv, device),
    }


def _mla_q(p, x, positions, cfg):
    """(q_nope, q_rope, the first head): the rank's heads."""
    dt = cdtype(cfg)
    H = cfg.n_heads
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    ql = layers.columns(x @ p["wq_a"].to(dt), cfg.q_lora_rank)
    ql = layers.rms_norm(ql, p["q_norm"]["scale"], cfg.norm_eps)
    q, q0 = layers.heads(ql @ p["wq_b"].to(dt), H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = layers.apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope, q0


def _mla_latent(p, x, positions, cfg):
    dt = cdtype(cfg)
    kvr = cfg.kv_lora_rank
    kv = x @ p["wkv_a"].to(dt)
    ckv, k_rope = kv[..., :kvr], kv[..., kvr:]
    ckv = layers.rms_norm(ckv, p["kv_norm"]["scale"], cfg.norm_eps)
    k_rope = layers.apply_rope(k_rope[..., None, :], positions,
                               cfg.rope_theta)[..., 0, :]
    return ckv, k_rope


def mla_apply_train(p, x, positions, cfg):
    """Materialised-KV MLA for prefill: returns (out, (ckv, k_rope)).

    The flash kernel takes Dk = qk_nope + qk_rope and Dv = v_head, with
    K's rope part broadcast over the heads (made contiguous by
    :func:`blocked_attention` before the kernel)."""
    dt = cdtype(cfg)
    H = cfg.n_heads
    dn, dv = cfg.qk_nope_dim, cfg.v_head_dim
    x = layers.seq_gather(x)
    q_nope, q_rope, _ = _mla_q(p, x, positions, cfg)
    ckv, k_rope = _mla_latent(p, x, positions, cfg)
    k_nope, _ = layers.heads(ckv @ p["wk_b"].to(dt), H, dn)
    v, _ = layers.heads(ckv @ p["wv_b"].to(dt), H, dv)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[..., None, :].expand(q_rope.shape)],
                  dim=-1)
    o = blocked_attention(q, k, v, causal=True,
                          q_chunk=cfg.attn_chunk, kv_chunk=cfg.attn_chunk)
    o = o.flatten(-2)
    return layers.row_linear(o, p["wo"], dt, H * dv), (ckv, k_rope)


def mla_apply_decode(p, x, pos: int, cache_ckv, cache_krope, cfg,
                     shard=None):
    """Absorbed-matrix MLA decode: scores/output computed in the latent
    space so the cache stays (kv_lora + rope) wide — the memory win MLA
    exists for.  Writes the step into the caches in place, as
    :func:`attn_apply_decode` does; returns (out, cache_ckv, cache_krope).
    ``shard``: the caches are this rank's blocks (:class:`SeqShard`), the
    latent output summed over the group."""
    dt = cdtype(cfg)
    f32 = torch.float32
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    posv = torch.tensor([pos], device=x.device)
    # the rank's heads: (B,Hl,dn), (B,Hl,dr)
    q_nope, q_rope, q0 = _mla_q(p, x, posv, cfg)
    n_loc = q_nope.shape[1]
    ckv, k_rope = _mla_latent(p, x, posv, cfg)  # (B,kvr), (B,dr)
    slot = _cache_slot(pos, cache_ckv, shard)
    _write_slot(cache_ckv, slot, ckv, shard)
    _write_slot(cache_krope, slot, k_rope, shard)
    # the rank's heads' columns (a block split across heads: whole)
    wk_b = layers.heads(p["wk_b"].to(dt), H, dn)[0]
    wv_b = layers.heads(p["wv_b"].to(dt), H, dv)[0]
    q_eff = torch.einsum("bhn,rhn->bhr", q_nope, wk_b)  # absorb W^UK
    # every head's scores over the rank's block of the cache
    q_eff, q_rope = whole_heads(q_eff, H), whole_heads(q_rope, H)
    s = torch.einsum("bhr,bsr->bhs", q_eff.to(f32), cache_ckv.to(f32))
    s = s + torch.einsum("bhr,bsr->bhs", q_rope.to(f32),
                         cache_krope.to(f32))
    s = s * (dn + dr) ** -0.5
    if shard is None:
        idx = torch.arange(cache_ckv.shape[1], device=x.device)
        s = torch.where(idx <= pos, s, _NEG)
        a = torch.softmax(s, dim=-1).to(dt)
        o_lat = torch.einsum("bhs,bsr->bhr", a, cache_ckv)
    else:
        a = _merged_softmax(s, shard, pos).to(dt)
        o_lat = coll.sum_over(torch.einsum("bhs,bsr->bhr", a, cache_ckv),
                              shard.group)
    o_lat = o_lat[:, q0:q0 + n_loc]
    o = torch.einsum("bhr,rhv->bhv", o_lat, wv_b)  # absorb W^UV
    out = layers.row_linear(o.flatten(1), p["wo"], dt, H * dv)
    return out, cache_ckv, cache_krope
