"""Model assembly for every architecture family.

Families
--------
* ``dense`` / ``vlm``  — GQA decoder stack (vlm puts stub patch
  embeddings in front of the token embeddings)
* ``moe``              — GQA or MLA attention + (dense prefix, MoE rest)
* ``ssm``              — Mamba-2 (SSD) mixer stack
* ``hybrid``           — RecurrentGemma (rglru, rglru, local-attn) pattern
* ``encdec``           — bidirectional encoder + causal decoder w/ cross-attn

The counterpart of ``repro.models.transformer``: parameters
(``init_params``), ``forward_hidden`` (autograd records it; ``cfg.remat ==
"block"`` recomputes each block in the backward pass, as ``jax.checkpoint``
does), the sequence-chunked loss (``_xent_sums``, ``lm_loss_from_hidden``,
``loss_and_metrics``), ``init_cache``, ``prefill`` and ``decode_step``
(both under ``no_grad``), as methods of the :class:`Transformer` module
(the loss also as functions of it).  Parameters are float32 in the JAX
package's layout, one :class:`~repro_torch.models.layers.ParamTree` per
block in an ``nn.ModuleList`` (the JAX package stacks them along a leading
layer axis and scans; here the layer scan is a Python loop).

Sharded training (``parallel.api.shard_module``, ``train.loop``): each
parameter is kept as this rank's block of a ``DeviceMesh``.  A block's
weights are gathered over the axes their specs name but ``model`` just
before use and dropped after (inside the recomputed region under
``remat``; the top-level trees' once for a step's microbatches,
``hoisted``); a leaf whose spec names ``model`` stays this rank's
``model`` block, and the layers run tensor- and sequence-parallel on it
(``models.layers``): between blocks the residual stream is this rank's
block of the sequence, the reference's ``_x_constraint`` (``("dp", "sp",
None)``), taken after the vocab-parallel embedding and gathered whole
again after the last block (:meth:`forward_hidden` returns it whole).  The
loss runs on the rank's vocabulary block: the maximum, the sum of the
exponentials and the label's logit combined over ``model`` in float32
(:func:`_xent_sums`), and its sums and token count are summed over the
data-parallel ranks before the division, as the reference takes them over
the global batch.  Sharded serving (``prefill``, ``decode_step``) gathers
each block's weights for its layer likewise, serves each rank's batch
rows with the same layers, returns their logits gathered over the
vocabulary, and keeps the cache as each rank's blocks for
``parallel.api.cache_sharding``: the prefill's head-split K/V go to the
cache's sequence blocks by an all-to-all over ``model``; an attention
cache split along its sequence over ``model`` is attended block by block
and merged (``attention.decode_attention_sharded``), the ssm state split
over its heads is the rank's heads of the tensor-parallel mixer.
One piece of the JAX module is not carried over: ``scan_util`` (its
unrolled mode only serves XLA's cost analysis).

Caches hold the JAX package's leaves, stacked over layers, with ``pos`` a
Python int.  ``decode_step`` writes the step into the cache's tensors in
place and returns a new dict holding them; the serving engine, like the
JAX one that donates its cache, never reuses the old one.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Dict

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.carry import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import layers, moe, rglru, ssm
from repro_torch.models.layers import ParamTree, cdtype
from repro_torch.parallel import api as par
from repro_torch.parallel import collectives as coll

Cache = Dict[str, Any]


# ===========================================================================
# Init
# ===========================================================================


def _dense_block_init(gen, cfg, device, use_mla=False):
    return {
        "ln1": layers.norm_init(cfg.d_model, device),
        "attn": (attn.mla_init if use_mla else attn.attn_init)(gen, cfg,
                                                                device),
        "ln2": layers.norm_init(cfg.d_model, device),
        "mlp": layers.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp,
                               device),
    }


def _moe_block_init(gen, cfg, device):
    return {
        "ln1": layers.norm_init(cfg.d_model, device),
        "attn": (attn.mla_init if cfg.use_mla else attn.attn_init)(
            gen, cfg, device),
        "ln2": layers.norm_init(cfg.d_model, device),
        "moe": moe.moe_init(gen, cfg, device),
    }


def _ssm_block_init(gen, cfg, device):
    return {"ln": layers.norm_init(cfg.d_model, device),
            "ssm": ssm.ssm_init(gen, cfg, device)}


def _lru_block_init(gen, cfg, device):
    return {
        "ln1": layers.norm_init(cfg.d_model, device),
        "lru": rglru.lru_init(gen, cfg, device),
        "ln2": layers.norm_init(cfg.d_model, device),
        "mlp": layers.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp,
                               device),
    }


def _hybrid_group_init(gen, cfg, device):
    return {"lru0": _lru_block_init(gen, cfg, device),
            "lru1": _lru_block_init(gen, cfg, device),
            "attn": _dense_block_init(gen, cfg, device)}


def _dec_block_init(gen, cfg, device):
    return {
        "ln1": layers.norm_init(cfg.d_model, device),
        "self_attn": attn.attn_init(gen, cfg, device),
        "ln2": layers.norm_init(cfg.d_model, device),
        "cross_attn": attn.attn_init(gen, cfg, device),
        "ln3": layers.norm_init(cfg.d_model, device),
        "mlp": layers.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp,
                               device),
    }


def _hybrid_split(cfg):
    """(groups, remaining rglru blocks) of the (rglru, rglru, local)
    pattern."""
    assert cfg.block_pattern == ("rglru", "rglru", "local"), \
        "hybrid supports the rg pattern"
    ng, rem = divmod(cfg.n_layers, 3)
    assert rem <= 2
    return ng, rem


def _stacks(cfg):
    """The stacked top-level keys of ``cfg``: {key: (block init, n)}."""
    fam = cfg.family
    if fam in ("dense", "vlm"):
        return {"blocks": (_dense_block_init, cfg.n_layers)}
    if fam == "moe":
        out = {}
        if cfg.n_dense_layers:
            out["dense_blocks"] = (
                lambda g, c, d: _dense_block_init(g, c, d, c.use_mla),
                cfg.n_dense_layers)
        out["moe_blocks"] = (_moe_block_init,
                             cfg.n_layers - cfg.n_dense_layers)
        return out
    if fam == "ssm":
        return {"blocks": (_ssm_block_init, cfg.n_layers)}
    if fam == "hybrid":
        ng, rem = _hybrid_split(cfg)
        out = {"groups": (_hybrid_group_init, ng)}
        if rem:
            out["rem_lru"] = (_lru_block_init, rem)
        return out
    if fam == "encdec":
        return {"enc_blocks": (_dense_block_init, cfg.n_enc_layers),
                "dec_blocks": (_dec_block_init, cfg.n_dec_layers)}
    raise ValueError(fam)


# ===========================================================================
# Block bodies
# ===========================================================================


def _dense_block_apply(p, x, positions, cfg, *, causal=True, window=0,
                       use_mla=False, collect_kv=False):
    h = layers.rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
    kv = None
    if use_mla:
        h, kv = attn.mla_apply_train(p["attn"], h, positions, cfg)
    elif collect_kv:
        h, kv = attn.attn_apply_train(p["attn"], h, positions, cfg,
                                      causal=causal, window=window,
                                      collect_kv=True)
    else:
        h = attn.attn_apply_train(p["attn"], h, positions, cfg,
                                  causal=causal, window=window)
    x = x + h
    h = layers.rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
    x = x + layers.mlp_apply(p["mlp"], h, cfg)
    return (x, kv) if (collect_kv or use_mla) else x


def _moe_block_apply(p, x, positions, cfg, collect_kv=False):
    h = layers.rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
    kv = None
    if cfg.use_mla:
        h, kv = attn.mla_apply_train(p["attn"], h, positions, cfg)
    elif collect_kv:
        h, kv = attn.attn_apply_train(p["attn"], h, positions, cfg,
                                      collect_kv=True)
    else:
        h = attn.attn_apply_train(p["attn"], h, positions, cfg)
    x = x + h
    h = layers.rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
    y, aux = moe.moe_apply(p["moe"], h, cfg)
    return x + y, aux, kv


def _ssm_block_apply(p, x, cfg, collect_state=False):
    h = layers.rms_norm(x, p["ln"]["scale"], cfg.norm_eps)
    if collect_state:
        y, st = ssm.ssm_apply_train(p["ssm"], h, cfg, return_state=True)
        return x + y, st
    return x + ssm.ssm_apply_train(p["ssm"], h, cfg)


def _lru_block_apply(p, x, cfg, collect_state=False):
    h = layers.rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
    st = None
    if collect_state:
        y, st = rglru.lru_apply_train(p["lru"], h, cfg, return_state=True)
    else:
        y = rglru.lru_apply_train(p["lru"], h, cfg)
    x = x + y
    h = layers.rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
    x = x + layers.mlp_apply(p["mlp"], h, cfg)
    return (x, st) if collect_state else x


def _hybrid_group_apply(g, x, positions, cfg):
    x = _lru_block_apply(g["lru0"], x, cfg)
    x = _lru_block_apply(g["lru1"], x, cfg)
    return _dense_block_apply(g["attn"], x, positions, cfg,
                              window=cfg.window)


def _encdec_block_apply(p, x, enc, positions, cfg):
    h = layers.rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
    x = x + attn.attn_apply_train(p["self_attn"], h, positions, cfg)
    h = layers.rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
    x = x + attn.attn_apply_train(p["cross_attn"], h, positions, cfg,
                                  causal=False, kv_x=enc, use_rope=False)
    h = layers.rms_norm(x, p["ln3"]["scale"], cfg.norm_eps)
    return x + layers.mlp_apply(p["mlp"], h, cfg)


def _lru_step(p, x, h, cb, cfg):
    """One decode step of an rglru block: (x, new h, new conv buffer)."""
    u = layers.rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
    y, h, cb = rglru.lru_apply_decode(p["lru"], u, h, cb, cfg)
    x = x + y
    u = layers.rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
    return x + layers.mlp_apply(p["mlp"], u, cfg), h, cb


# ===========================================================================
# The cache
# ===========================================================================


def cache_leaves(cfg, batch: int, capacity: int, src_len: int = 0
                 ) -> Dict[str, tuple]:
    """{leaf: (shape, dtype)} of :func:`init_cache`'s cache (its position
    apart)."""
    dt = cdtype(cfg)
    f32 = torch.float32
    fam = cfg.family
    KV, Dh = cfg.n_kv_heads, cfg.d_head
    if fam in ("dense", "vlm"):
        L = cfg.n_layers
        return {"k": ((L, batch, capacity, KV, Dh), dt),
                "v": ((L, batch, capacity, KV, Dh), dt)}
    if fam == "moe":
        c = {}
        Ld, Lm = cfg.n_dense_layers, cfg.n_layers - cfg.n_dense_layers
        for suffix, n in (("_d", Ld), ("_m", Lm)):
            if not n:
                continue
            if cfg.use_mla:
                c["ckv" + suffix] = ((n, batch, capacity, cfg.kv_lora_rank),
                                     dt)
                c["krope" + suffix] = ((n, batch, capacity, cfg.qk_rope_dim),
                                       dt)
            else:
                c["k" + suffix] = ((n, batch, capacity, KV, Dh), dt)
                c["v" + suffix] = ((n, batch, capacity, KV, Dh), dt)
        return c
    if fam == "ssm":
        L, H, N, Pd = (cfg.n_layers, cfg.n_ssm_heads, cfg.ssm_state,
                       cfg.ssm_headdim)
        conv_dim = cfg.d_inner + 2 * cfg.ssm_ngroups * N
        return {"state": ((L, batch, H, N, Pd), f32),
                "conv": ((L, batch, cfg.ssm_conv - 1, conv_dim), dt)}
    if fam == "hybrid":
        ng, rem = _hybrid_split(cfg)
        W = cfg.lru_width or cfg.d_model
        K = cfg.ssm_conv
        win = min(cfg.window, capacity)
        c = {"lru_h": ((ng, 2, batch, W), f32),
             "lru_conv": ((ng, 2, batch, K - 1, W), dt),
             "attn_k": ((ng, batch, win, KV, Dh), dt),
             "attn_v": ((ng, batch, win, KV, Dh), dt)}
        if rem:
            c["rem_lru_h"] = ((rem, batch, W), f32)
            c["rem_lru_conv"] = ((rem, batch, K - 1, W), dt)
        return c
    if fam == "encdec":
        Ld = cfg.n_dec_layers
        return {"self_k": ((Ld, batch, capacity, KV, Dh), dt),
                "self_v": ((Ld, batch, capacity, KV, Dh), dt),
                "cross_k": ((Ld, batch, src_len, KV, Dh), dt),
                "cross_v": ((Ld, batch, src_len, KV, Dh), dt)}
    raise ValueError(fam)


def init_cache(cfg, batch: int, capacity: int, device=None,
               src_len: int = 0) -> Cache:
    """Zeroed serving cache of ``batch`` sequences of ``capacity``
    positions (encdec: and ``src_len`` encoder positions), with the JAX
    package's leaves."""
    device = resolve_device(device)
    cache: Cache = {k: torch.zeros(shape, dtype=dtype, device=device)
                    for k, (shape, dtype) in cache_leaves(
                        cfg, batch, capacity, src_len).items()}
    cache["pos"] = 0
    return cache


# ===========================================================================
# Loss (sequence-chunked so (B,S,V) logits are never materialised at once)
# ===========================================================================


def _xent_sums(logits, labels, v0=None):
    """(summed negative log-likelihood, number of labels >= 0).
    ``v0``: ``logits`` are this rank's vocabulary block from row ``v0``
    (``layers.vocab_offset``); the maximum, the sum of the exponentials
    and the label's logit are then combined over ``model`` in float32
    (no gradient through the maximum, which cancels)."""
    logits = logits.float()
    valid = labels >= 0
    safe = labels.clamp_min(0)
    ax = par.model_axis() if v0 is not None else None
    if ax is None:
        logz = torch.logsumexp(logits, dim=-1)
        picked = logits.gather(-1, safe[..., None].long())[..., 0]
    else:
        v_loc = logits.shape[-1]
        m = coll.max_over(logits.detach().amax(dim=-1), ax.group)
        logz = m + torch.log(coll.all_reduce(
            torch.exp(logits - m[..., None]).sum(dim=-1), ax.group))
        rel = safe - v0
        inside = (rel >= 0) & (rel < v_loc)
        picked = coll.all_reduce(logits.gather(
            -1, rel.clamp(0, v_loc - 1)[..., None].long())[..., 0]
            * inside, ax.group)
    ll = picked - logz
    return -(ll * valid).sum(), valid.sum()


def lm_loss_from_hidden(params, hidden, labels, cfg, chunk=1024):
    """Mean token cross-entropy of the LM head over ``hidden`` (B,S,D),
    labels < 0 ignored, in sequence chunks of the largest divisor of S
    that is at most ``chunk`` (vlm text spans are not powers of two).
    A head split over ``model`` gives each rank its vocabulary block's
    logits (:func:`_xent_sums`)."""
    S = hidden.shape[1]
    C = max(d for d in range(1, min(chunk, S) + 1) if S % d == 0)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    n = torch.zeros((), dtype=torch.int64, device=hidden.device)
    v0 = layers.vocab_offset(params, cfg)
    for c0 in range(0, S, C):
        logits = layers.logits_apply(params, hidden[:, c0:c0 + C], cfg)
        s, k = _xent_sums(logits, labels[:, c0:c0 + C],
                          None if logits.shape[-1] == cfg.vocab_size
                          else v0)
        tot, n = tot + s, n + k
    tot, n = par.dp_sum(tot), par.dp_sum(n)
    return tot / n.clamp_min(1)


def _in_context(fn, context, plans, p, *args, **kw):
    """``fn`` under the mesh context ``context`` (``parallel.api
    .active()``: the one the block's forward ran under, again when it is
    recomputed), on the gathered weights of ``p`` when sharded (``plans``:
    its ``gather_plans``)."""
    with par.reentered(context):
        return fn(p if plans is None else par.gathered(p, plans), *args,
                  **kw)


#: the attention caches ((L, B, S, ...): K/V, MLA latents, encdec's self
#: and cross K/V, the hybrid's window ring), which a sharded decode attends
#: block by block along their sequence
_KV_LEAVES = frozenset(("k", "v", "k_d", "v_d", "k_m", "v_m", "ckv_d",
                        "krope_d", "ckv_m", "krope_m", "self_k", "self_v",
                        "cross_k", "cross_v", "attn_k", "attn_v"))


#: cache leaves whose batch rows are not on axis 1 (the hybrid's stacked
#: pairs, (groups, 2, B, ...)); ``cache_spec``'s rule puts ``dp`` on axis
#: 1 all the same, as the reference's does
_CACHE_ROW_AXIS = {"lru_h": 2, "lru_conv": 2}

#: cache leaves a tensor-parallel prefill computes for the rank's heads
#: alone, and their heads' axis
_HEAD_AXIS = {**{k: 3 for k in ("k", "v", "k_d", "v_d", "k_m", "v_m",
                                "self_k", "self_v", "cross_k", "cross_v",
                                "attn_k", "attn_v")},
              "state": 2}


def _moe_cache_keys(cfg):
    """The moe cache's leaf names, before their ``_d`` / ``_m`` suffix."""
    return ("ckv", "krope") if cfg.use_mla else ("k", "v")


# ===========================================================================
# The model
# ===========================================================================


class Transformer(nn.Module):
    """An LM of any family with random weights drawn from ``generator``.

    ``device=None`` means the CUDA card (raises without one); pass
    ``device="cpu"`` for the CPU, or ``"meta"`` for shapes alone (the
    dry-run's).  ``generator`` (a ``torch.Generator`` on that device; on
    meta, which has none, a CPU one) defaults to one seeded with 0."""

    def __init__(self, cfg, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(
                device="cpu" if device.type == "meta" else device
            ).manual_seed(0)
        self.cfg = cfg
        gen = generator
        self.embed = ParamTree({"tok": layers.embed_param(
            gen, cfg.vocab_size, cfg.d_model, device)})
        self.final_norm = ParamTree(layers.norm_init(cfg.d_model, device))
        if not cfg.tie_embeddings:
            self.lm_head = ParamTree({"w": layers.dense_param(
                gen, (cfg.d_model, cfg.vocab_size), cfg.d_model, device)})
        for key, (block_init, n) in _stacks(cfg).items():
            self.add_module(key, nn.ModuleList(
                ParamTree(block_init(gen, cfg, device)) for _ in range(n)))
        if cfg.family == "encdec":
            self.enc_norm = ParamTree(layers.norm_init(cfg.d_model, device))
        # set by parallel.api.shard_module: the DeviceMesh whose ranks hold
        # the parameters as blocks; set by train.loop for a step's
        # microbatches: the top-level trees' leaves gathered once
        self.mesh = None
        self.hoisted = None

    # the JAX package's top-level keys, for layers.logits_apply
    def __getitem__(self, key):
        return getattr(self, key)

    def __contains__(self, key) -> bool:
        return key in self._modules

    @property
    def device(self) -> torch.device:
        return self.embed["tok"].device

    @torch.no_grad()
    def logits(self, x):
        with self._on_mesh():
            return self._logits(x)

    def _positions(self, B: int, S: int):
        return torch.arange(S, device=self.device).expand(B, S)

    def _inputs(self, tokens, patches=None):
        """Token embeddings, after the patch embeddings for vlm, as the
        residual stream (run under :func:`parallel.api.sequence` of their
        whole length: :meth:`_seq_len`)."""
        if self.cfg.family != "vlm":
            return layers.embed_apply(self._top("embed")["tok"], tokens,
                                      self.cfg)
        with par.sequence(None):
            x = layers.embed_apply(self._top("embed")["tok"], tokens,
                                   self.cfg)
        x = torch.cat([patches.to(x.dtype), x], dim=1)
        return layers.to_residual(x, partial=False)

    def _seq_len(self, tokens, patches=None) -> int:
        return tokens.shape[1] + (patches.shape[1] if patches is not None
                                  and self.cfg.family == "vlm" else 0)

    def _block(self, fn, p, *args, **kw):
        """``fn(p, *args, **kw)``, a block of a layer stack (sharded:
        ``fn`` of ``p``'s gathered weights), under the mesh context it was
        called in; with ``cfg.remat == "block"`` and autograd recording,
        under activation checkpointing (``jax.checkpoint``'s counterpart:
        the block's forward, its gathers too, runs again in the backward
        pass; no number changes)."""
        plans = None if self.mesh is None else self.gather_plans
        fn = functools.partial(_in_context, fn, par.active(), plans)
        if self.cfg.remat == "block" and torch.is_grad_enabled():
            return checkpoint(fn, p, *args, use_reentrant=False, **kw)
        return fn(p, *args, **kw)

    def _gather_dtype(self):
        """The dtype serving gathers weights in (no gradient is taken:
        the compute dtype); None in training (each plan's own)."""
        return None if torch.is_grad_enabled() else cdtype(self.cfg)

    def _top(self, key):
        """The top-level tree ``key`` (``embed``, ``final_norm``, ...),
        gathered when sharded (or taken from ``hoisted``)."""
        if self.mesh is None:
            return self[key]
        return par.gathered(self[key], self.gather_plans, self.hoisted,
                            self._gather_dtype())

    def _head(self):
        """What ``layers.logits_apply`` reads: the model, or (sharded) its
        final norm and LM head gathered once for every sequence chunk."""
        if self.mesh is None:
            return self
        key = "embed" if self.cfg.tie_embeddings else "lm_head"
        return {k: self._top(k) for k in ("final_norm", key)}

    def _on_mesh(self):
        """The sharded model's mesh as the active one (its ranks run the
        EP branch and the data-parallel sums); nothing in one process."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return par.mesh_context(self.mesh)

    def _encode(self, frames):
        """Encoder over precomputed frame embeddings (frontend stub):
        its output whole along its sequence."""
        cfg = self.cfg
        B, S = frames.shape[:2]
        positions = self._positions(B, S)
        with par.sequence(S):
            x = layers.to_residual(frames.to(cdtype(cfg)), partial=False)
            for p in self.enc_blocks:
                x = self._block(_dense_block_apply, p, x, positions, cfg,
                                causal=False)
            x = layers.rms_norm(x, self._top("enc_norm")["scale"],
                                cfg.norm_eps)
            return layers.seq_gather(x)

    def forward_hidden(self, tokens, patches=None, frames=None,
                       tgt_tokens=None):
        """Returns (hidden (B,S,D), aux loss float32 scalar: the MoE load
        balance, else 0).  vlm takes ``patches`` (B,P,D) in front of
        ``tokens``; encdec takes ``frames`` (B,Ssrc,D) and ``tgt_tokens``
        (B,S) of the same length (the blocked cross-attention's).
        Autograd records it unless the caller turns it off."""
        with self._on_mesh():
            return self._forward_hidden(tokens, patches, frames, tgt_tokens)

    def _forward_hidden(self, tokens, patches, frames, tgt_tokens):
        cfg = self.cfg
        if cfg.family == "encdec":
            enc = self._encode(frames)
            B, S = tgt_tokens.shape
            with par.sequence(S):
                x = layers.embed_apply(self._top("embed")["tok"],
                                       tgt_tokens, cfg)
                positions = self._positions(B, S)
                for p in self.dec_blocks:
                    x = self._block(_encdec_block_apply, p, x, enc,
                                    positions, cfg)
                return layers.seq_gather(x), torch.zeros(
                    (), dtype=torch.float32, device=self.device)
        S = self._seq_len(tokens, patches)
        with par.sequence(S):
            x, aux = self._stack(tokens, patches)
            return layers.seq_gather(x), aux

    def _stack(self, tokens, patches):
        """The residual stream after every block, and the aux loss."""
        cfg = self.cfg
        fam = cfg.family
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        x = self._inputs(tokens, patches)
        positions = self._positions(tokens.shape[0],
                                    self._seq_len(tokens, patches))
        if fam in ("dense", "vlm"):
            for p in self.blocks:
                x = self._block(_dense_block_apply, p, x, positions, cfg)
        elif fam == "moe":
            for p in self.dense_blocks if "dense_blocks" in self else ():
                out = self._block(_dense_block_apply, p, x, positions, cfg,
                                  use_mla=cfg.use_mla)
                x = out[0] if isinstance(out, tuple) else out
            for p in self.moe_blocks:
                x, a, _ = self._block(_moe_block_apply, p, x, positions, cfg)
                aux = aux + a
        elif fam == "ssm":
            for p in self.blocks:
                x = self._block(_ssm_block_apply, p, x, cfg)
        else:  # hybrid
            for g in self.groups:
                x = self._block(_hybrid_group_apply, g, x, positions, cfg)
            for p in self.rem_lru if "rem_lru" in self else ():
                x = self._block(_lru_block_apply, p, x, cfg)
        return x, aux

    def loss_and_metrics(self, batch):
        """batch: the family's dict of tensors (``tokens`` and ``labels``;
        vlm also ``patches``; encdec ``frames``, ``tokens`` and ``labels``)
        -> (loss, {"loss", "xent", "aux"}), float32 scalars.  Sharded,
        each rank passes its rows and every rank gets the global batch's
        loss."""
        with self._on_mesh():
            return self._loss_and_metrics(batch)

    def _loss_and_metrics(self, batch):
        fam = self.cfg.family
        if fam == "encdec":
            hidden, aux = self.forward_hidden(None, frames=batch["frames"],
                                              tgt_tokens=batch["tokens"])
        elif fam == "vlm":
            hidden, aux = self.forward_hidden(batch["tokens"],
                                              patches=batch["patches"])
            # loss on the text positions
            hidden = hidden[:, batch["patches"].shape[1]:]
        else:
            hidden, aux = self.forward_hidden(batch["tokens"])
        xent = lm_loss_from_hidden(self._head(), hidden, batch["labels"],
                                   self.cfg)
        loss = xent + aux
        return loss, {"loss": loss, "xent": xent, "aux": aux}

    def _weights(self, p):
        """A block's tree: its parameters, or (sharded) its weights
        gathered (the serving paths' counterpart of :meth:`_block`)."""
        if self.mesh is None:
            return p
        return par.gathered(p, self.gather_plans,
                            dtype=self._gather_dtype())

    def init_cache(self, batch: int, capacity: int, src_len: int = 0) -> Cache:
        """A zeroed cache of ``batch`` sequences (sharded: the global batch;
        each leaf this rank's block for ``cache_sharding``, the specs under
        ``"specs"``)."""
        if self.mesh is None:
            return init_cache(self.cfg, batch, capacity, self.device,
                              src_len)
        ranks = par.mesh_ranks(self.mesh)
        cache: Cache = {"pos": 0, "specs": {}}
        for k, (whole, dtype) in cache_leaves(self.cfg, batch, capacity,
                                              src_len).items():
            spec = cache["specs"][k] = par.cache_spec(whole, self.mesh)
            shape = [d // par.block_index(e, ranks.axes, ranks.coord)[1]
                     for d, e in zip(whole, spec)]
            cache[k] = torch.zeros(shape, dtype=dtype, device=self.device)
        return cache

    def _placed(self, cache: Cache, batch: int) -> Cache:
        """A cache of this rank's rows of a global batch of ``batch`` as
        this rank's blocks (:func:`parallel.api.place_rows`), with their
        specs under ``"specs"``; the cache itself in one process.  A leaf
        that holds the rank's heads alone (tensor parallelism,
        :data:`_HEAD_AXIS`) is its block as it is where the cache splits
        its heads over ``model`` (the ssm state), goes to the cache's
        sequence blocks by an all-to-all over ``model`` where the cache
        splits its sequence there, and is gathered whole over its heads
        elsewhere."""
        if self.mesh is None:
            return cache
        ranks = par.mesh_ranks(self.mesh)
        rows = par.rows_entry(batch, self.mesh)
        n = par.block_index(rows, ranks.axes, ranks.coord)[1]
        ax_m = par.model_axis()
        whole = cache_leaves(self.cfg, 1, 1)
        out: Cache = {"specs": {}}
        for k, t in cache.items():
            if not isinstance(t, torch.Tensor):
                out[k] = t
                continue
            ax = _CACHE_ROW_AXIS.get(k, 1)
            shape = list(t.shape)
            shape[ax] *= n
            hax = _HEAD_AXIS.get(k)
            split = hax is not None and t.shape[hax] != whole[k][0][hax]
            if split:
                shape[hax] *= ax_m.size
            spec = out["specs"][k] = par.cache_spec(shape, self.mesh)
            if split and spec[hax] == "model" and spec[ax] == rows:
                out[k] = t.contiguous()
                continue
            if split and spec[2] == "model" and spec[ax] == rows:
                got = coll.exchange_blocks(t.chunk(ax_m.size, 2), ax_m.group)
                out[k] = torch.cat(got, hax)
                continue
            if split:
                t = torch.cat(coll.gather_blocks(t.contiguous(), ax_m.group),
                              hax)
            out[k] = par.place_rows(t, spec, ax, self.mesh, rows)
        return out

    @torch.no_grad()
    def prefill(self, batch, global_batch: int = None,
                capacity: int = None) -> tuple:
        """Process the prompt (``batch["tokens"]`` (B,S); vlm also
        ``batch["patches"]``; encdec ``batch["frames"]`` alone, then one
        BOS decode step); returns (last-position logits (B,V), cache).
        ``capacity``: the positions the dense, moe and vlm caches (encdec:
        its self cache) hold, room for the decode steps after the prompt
        (default: the prompt's, as the JAX package's prefill; the ssm
        state and the hybrid's window ring do not grow).

        Sharded (``parallel.api.shard_module``): ``batch`` is this rank's
        rows (``parallel.api.batch_rows``) of a global batch of
        ``global_batch`` (default: the rows times the ``dp`` ranks); each
        block's weights are gathered for its layer, and the cache comes
        back as this rank's blocks (``cache_sharding``)."""
        with self._on_mesh():
            return self._prefill(batch, global_batch, capacity)

    def _prefill(self, batch, global_batch, capacity):
        cfg = self.cfg
        fam = cfg.family
        dt = cdtype(cfg)
        W = self._weights
        lead = batch["frames"] if fam == "encdec" else batch["tokens"]
        B = global_batch or lead.shape[0] * (
            1 if self.mesh is None else par.dp_size(self.mesh))

        if fam == "encdec":
            frames = batch["frames"]
            enc = self._encode(frames)
            Ssrc = frames.shape[1]
            kvs = [attn.cross_attn_project_kv(W(p)["cross_attn"], enc, cfg)
                   for p in self.dec_blocks]
            cache = self.init_cache(B, capacity=max(capacity or 0, Ssrc),
                                    src_len=Ssrc)
            cross = self._placed(
                {"cross_k": torch.stack([k for k, _ in kvs]).to(dt),
                 "cross_v": torch.stack([v for _, v in kvs]).to(dt)}, B)
            for k in ("cross_k", "cross_v"):
                cache[k] = cross[k]
            bos = torch.zeros((frames.shape[0],), dtype=torch.int64,
                              device=self.device)
            return self._decode_step(cache, bos)

        S = self._seq_len(batch["tokens"], batch.get("patches"))
        with par.sequence(S):
            last, cache = self._prefill_stack(batch, S)
        if fam in ("dense", "moe", "vlm") and (capacity or 0) > S:
            for k in [k for k in cache if k in _KV_LEAVES]:
                t = cache[k]
                cache[k] = nn.functional.pad(
                    t, [0, 0] * (t.dim() - 3) + [0, capacity - S])
        return self._logits(last), self._placed(cache, B)

    def _prefill_stack(self, batch, S):
        """(the last position of the residual stream after every block,
        the cache of this rank's rows whole along its sequence)."""
        cfg = self.cfg
        fam = cfg.family
        dt = cdtype(cfg)
        W = self._weights
        x = self._inputs(batch["tokens"], batch.get("patches"))
        positions = self._positions(batch["tokens"].shape[0], S)
        cache: Cache = {"pos": S}

        def put(keys, leaves):
            for key, col in zip(keys, zip(*leaves)):
                cache[key] = torch.stack(col)

        if fam in ("dense", "vlm"):
            kvs = []
            for p in self.blocks:
                x, (k, v) = _dense_block_apply(W(p), x, positions, cfg,
                                               collect_kv=True)
                kvs.append((k.to(dt), v.to(dt)))
            put(("k", "v"), kvs)
        elif fam == "moe":
            keys = _moe_cache_keys(cfg)
            kvs = []
            for p in self.dense_blocks if "dense_blocks" in self else ():
                x, kv = _dense_block_apply(W(p), x, positions, cfg,
                                           use_mla=cfg.use_mla,
                                           collect_kv=True)
                kvs.append(tuple(t.to(dt) for t in kv))
            if kvs:
                put([k + "_d" for k in keys], kvs)
            kvs = []
            for p in self.moe_blocks:
                x, _, kv = _moe_block_apply(W(p), x, positions, cfg,
                                            collect_kv=True)
                kvs.append(tuple(t.to(dt) for t in kv))
            put([k + "_m" for k in keys], kvs)
        elif fam == "ssm":
            states = []
            for p in self.blocks:
                x, (st, conv) = _ssm_block_apply(W(p), x, cfg,
                                                 collect_state=True)
                states.append((st, conv.to(dt)))
            put(("state", "conv"), states)
        else:  # hybrid
            win = cfg.window
            groups = []
            for g in self.groups:
                g = W(g)
                x, st0 = _lru_block_apply(g["lru0"], x, cfg,
                                          collect_state=True)
                x, st1 = _lru_block_apply(g["lru1"], x, cfg,
                                          collect_state=True)
                x, (k, v) = _dense_block_apply(g["attn"], x, positions, cfg,
                                               window=win, collect_kv=True)
                groups.append((torch.stack([st0[0], st1[0]]),
                               torch.stack([st0[1].to(dt), st1[1].to(dt)]),
                               # copies: views would keep each group's
                               # whole k and v alive
                               k[:, -win:].to(dt).clone(),
                               v[:, -win:].to(dt).clone()))
            put(("lru_h", "lru_conv", "attn_k", "attn_v"), groups)
            rems = []
            for p in self.rem_lru if "rem_lru" in self else ():
                x, (h, conv) = _lru_block_apply(W(p), x, cfg,
                                                collect_state=True)
                rems.append((h, conv.to(dt)))
            if rems:
                put(("rem_lru_h", "rem_lru_conv"), rems)
        ax = par.seq_axis()
        if ax is None:
            return x[:, -1], cache
        # the last position is on the last sequence block's rank
        return coll.gather_blocks(x[:, -1].contiguous(), ax.group)[-1], cache

    def _logits(self, x):
        """Logits of the whole vocabulary of ``x`` (B, D) (a vocab block
        all-gathered over ``model``)."""
        return layers.columns(layers.logits_apply(self._head(), x, self.cfg),
                              self.cfg.vocab_size)

    def _serving_leaves(self, cache: Cache):
        """What the decode step reads of a cache: (leaves, sequence
        shards, heads, leaves to place back).  In one process the cache's
        leaves.  Sharded, the attention caches and the ssm state stay this
        rank's blocks (a cache split along its sequence gets its
        ``attention.SeqShard``; a state split over its heads, its first
        head and group), every other leaf is gathered into this rank's
        rows whole (:func:`parallel.api.rows_of`) and placed back after
        the step."""
        if self.mesh is None:
            return cache, {}, None, {}
        specs = cache["specs"]
        ranks = par.mesh_ranks(self.mesh)
        k0 = next(iter(specs))
        ax0 = _CACHE_ROW_AXIS.get(k0, 1)
        batch = cache[k0].shape[ax0] * par.block_index(
            specs[k0][ax0], ranks.axes, ranks.coord)[1]
        rows = par.rows_entry(batch, self.mesh)
        work, shards, heads, back = {}, {}, None, {}

        def split(entry, n_block):
            """(first index, whole length, group) of a dimension of
            ``n_block`` split over ``entry``'s axes here."""
            i, n = par.block_index(entry, ranks.axes, ranks.coord)
            return i * n_block, n * n_block, ranks.group(
                par.spec_axes((entry,)))

        for k, spec in specs.items():
            t = cache[k]
            ax = _CACHE_ROW_AXIS.get(k, 1)
            native = spec[ax] == rows and all(e is None for e in spec[3:])
            if native and k in _KV_LEAVES:
                off, length, group = split(spec[2], t.shape[2])
                shards[k] = (attn.SeqShard(off, length, group)
                             if group is not None else None)
                work[k] = t
            elif native and k == "state":
                off, _, group = split(spec[2], t.shape[2])
                heads = off if group is not None else None
                work[k] = t
            else:
                work[k] = par.rows_of(t, spec, ax, self.mesh, rows)
                if work[k] is not t:
                    back[k] = (spec, ax, rows)
        return work, shards, heads, back

    @torch.no_grad()
    def decode_step(self, cache: Cache, tokens) -> tuple:
        """One token for the whole batch.  tokens: (B,) int.  Returns
        (logits (B,V), new cache at ``pos + 1``).

        Consumes ``cache``: every family writes the step into its tensors
        in place (K/V or MLA latents at ``pos``, the hybrid ring at ``pos
        % window``, recurrent states and conv buffers whole; encdec's
        cross K/V are only read), and the new cache holds those same
        tensors.  A caller that needs the old cache afterwards (a branch,
        a retry) clones it first.  The JAX package's ``decode_step`` is
        functional instead.

        Sharded: ``tokens`` are this rank's rows and ``cache`` its blocks
        (:meth:`prefill`'s, :meth:`init_cache`'s); an attention cache
        split along its sequence is attended block by block, merged over
        its group (``attention.decode_attention_sharded``), the ssm state
        is updated head block by head block (``ssm.ssm_apply_decode``'s
        ``heads``), every other leaf gathered into this rank's rows and
        placed back (:meth:`_serving_leaves`)."""
        with self._on_mesh():
            return self._decode_step(cache, tokens)

    def _decode_step(self, cache: Cache, tokens) -> tuple:
        cfg = self.cfg
        fam = cfg.family
        pos = int(cache["pos"])
        c, shards, heads, back = self._serving_leaves(cache)
        W = self._weights
        x = layers.embed_apply(self._top("embed")["tok"], tokens, cfg)

        def mlp_res(p, x, ln="ln2"):
            h = layers.rms_norm(x, p[ln]["scale"], cfg.norm_eps)
            return x + layers.mlp_apply(p["mlp"], h, cfg)

        def attn_res(p, x, k, v, key, window=0):
            h = layers.rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
            shard = shards.get(key)
            if cfg.use_mla:
                h, _, _ = attn.mla_apply_decode(p["attn"], h, pos, k, v, cfg,
                                                shard=shard)
            else:
                h, _, _ = attn.attn_apply_decode(p["attn"], h, pos, k, v, cfg,
                                                 window=window, shard=shard)
            return x + h

        if fam in ("dense", "vlm"):
            for p, k, v in zip(self.blocks, c["k"], c["v"]):
                p = W(p)
                x = mlp_res(p, attn_res(p, x, k, v, "k"))
        elif fam == "moe":
            keys = _moe_cache_keys(cfg)
            if "dense_blocks" in self:
                for p, a, b in zip(self.dense_blocks, c[keys[0] + "_d"],
                                   c[keys[1] + "_d"]):
                    p = W(p)
                    x = mlp_res(p, attn_res(p, x, a, b, keys[0] + "_d"))
            for p, a, b in zip(self.moe_blocks, c[keys[0] + "_m"],
                               c[keys[1] + "_m"]):
                p = W(p)
                x = attn_res(p, x, a, b, keys[0] + "_m")
                h = layers.rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
                y, _ = moe.moe_apply(p["moe"], h[:, None, :], cfg)
                x = x + y[:, 0]
        elif fam == "ssm":
            for p, st, cb in zip(self.blocks, c["state"], c["conv"]):
                p = W(p)
                h = layers.rms_norm(x, p["ln"]["scale"], cfg.norm_eps)
                y, new_st, new_cb = ssm.ssm_apply_decode(p["ssm"], h, st, cb,
                                                         cfg, heads=heads)
                x = x + y
                st.copy_(new_st)
                cb.copy_(new_cb)
        elif fam == "hybrid":
            for g, lh, lc, k, v in zip(self.groups, c["lru_h"],
                                       c["lru_conv"], c["attn_k"],
                                       c["attn_v"]):
                g = W(g)
                for j, name in enumerate(("lru0", "lru1")):
                    x, h, cb = _lru_step(g[name], x, lh[j], lc[j], cfg)
                    lh[j].copy_(h)
                    lc[j].copy_(cb)
                x = mlp_res(g["attn"], attn_res(g["attn"], x, k, v, "attn_k",
                                                window=cfg.window))
            if "rem_lru" in self:
                for p, lh, lc in zip(self.rem_lru, c["rem_lru_h"],
                                     c["rem_lru_conv"]):
                    x, h, cb = _lru_step(W(p), x, lh, lc, cfg)
                    lh.copy_(h)
                    lc.copy_(cb)
        elif fam == "encdec":
            for p, k, v, ck, cv in zip(self.dec_blocks, c["self_k"],
                                       c["self_v"], c["cross_k"],
                                       c["cross_v"]):
                p = W(p)
                h = layers.rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
                h, _, _ = attn.attn_apply_decode(p["self_attn"], h, pos, k, v,
                                                 cfg, shard=shards.get("self_k"))
                x = x + h
                h = layers.rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
                x = x + attn.cross_attn_decode(p["cross_attn"], h, ck, cv, cfg,
                                               shard=shards.get("cross_k"))
                x = mlp_res(p, x, "ln3")
        else:
            raise ValueError(fam)
        for k, (spec, ax, rows) in back.items():
            cache[k].copy_(par.place_rows(c[k], spec, ax, self.mesh, rows))
        new_cache = dict(cache)
        new_cache["pos"] = pos + 1
        return self._logits(x), new_cache
