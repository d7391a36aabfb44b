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
parameter is kept as this rank's block of a ``DeviceMesh``, each block's
weights are gathered whole just before use and dropped after (inside the
recomputed region under ``remat``; the top-level trees' once for a
step's microbatches, ``hoisted``), and the loss's sums and token count
are summed over the data-parallel ranks before the division, as the
reference takes them over the global batch.  Serving a sharded model is
not ported (``prefill`` and ``decode_step`` raise).
Two pieces of the JAX module are not carried over: ``scan_util`` (its
unrolled mode only serves XLA's cost analysis) and ``_x_constraint``
(sharding annotations: placement here is explicit).

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
        h, kv = _attn_with_kv(p["attn"], h, positions, cfg, causal, window)
    else:
        h = attn.attn_apply_train(p["attn"], h, positions, cfg,
                                  causal=causal, window=window)
    x = x + h
    h = layers.rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
    x = x + layers.mlp_apply(p["mlp"], h, cfg)
    return (x, kv) if (collect_kv or use_mla) else x


def _attn_with_kv(p, h, positions, cfg, causal=True, window=0):
    """Like attn_apply_train but also returns the rope'd K/V (prefill)."""
    q, k, v = attn._project_qkv(p, h, h, cfg)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    o = attn.blocked_attention(q, k, v, causal=causal, window=window,
                               q_chunk=cfg.attn_chunk,
                               kv_chunk=cfg.attn_chunk)
    o = o.reshape(*o.shape[:-2], cfg.n_heads * cfg.d_head)
    out = o @ p["wo"].to(cdtype(cfg))
    return out, (k, v)


def _moe_block_apply(p, x, positions, cfg, collect_kv=False):
    h = layers.rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
    kv = None
    if cfg.use_mla:
        h, kv = attn.mla_apply_train(p["attn"], h, positions, cfg)
    elif collect_kv:
        h, kv = _attn_with_kv(p["attn"], h, positions, cfg)
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


def init_cache(cfg, batch: int, capacity: int, device=None,
               src_len: int = 0) -> Cache:
    """Zeroed serving cache of ``batch`` sequences of ``capacity``
    positions (encdec: and ``src_len`` encoder positions), with the JAX
    package's leaves."""
    device = resolve_device(device)
    dt = cdtype(cfg)
    fam = cfg.family
    KV, Dh = cfg.n_kv_heads, cfg.d_head

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    if fam in ("dense", "vlm"):
        L = cfg.n_layers
        return {"k": zeros(L, batch, capacity, KV, Dh),
                "v": zeros(L, batch, capacity, KV, Dh), "pos": 0}
    if fam == "moe":
        c: Cache = {"pos": 0}
        Ld, Lm = cfg.n_dense_layers, cfg.n_layers - cfg.n_dense_layers
        for suffix, n in (("_d", Ld), ("_m", Lm)):
            if not n:
                continue
            if cfg.use_mla:
                c["ckv" + suffix] = zeros(n, batch, capacity, cfg.kv_lora_rank)
                c["krope" + suffix] = zeros(n, batch, capacity,
                                            cfg.qk_rope_dim)
            else:
                c["k" + suffix] = zeros(n, batch, capacity, KV, Dh)
                c["v" + suffix] = zeros(n, batch, capacity, KV, Dh)
        return c
    if fam == "ssm":
        L, H, N, Pd = (cfg.n_layers, cfg.n_ssm_heads, cfg.ssm_state,
                       cfg.ssm_headdim)
        conv_dim = cfg.d_inner + 2 * cfg.ssm_ngroups * N
        return {"state": zeros(L, batch, H, N, Pd, dtype=torch.float32),
                "conv": zeros(L, batch, cfg.ssm_conv - 1, conv_dim),
                "pos": 0}
    if fam == "hybrid":
        ng, rem = _hybrid_split(cfg)
        W = cfg.lru_width or cfg.d_model
        K = cfg.ssm_conv
        win = min(cfg.window, capacity)
        c = {"lru_h": zeros(ng, 2, batch, W, dtype=torch.float32),
             "lru_conv": zeros(ng, 2, batch, K - 1, W),
             "attn_k": zeros(ng, batch, win, KV, Dh),
             "attn_v": zeros(ng, batch, win, KV, Dh),
             "pos": 0}
        if rem:
            c["rem_lru_h"] = zeros(rem, batch, W, dtype=torch.float32)
            c["rem_lru_conv"] = zeros(rem, batch, K - 1, W)
        return c
    if fam == "encdec":
        Ld = cfg.n_dec_layers
        return {"self_k": zeros(Ld, batch, capacity, KV, Dh),
                "self_v": zeros(Ld, batch, capacity, KV, Dh),
                "cross_k": zeros(Ld, batch, src_len, KV, Dh),
                "cross_v": zeros(Ld, batch, src_len, KV, Dh),
                "pos": 0}
    raise ValueError(fam)


# ===========================================================================
# Loss (sequence-chunked so (B,S,V) logits are never materialised at once)
# ===========================================================================


def _xent_sums(logits, labels):
    """(summed negative log-likelihood, number of labels >= 0)."""
    logits = logits.float()
    valid = labels >= 0
    safe = labels.clamp_min(0)
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, safe[..., None].long())[..., 0] - logz
    return -(ll * valid).sum(), valid.sum()


def lm_loss_from_hidden(params, hidden, labels, cfg, chunk=1024):
    """Mean token cross-entropy of the LM head over ``hidden`` (B,S,D),
    labels < 0 ignored, in sequence chunks of the largest divisor of S
    that is at most ``chunk`` (vlm text spans are not powers of two)."""
    S = hidden.shape[1]
    C = max(d for d in range(1, min(chunk, S) + 1) if S % d == 0)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    n = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for c0 in range(0, S, C):
        logits = layers.logits_apply(params, hidden[:, c0:c0 + C], cfg)
        s, k = _xent_sums(logits, labels[:, c0:c0 + C])
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

    def init_cache(self, batch: int, capacity: int, src_len: int = 0) -> Cache:
        return init_cache(self.cfg, batch, capacity, self.device, src_len)

    @torch.no_grad()
    def logits(self, x):
        return layers.logits_apply(self, x, self.cfg)

    def _positions(self, x):
        B, S = x.shape[0], x.shape[1]
        return torch.arange(S, device=x.device).expand(B, S)

    def _inputs(self, tokens, patches=None):
        """Token embeddings, after the patch embeddings for vlm."""
        x = layers.embed_apply(self._top("embed")["tok"], tokens, self.cfg)
        if self.cfg.family == "vlm":
            x = torch.cat([patches.to(x.dtype), x], dim=1)
        return x

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

    def _top(self, key):
        """The top-level tree ``key`` (``embed``, ``final_norm``, ...),
        gathered when sharded (or taken from ``hoisted``)."""
        if self.mesh is None:
            return self[key]
        return par.gathered(self[key], self.gather_plans, self.hoisted)

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

    def _unsharded(self, what: str):
        if self.mesh is not None:
            raise NotImplementedError(f"{what} of a sharded model")

    def _encode(self, frames):
        """Encoder over precomputed frame embeddings (frontend stub)."""
        cfg = self.cfg
        x = frames.to(cdtype(cfg))
        positions = self._positions(x)
        for p in self.enc_blocks:
            x = self._block(_dense_block_apply, p, x, positions, cfg,
                            causal=False)
        return layers.rms_norm(x, self._top("enc_norm")["scale"],
                               cfg.norm_eps)

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
        fam = cfg.family
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        if fam == "encdec":
            enc = self._encode(frames)
            x = layers.embed_apply(self._top("embed")["tok"], tgt_tokens,
                                   cfg)
            positions = self._positions(x)
            for p in self.dec_blocks:
                x = self._block(_encdec_block_apply, p, x, enc, positions,
                                cfg)
            return x, aux

        x = self._inputs(tokens, patches)
        positions = self._positions(x)
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

    @torch.no_grad()
    def prefill(self, batch) -> tuple:
        """Process the prompt (``batch["tokens"]`` (B,S); vlm also
        ``batch["patches"]``; encdec ``batch["frames"]`` alone, then one
        BOS decode step); returns (last-position logits (B,V), cache)."""
        self._unsharded("prefill")
        cfg = self.cfg
        fam = cfg.family
        dt = cdtype(cfg)

        if fam == "encdec":
            frames = batch["frames"]
            enc = self._encode(frames)
            B, Ssrc = frames.shape[0], frames.shape[1]
            kvs = [attn.cross_attn_project_kv(p["cross_attn"], enc, cfg)
                   for p in self.dec_blocks]
            cache = self.init_cache(B, capacity=Ssrc)
            cache["cross_k"] = torch.stack([k for k, _ in kvs]).to(dt)
            cache["cross_v"] = torch.stack([v for _, v in kvs]).to(dt)
            bos = torch.zeros((B,), dtype=torch.int64, device=self.device)
            return self.decode_step(cache, bos)

        x = self._inputs(batch["tokens"], batch.get("patches"))
        S = x.shape[1]
        positions = self._positions(x)
        cache: Cache = {"pos": S}

        def put(keys, leaves):
            for key, col in zip(keys, zip(*leaves)):
                cache[key] = torch.stack(col)

        if fam in ("dense", "vlm"):
            kvs = []
            for p in self.blocks:
                x, (k, v) = _dense_block_apply(p, x, positions, cfg,
                                               collect_kv=True)
                kvs.append((k.to(dt), v.to(dt)))
            put(("k", "v"), kvs)
        elif fam == "moe":
            keys = _moe_cache_keys(cfg)
            kvs = []
            for p in self.dense_blocks if "dense_blocks" in self else ():
                x, kv = _dense_block_apply(p, x, positions, cfg,
                                           use_mla=cfg.use_mla,
                                           collect_kv=True)
                kvs.append(tuple(t.to(dt) for t in kv))
            if kvs:
                put([k + "_d" for k in keys], kvs)
            kvs = []
            for p in self.moe_blocks:
                x, _, kv = _moe_block_apply(p, x, positions, cfg,
                                            collect_kv=True)
                kvs.append(tuple(t.to(dt) for t in kv))
            put([k + "_m" for k in keys], kvs)
        elif fam == "ssm":
            states = []
            for p in self.blocks:
                x, (st, conv) = _ssm_block_apply(p, x, cfg,
                                                 collect_state=True)
                states.append((st, conv.to(dt)))
            put(("state", "conv"), states)
        else:  # hybrid
            win = cfg.window
            groups = []
            for g in self.groups:
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
                x, (h, conv) = _lru_block_apply(p, x, cfg, collect_state=True)
                rems.append((h, conv.to(dt)))
            if rems:
                put(("rem_lru_h", "rem_lru_conv"), rems)
        return self.logits(x[:, -1]), cache

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
        functional instead."""
        self._unsharded("decode_step")
        cfg = self.cfg
        fam = cfg.family
        pos = int(cache["pos"])
        x = layers.embed_apply(self.embed["tok"], tokens, cfg)  # (B, D)

        def mlp_res(p, x, ln="ln2"):
            h = layers.rms_norm(x, p[ln]["scale"], cfg.norm_eps)
            return x + layers.mlp_apply(p["mlp"], h, cfg)

        def attn_res(p, x, k, v, window=0):
            h = layers.rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
            if cfg.use_mla:
                h, _, _ = attn.mla_apply_decode(p["attn"], h, pos, k, v, cfg)
            else:
                h, _, _ = attn.attn_apply_decode(p["attn"], h, pos, k, v, cfg,
                                                 window=window)
            return x + h

        if fam in ("dense", "vlm"):
            for p, k, v in zip(self.blocks, cache["k"], cache["v"]):
                x = mlp_res(p, attn_res(p, x, k, v))
        elif fam == "moe":
            keys = _moe_cache_keys(cfg)
            if "dense_blocks" in self:
                for p, a, b in zip(self.dense_blocks, cache[keys[0] + "_d"],
                                   cache[keys[1] + "_d"]):
                    x = mlp_res(p, attn_res(p, x, a, b))
            for p, a, b in zip(self.moe_blocks, cache[keys[0] + "_m"],
                               cache[keys[1] + "_m"]):
                x = attn_res(p, x, a, b)
                h = layers.rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
                y, _ = moe.moe_apply(p["moe"], h[:, None, :], cfg)
                x = x + y[:, 0]
        elif fam == "ssm":
            for p, st, cb in zip(self.blocks, cache["state"], cache["conv"]):
                h = layers.rms_norm(x, p["ln"]["scale"], cfg.norm_eps)
                y, new_st, new_cb = ssm.ssm_apply_decode(p["ssm"], h, st, cb,
                                                         cfg)
                x = x + y
                st.copy_(new_st)
                cb.copy_(new_cb)
        elif fam == "hybrid":
            for g, lh, lc, k, v in zip(self.groups, cache["lru_h"],
                                       cache["lru_conv"], cache["attn_k"],
                                       cache["attn_v"]):
                for j, name in enumerate(("lru0", "lru1")):
                    x, h, cb = _lru_step(g[name], x, lh[j], lc[j], cfg)
                    lh[j].copy_(h)
                    lc[j].copy_(cb)
                x = mlp_res(g["attn"], attn_res(g["attn"], x, k, v,
                                                window=cfg.window))
            if "rem_lru" in self:
                for p, lh, lc in zip(self.rem_lru, cache["rem_lru_h"],
                                     cache["rem_lru_conv"]):
                    x, h, cb = _lru_step(p, x, lh, lc, cfg)
                    lh.copy_(h)
                    lc.copy_(cb)
        elif fam == "encdec":
            for p, k, v, ck, cv in zip(self.dec_blocks, cache["self_k"],
                                       cache["self_v"], cache["cross_k"],
                                       cache["cross_v"]):
                h = layers.rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
                h, _, _ = attn.attn_apply_decode(p["self_attn"], h, pos, k, v,
                                                 cfg)
                x = x + h
                h = layers.rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
                x = x + attn.cross_attn_decode(p["cross_attn"], h, ck, cv, cfg)
                x = mlp_res(p, x, "ln3")
        else:
            raise ValueError(fam)
        new_cache = dict(cache)
        new_cache["pos"] = pos + 1
        return self.logits(x), new_cache
