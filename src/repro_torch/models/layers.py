"""Shared neural-net layers (plain torch functions over parameter trees).

The counterpart of ``repro.models.layers``.  Conventions:

* parameters are ``float32`` tensors (``cfg.param_dtype``) in the JAX
  package's layout (``(D_in, D_out)``), held in a :class:`ParamTree` whose
  keys are the JAX tree's keys; compute happens in ``cfg.dtype`` (bf16 by
  default) and parameters are cast at the point of use;
* init functions take a ``torch.Generator`` and return a plain dict of
  one layer's tensors.  They mirror the JAX init functions in
  distribution, not in bits: the two frameworks draw different numbers
  from one seed (``repro_torch.models.convert`` carries JAX weights over).

Tensor and sequence parallelism (on the ranks of a ``DeviceMesh`` whose
``model`` axis is larger than 1, ``parallel.api.model_axis``): a weight
whose spec names ``model`` is this rank's block of it
(``parallel.api.shard_module``), told apart from the whole weight by its
shape.  The residual stream between blocks is this rank's block of the
sequence where the sequence splits (``parallel.api.seq_axis``), whole
elsewhere (decode's one position).  A layer gathers its input's sequence
(:func:`seq_gather`), runs its column-parallel products on it (each
rank's columns: its heads, its share of the FFN width, its vocabulary
rows; :func:`heads`), and its row-parallel product's partial sums go back
into the stream by a reduce-scatter over the sequence, or an all-reduce
where the sequence does not split (:func:`row_linear`,
:func:`to_residual`).  A product whose weight is whole on every rank (its
dimension not divisible) is computed whole, as XLA computes it.  In one
process every weight is whole and these helpers return their input.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.parallel import api as par
from repro_torch.parallel import collectives as coll

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def cdtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


class ParamTree(nn.Module):
    """A nested dict of parameters with the JAX tree's keys.

    ``tree["wq"]`` and ``"wg" in tree`` work as on the JAX package's
    dicts, and ``state_dict()`` keys are the tree's paths joined by
    dots."""

    def __init__(self, tree: Dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v))

    def __getitem__(self, key):
        return getattr(self, key)

    def __contains__(self, key) -> bool:
        return key in self._parameters or key in self._modules


def dense_param(gen: torch.Generator, shape, in_axis_size, device):
    """Fan-in scaled truncated normal on [-2, 2] (``dense_param``)."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(in_axis_size ** -0.5)


def embed_param(gen: torch.Generator, vocab: int, d: int, device):
    w = torch.empty((vocab, d), dtype=torch.float32, device=device)
    return nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)


# ---------------------------------------------------------------------------
# Tensor and sequence parallelism on the model axis
# ---------------------------------------------------------------------------


def seq_gather(x):
    """The residual stream ``x`` (B, S_blk, ...) whole along its sequence:
    its blocks all-gathered over ``model`` where the sequence splits, else
    ``x`` (the gradient: the reduce-scatter of the cotangent)."""
    ax = par.seq_axis()
    if ax is None or x.dim() < 3:
        return x
    return coll.all_gather(x, 1, ax.group)


def to_residual(y, partial: bool):
    """``y`` (B, S, ...) whole along the sequence (decode's (B, D)) as the
    residual stream: ``partial``, this rank's share of a sum over
    ``model`` (a row-parallel product), reduce-scattered into the
    sequence blocks or all-reduced where the sequence does not split;
    else ``y`` is the value itself on every rank, and its sequence block
    is taken (a view)."""
    ax = par.model_axis()
    if ax is None:
        return y
    sp = par.seq_axis() if y.dim() >= 3 else None
    if partial:
        return (coll.reduce_scatter(y, 1, ax.group) if sp is not None
                else coll.all_reduce(y, ax.group))
    return par.shard_activation(y, ("dp", "sp")) if sp is not None else y


def heads(y, n: int, d: int):
    """(the heads, the first head's index) of ``y = x @ w``, ``w`` a weight
    of ``n`` heads of ``d`` columns or this rank's ``model`` block of its
    columns: the rank's own ``n / model`` heads where the axis divides
    ``n`` (the block holds exactly them), else all ``n`` (the column
    blocks all-gathered over ``model`` where ``w`` is split across heads)."""
    if y.shape[-1] != n * d:
        ax = par.model_axis()
        if n % ax.size == 0:
            n_loc = n // ax.size
            return y.unflatten(-1, (n_loc, d)), ax.index * n_loc
        y = coll.all_gather(y, -1, ax.group)
    return y.unflatten(-1, (n, d)), 0


def columns(y, n: int):
    """``y = x @ w`` whole (its ``n`` columns), ``w`` whole or this rank's
    ``model`` block of its columns (then all-gathered over ``model``)."""
    if y.shape[-1] == n:
        return y
    return coll.all_gather(y, -1, par.model_axis().group)


def row_linear(h, w, dt, full: int):
    """``h @ w`` into the residual stream (:func:`to_residual`): ``w`` a
    (``full``, D) weight or this rank's ``model`` block of its rows; ``h``
    the rows the block takes or all ``full`` of them (sliced)."""
    if w.shape[0] == full:
        return to_residual(h @ w.to(dt), partial=False)
    r = w.shape[0]
    if h.shape[-1] != r:
        i = par.model_axis().index
        h = h[..., i * r:(i + 1) * r]
    return to_residual(h @ w.to(dt), partial=True)


def channel_block(t, full: int, block: int, dim: int = -1):
    """This rank's ``block`` of ``full`` channels of ``t`` along ``dim``
    (``t`` itself where ``block == full``)."""
    if block == full:
        return t
    i = par.model_axis().index
    return t.narrow(dim, i * block, block)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x, scale, eps=1e-5):
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


def norm_init(d: int, device):
    # stored as a delta around 1.0 (gemma-style) so zeros == identity-ish
    return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}


# ---------------------------------------------------------------------------
# Activations / MLP
# ---------------------------------------------------------------------------


def _sq_relu(x):
    return F.relu(x).square()


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def activation_fn(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return _gelu_tanh
    if name == "sq_relu":
        return _sq_relu
    raise ValueError(f"unknown activation {name}")


def mlp_init(gen, d_model: int, d_ff: int, gated: bool, device):
    p = {
        "wi": dense_param(gen, (d_model, d_ff), d_model, device),
        "wo": dense_param(gen, (d_ff, d_model), d_ff, device),
    }
    if gated:
        p["wg"] = dense_param(gen, (d_model, d_ff), d_model, device)
    return p


def mlp_apply(p, x, cfg, d_ff: int = None, partial: bool = False):
    """x: the residual stream (normed) -> its update: ``wi`` / ``wg``
    column-parallel on the gathered sequence, ``wo`` row-parallel
    (``d_ff``: the whole FFN width, default ``cfg.d_ff``).  ``partial``:
    ``x`` is whole on every rank and the rank's share of the output is
    returned as it is (the MoE layer sums it with its experts')."""
    dt = cdtype(cfg)
    act = activation_fn(cfg.activation)
    if not partial:
        x = seq_gather(x)
    h = act(x @ p["wi"].to(dt))
    if "wg" in p:
        h = h * (x @ p["wg"].to(dt))
    full = d_ff or cfg.d_ff
    if partial:
        if p["wo"].shape[0] == full and par.model_axis() is not None:
            # whole weights: one rank's share is the product
            return h @ p["wo"].to(dt) * float(par.model_axis().index == 0)
        return h @ p["wo"].to(dt)
    return row_linear(h, p["wo"], dt, full)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(d_head: int, theta: float, device=None):
    exponent = torch.arange(0, d_head, 2, dtype=torch.float32,
                            device=device) / d_head
    return 1.0 / (theta ** exponent)  # (d_head // 2,)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, Dh) or (..., H, Dh) with matching positions
    (..., S) / (...,).  Rotates the two halves of Dh (no interleave)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (Dh/2,)
    angles = positions.float()[..., None] * freqs  # (..., S, Dh/2)
    # broadcast over the head axis, which sits between S and Dh
    angles = angles[..., None, :]
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


def embed_apply(embedding, tokens, cfg):
    """The embeddings of ``tokens`` as the residual stream.  Gather, then
    cast: the same values as casting the whole table first.  A table
    split over ``model`` (vocab-parallel, this rank's rows): each rank
    looks up the ids in its rows, zeros elsewhere, and the ranks' rows are
    summed into the stream (:func:`to_residual`; one term is not zero, so
    the sum is exact in any dtype)."""
    dt = cdtype(cfg)
    v_loc = embedding.shape[0]
    if v_loc == cfg.vocab_size:
        return to_residual(embedding[tokens].to(dt), partial=False)
    rel = tokens - par.model_axis().index * v_loc
    inside = (rel >= 0) & (rel < v_loc)
    rows = embedding[rel.clamp(0, v_loc - 1)] * inside[..., None]
    return to_residual(rows.to(dt), partial=True)


def vocab_offset(params, cfg) -> int:
    """The first vocabulary row of the LM head ``params`` holds (0: the
    whole vocabulary; else this rank's ``model`` block)."""
    w = (params["embed"]["tok"] if cfg.tie_embeddings
         else params["lm_head"]["w"].T)
    if w.shape[0] == cfg.vocab_size:
        return 0
    return par.model_axis().index * w.shape[0]


def logits_apply(params, x, cfg):
    """Final norm + LM head (tied or untied): x whole along its sequence
    -> the logits of the vocabulary rows the head holds (all of them, or
    this rank's block: :func:`vocab_offset`)."""
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["tok"].to(cdtype(cfg)).T
    else:
        logits = x @ params["lm_head"]["w"].to(cdtype(cfg))
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits
