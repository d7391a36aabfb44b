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
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

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


def mlp_apply(p, x, cfg):
    dt = cdtype(cfg)
    act = activation_fn(cfg.activation)
    h = act(x @ p["wi"].to(dt))
    if "wg" in p:
        h = h * (x @ p["wg"].to(dt))
    return h @ p["wo"].to(dt)


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
    # gather, then cast: the same values as casting the whole table first
    return embedding[tokens].to(cdtype(cfg))


def logits_apply(params, x, cfg):
    """Final norm + LM head (tied or untied)."""
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["tok"].to(cdtype(cfg)).T
    else:
        logits = x @ params["lm_head"]["w"].to(cdtype(cfg))
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits
