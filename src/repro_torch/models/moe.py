"""Mixture-of-Experts layer (top-k routing, switch-style aux loss).

The counterpart of ``repro.models.moe`` on one card: its mesh-less
branch, ``_moe_dense`` (every expert on every token, masked combine).
The expert-parallel branch (``_ep_body`` under ``shard_map``) needs a
device mesh and is not carried over.  The expert products are plain
einsums in the JAX package, outside any Pallas kernel, and stay plain
torch here on every device.

Expert selection: ``jax.lax.top_k`` returns the lower index first among
tied probabilities, and ``torch.topk`` promises no order on ties, so the
experts are taken from a stable descending sort.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.layers import cdtype, dense_param


def moe_init(gen, cfg, device):
    D, E, Fd = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = {
        "router": dense_param(gen, (D, E), D, device),
        "wi": dense_param(gen, (E, D, Fd), D, device),
        "wo": dense_param(gen, (E, Fd, D), Fd, device),
    }
    if cfg.gated_mlp:
        p["wg"] = dense_param(gen, (E, D, Fd), D, device)
    if cfg.n_shared_experts:
        p["shared"] = layers.mlp_init(gen, D, Fd * cfg.n_shared_experts,
                                      cfg.gated_mlp, device)
    return p


def _expert_ffn(x2d, wi, wg, wo, cfg):
    """Every expert on every token: x2d (N, D), weights (E, D, F) /
    (E, F, D) -> (E, N, D), as products batched over the experts with x2d
    broadcast (no weight is permuted or copied but for its cast).  Each
    weight is cast where it is used, so one expert tensor's cast is alive
    at a time."""
    dt = cdtype(cfg)
    act = layers.activation_fn(cfg.activation)
    xe = x2d.expand(wi.shape[0], *x2d.shape)
    h = act(torch.bmm(xe, wi.to(dt)))
    if wg is not None:
        h = h * torch.bmm(xe, wg.to(dt))
    return torch.bmm(h, wo.to(dt))


def top_k(probs, k: int):
    """``jax.lax.top_k`` along the last axis: the k largest values, ties
    in index order."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_dense(x2d, gates, idx, p, cfg):
    """All experts on all tokens, masked combine."""
    E = cfg.n_experts
    y_all = _expert_ffn(x2d, p["wi"], p["wg"] if "wg" in p else None,
                        p["wo"], cfg)  # (E, N, D)
    combine = torch.zeros((x2d.shape[0], E), dtype=torch.float32,
                          device=x2d.device)
    for j in range(cfg.experts_per_token):
        combine += F.one_hot(idx[:, j], E).float() * gates[:, j:j + 1]
    return torch.einsum("ne,end->nd", combine.to(y_all.dtype), y_all)


def moe_apply(p, x, cfg):
    """x: (B, S, D) -> (out (B,S,D), aux_loss scalar float32)."""
    dt = cdtype(cfg)
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = top_k(probs, k)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)

    # load-balance aux (switch-style): E * sum_e f_e * P_e
    f = torch.zeros((E,), dtype=torch.float32, device=x.device)
    for j in range(k):
        f += F.one_hot(idx[..., j].reshape(-1), E).float().mean(0)
    f = f / k
    pm = probs.reshape(-1, E).mean(0)
    aux = E * torch.sum(f * pm) * cfg.router_aux_weight

    out = _moe_dense(x.reshape(-1, D), gates.reshape(-1, k),
                     idx.reshape(-1, k), p, cfg).reshape(B, S, D)
    if cfg.n_shared_experts:
        out = out + layers.mlp_apply(p["shared"], x, cfg)
    return out.to(dt), aux
