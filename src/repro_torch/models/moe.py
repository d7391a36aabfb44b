"""Mixture-of-Experts layer (top-k routing, switch-style aux loss).

The counterpart of ``repro.models.moe``, with both its branches:

* ``_moe_dense`` (no mesh, or one whose ``model`` axis does not split the
  experts): every expert on every token, masked combine;
* expert parallelism under a mesh whose ``model`` axis (``ep``) is larger
  than 1 and divides the experts: each EP peer takes the top-``capacity``
  tokens of each of its ``E / ep`` experts by assignment weight (capacity
  dropping), runs their FFNs, scatter-adds the weighted outputs, and the
  sum over the EP peers is the layer's output.  On the ranks of a
  ``DeviceMesh`` (``parallel.api.mesh_context``) each rank is a peer on
  its own tokens with its own experts, their blocks cast to the compute
  dtype and gathered over the ``data`` axis (``parallel.api.shard_module``,
  as the reference casts them and its ``shard_map`` takes them whole by
  ``P(ep)``).  Its tokens are the reference's ``_ep_body``'s: the
  residual stream's sequence gathered over ``model`` before the layer
  (capacity dropping depends on that set), and the sum over the peers
  (the reference's ``psum``) is the reduce-scatter of the rank's share,
  with the shared experts' (column- and row-parallel), back into the
  stream's sequence blocks (an all-reduce where the sequence does not
  split: ``models.layers.to_residual``).  In one
  process under a mapping of axis sizes, :func:`moe_ep_plain` computes
  what the group computes, peer by peer.  Capacity dropping makes this
  another function than the dense branch.

The expert products are plain einsums in the JAX package, outside any
Pallas kernel, and stay plain torch here on every device.  The
load-balance statistics are means over the global batch: under a mesh,
sums over the data-parallel ranks before any division or product.

Expert selection: ``jax.lax.top_k`` returns the lower index first among
tied values, and ``torch.topk`` promises no order on ties, so the
experts (and each expert's tokens) are taken from a stable descending
sort.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.layers import cdtype, dense_param
from repro_torch.parallel import api as par


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


def _expert_ffn(xg, wi, wg, wo, cfg):
    """xg (E, N, D) tokens per expert, weights (E, D, F) / (E, F, D) ->
    (E, N, D), as products batched over the experts.  Each weight is cast
    where it is used, so one expert tensor's cast is alive at a time."""
    dt = cdtype(cfg)
    act = layers.activation_fn(cfg.activation)
    h = act(torch.bmm(xg, wi.to(dt)))
    if wg is not None:
        h = h * torch.bmm(xg, wg.to(dt))
    return torch.bmm(h, wo.to(dt))


def top_k(probs, k: int):
    """``jax.lax.top_k`` along the last axis: the k largest values, ties
    in index order."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _capacity(n_tokens: int, cfg) -> int:
    c = int(cfg.capacity_factor * n_tokens * cfg.experts_per_token
            / cfg.n_experts)
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def _moe_dense(x2d, gates, idx, p, cfg):
    """All experts on all tokens, masked combine (x2d broadcast over the
    experts: no weight is permuted or copied but for its cast)."""
    E = cfg.n_experts
    y_all = _expert_ffn(x2d.expand(E, *x2d.shape), p["wi"],
                        p["wg"] if "wg" in p else None, p["wo"],
                        cfg)  # (E, N, D)
    combine = torch.zeros((x2d.shape[0], E), dtype=torch.float32,
                          device=x2d.device)
    for j in range(cfg.experts_per_token):
        combine += F.one_hot(idx[:, j], E).float() * gates[:, j:j + 1]
    return torch.einsum("ne,end->nd", combine.to(y_all.dtype), y_all)


def _ep_peer(x2d, g2d, i2d, wi, wg, wo, cfg, e0, capacity):
    """One EP peer (the reference's ``_ep_body`` but for its ``psum``):
    its experts e0 .. e0 + E_loc (``wi``, ``wg``, ``wo``, cast to the
    compute dtype) on the tokens x2d (N, D) (``g2d``, ``i2d`` their gates
    and experts): for each expert, the top-``capacity`` tokens by
    assignment weight, their FFN, the weighted outputs scatter-added ->
    this peer's (N, D) share of the output."""
    n, D = x2d.shape
    e_loc = wi.shape[0]
    dt = cdtype(cfg)
    # per-token assignment weight for each local expert: (N, E_loc)
    rel = i2d - e0
    in_range = (rel >= 0) & (rel < e_loc)
    assign = torch.zeros((n, e_loc), dtype=torch.float32, device=x2d.device)
    for j in range(cfg.experts_per_token):
        oh = F.one_hot(torch.where(in_range[:, j], rel[:, j], e_loc),
                       e_loc + 1).float()[:, :e_loc]
        assign = assign + oh * g2d[:, j:j + 1]
    # capacity selection: top-C tokens per expert by gate weight
    vals, tok = top_k(assign.T, capacity)  # (E_loc, C)
    xg = x2d[tok.reshape(-1)].reshape(e_loc, capacity, D)
    y = _expert_ffn(xg, wi, wg, wo, cfg) \
        * (vals.to(dt) * (vals > 0.0).to(dt))[..., None]
    return torch.zeros((n, D), dtype=y.dtype, device=x2d.device).index_add(
        0, tok.reshape(-1), y.reshape(-1, D))


def ep_size(cfg, axes) -> int:
    """The EP group's size under the mesh axes ``axes`` (a mapping; None:
    no mesh): its ``model`` axis when that is larger than 1 and divides
    the experts, else 1 (the dense branch)."""
    ep = (axes or {}).get("model", 1)
    return ep if ep > 1 and cfg.n_experts % ep == 0 else 1


def moe_ep_plain(x, gates, idx, p, cfg, mesh_axes):
    """What the EP group of a mesh of ``mesh_axes`` computes, in one
    process: x (B, S, D) the global batch, split into its data-parallel
    slices as the batch is; each slice's output the sum over the EP peers
    of :func:`_ep_peer` (peer m runs experts m E_loc .. (m + 1) E_loc,
    the weights cast before they are split, as the reference casts them
    before its ``shard_map``)."""
    dt = cdtype(cfg)
    B, S, D = x.shape
    k = cfg.experts_per_token
    ep, dp = ep_size(cfg, mesh_axes), par.dp_size(mesh_axes)
    if B % dp:
        raise ValueError(f"a batch of {B} does not split over {dp} ranks")
    e_loc = cfg.n_experts // ep
    n_loc = B * S // dp
    cap = min(_capacity(n_loc, cfg), n_loc)
    w = {name: p[name].to(dt) for name in ("wi", "wg", "wo") if name in p}
    outs = []
    for xs, gs, is_ in zip(x.reshape(dp, n_loc, D),
                           gates.reshape(dp, n_loc, k),
                           idx.reshape(dp, n_loc, k)):
        peers = [_ep_peer(xs, gs, is_,
                          *(w[name][m * e_loc:(m + 1) * e_loc]
                            if name in w else None
                            for name in ("wi", "wg", "wo")),
                          cfg, m * e_loc, cap) for m in range(ep)]
        outs.append(torch.stack(peers).sum(0))
    return torch.cat(outs).reshape(B, S, D)


def _moe_ep(x, gates, idx, p, cfg, ranks):
    """This rank's EP peer on its tokens: ``p``'s experts are its own,
    cast and gathered whole over the ``data`` axis
    (``parallel.api.shard_module``); its share of the peers' sum (the
    caller sums it over the ``model`` group)."""
    B, S, D = x.shape
    k = cfg.experts_per_token
    n = B * S
    cap = min(_capacity(n, cfg), n)
    out = _ep_peer(x.reshape(n, D), gates.reshape(n, k), idx.reshape(n, k),
                   p["wi"], p["wg"] if "wg" in p else None, p["wo"], cfg,
                   ranks.coord["model"] * p["wi"].shape[0], cap)
    return out.reshape(B, S, D)


def _batch_mean(t):
    """The mean over dim 0 across the data-parallel ranks (each holding
    as many rows)."""
    ranks = par.current_ranks()
    if ranks is None:
        return t.mean(0)
    return par.dp_sum(t.sum(0)) / (t.shape[0] * par.dp_size(ranks))


def moe_apply(p, x, cfg):
    """x: the residual stream (normed; (B, S, D) in one process) -> (its
    update, aux_loss scalar float32)."""
    dt = cdtype(cfg)
    x = layers.seq_gather(x)
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = top_k(probs, k)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)

    # load-balance aux (switch-style): E * sum_e f_e * P_e
    f = torch.zeros((E,), dtype=torch.float32, device=x.device)
    for j in range(k):
        f += _batch_mean(F.one_hot(idx[..., j].reshape(-1), E).float())
    f = f / k
    pm = _batch_mean(probs.reshape(-1, E))
    aux = E * torch.sum(f * pm) * cfg.router_aux_weight

    axes = par.current_mesh()
    ranks = par.current_ranks()
    ax = par.model_axis()
    if ep_size(cfg, axes) > 1 and ranks is not None:
        out = _moe_ep(x, gates, idx, p, cfg, ranks)
    elif ep_size(cfg, axes) > 1:
        out = moe_ep_plain(x, gates, idx, p, cfg, axes)
    else:
        out = _moe_dense(x.reshape(-1, D), gates.reshape(-1, k),
                         idx.reshape(-1, k), p, cfg).reshape(B, S, D)
        if ax is not None:      # whole on every rank: one rank's share
            out = out * float(ax.index == 0)
    if cfg.n_shared_experts:
        out = out + layers.mlp_apply(
            p["shared"], x, cfg, cfg.moe_d_ff * cfg.n_shared_experts,
            partial=True)
    return layers.to_residual(out.to(dt), partial=True), aux
