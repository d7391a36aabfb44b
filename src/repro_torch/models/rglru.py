"""RG-LRU recurrent block (RecurrentGemma / Griffin).

The counterpart of ``repro.models.rglru``:

h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
a_t = exp(-c * softplus(Lambda) * r_t), with input gate i_t and recurrence
gate r_t.  Prefill uses a chunked linear scan (a log-depth scan within
each chunk, all chunks at once, then the carry across chunks); decode is
the O(1) update.  The JAX package computes both outside any Pallas
kernel, and they stay plain torch here on every device.

Tensor parallelism (``models.layers``): ``w_x`` and ``w_gate`` are
column-parallel over the channels, the conv and the scan run on the
rank's channels (both are per channel), the gates' leaves take the
rows of the rank's channels (their partial products reduce-scattered
over the channels), and ``out_proj`` is row-parallel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.layers import cdtype, dense_param
from repro_torch.models.ssm import causal_conv, softplus
from repro_torch.parallel import api as par
from repro_torch.parallel import collectives as coll

_C = 8.0


def lru_init(gen, cfg, device):
    D = cfg.d_model
    W = cfg.lru_width or D
    f32 = torch.float32
    return {
        "w_x": dense_param(gen, (D, W), D, device),
        "w_gate": dense_param(gen, (D, W), D, device),
        "conv_w": 0.1 * torch.randn((cfg.ssm_conv, W), generator=gen,
                                    dtype=f32, device=device),
        "conv_b": torch.zeros((W,), dtype=f32, device=device),
        "w_in_gate": dense_param(gen, (W, W), W, device),
        "b_in_gate": torch.zeros((W,), dtype=f32, device=device),
        "w_rec_gate": dense_param(gen, (W, W), W, device),
        "b_rec_gate": torch.zeros((W,), dtype=f32, device=device),
        # init so a ~ U(0.9, 0.999)-ish (griffin init)
        "lam": torch.log(torch.expm1(-torch.log(torch.linspace(
            0.9, 0.999, W, dtype=f32, device=device)) / _C)),
        "out_proj": dense_param(gen, (W, D), W, device),
    }


def _gate_in(u, w, b, dt, W):
    """``u @ w + b`` of the rank's channels: ``w``'s rows of them (its
    ``model`` block) give a share of every channel, reduce-scattered over
    the channels."""
    y = u @ w.to(dt)
    if w.shape[0] != W:
        y = coll.reduce_scatter(y, -1, par.model_axis().group)
    return y + layers.channel_block(b, W, y.shape[-1]).to(dt)


def _gates(p, u, cfg):
    dt = cdtype(cfg)
    W = p["lam"].shape[0]
    i = torch.sigmoid(_gate_in(u, p["w_in_gate"], p["b_in_gate"], dt, W))
    r = torch.sigmoid(_gate_in(u, p["w_rec_gate"], p["b_rec_gate"], dt, W))
    lam = layers.channel_block(p["lam"], W, u.shape[-1])
    log_a = -_C * softplus(lam)[None] * r.float()
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-6))
    b = beta * (i.float() * u.float())
    return log_a, b  # f32


def _scan_in_chunks(la, b):
    """Inclusive scan of the pairs (la, b) along axis 2 under the JAX
    ``combine`` ((la1, b1), (la2, b2)) -> (la1 + la2, e^la2 b1 + b2), in
    log2(Q) doubling steps (Hillis-Steele)."""
    Q = la.shape[2]
    d = 1
    while d < Q:
        la_prev, b_prev = la[:, :, :-d], b[:, :, :-d]
        b = torch.cat([b[:, :, :d],
                       torch.exp(la[:, :, d:]) * b_prev + b[:, :, d:]], dim=2)
        la = torch.cat([la[:, :, :d], la_prev + la[:, :, d:]], dim=2)
        d *= 2
    return la, b


def linear_scan(log_a, b, h0, chunk):
    """h_t = exp(log_a_t) * h_{t-1} + b_t.  log_a/b: (B,S,W) f32; h0: (B,W).
    Returns (h (B,S,W), h_last)."""
    B, S, W = b.shape
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        # log_a=0, b=0 padding is inert (h carried unchanged)
        log_a = F.pad(log_a, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
    nc = (S + pad) // Q
    la_s, b_s = _scan_in_chunks(log_a.reshape(B, nc, Q, W),
                                b.reshape(B, nc, Q, W))
    # each chunk's h a tensor of its own: the next chunk's product keeps
    # this chunk's last row for autograd, so it is not written in place
    hc, h = [], h0
    for c in range(nc):
        hc.append(b_s[:, c] + torch.exp(la_s[:, c]) * h[:, None, :])
        h = hc[-1][:, -1]
    h_full = torch.stack(hc, dim=1).reshape(B, S + pad, W)[:, :S]
    h_last = h_full[:, -1]  # last REAL step (padding holds h constant)
    return h_full, h_last


def lru_apply_train(p, x, cfg, return_state=False):
    """x: the residual stream (normed) -> its update [+ (h_last, conv
    tail), whole, when return_state]."""
    dt = cdtype(cfg)
    x = layers.seq_gather(x)
    B, S, D = x.shape
    W = cfg.lru_width or D
    u = x @ p["w_x"].to(dt)
    gate = x @ p["w_gate"].to(dt)
    c = u.shape[-1]
    u = causal_conv(u, p["conv_w"].to(dt),
                    layers.channel_block(p["conv_b"], W, c).to(dt))
    log_a, b = _gates(p, u, cfg)
    h0 = torch.zeros((B, c), dtype=torch.float32, device=x.device)
    h, h_last = linear_scan(log_a, b, h0, cfg.ssm_chunk)
    y = h.to(dt) * F.gelu(gate, approximate="tanh")
    out = layers.row_linear(y, p["out_proj"], dt, W)
    if return_state:
        # conv buffer keeps the last K-1 *pre-conv* inputs
        u_pre = x[:, -(cfg.ssm_conv - 1):, :] @ p["w_x"].to(dt)
        return out, (layers.columns(h_last, W), layers.columns(u_pre, W))
    return out


def lru_apply_decode(p, x, h, conv_buf, cfg):
    """x: (B,D); h: (B,W) f32; conv_buf: (B,K-1,W) pre-conv inputs.
    Returns (out, new h, new conv_buf) as new tensors (whole; the rank
    computes its channels)."""
    dt = cdtype(cfg)
    W = h.shape[-1]
    u_pre = layers.columns(x @ p["w_x"].to(dt), W)
    gate = x @ p["w_gate"].to(dt)
    c = gate.shape[-1]
    hist = torch.cat([conv_buf, u_pre[:, None, :]], dim=1)  # (B,K,W)
    u = torch.einsum("bkw,kw->bw", layers.channel_block(hist, W, c),
                     p["conv_w"].to(dt)) \
        + layers.channel_block(p["conv_b"], W, c).to(dt)
    new_buf = hist[:, 1:, :]
    log_a, b = _gates(p, u, cfg)
    h = torch.exp(log_a) * layers.channel_block(h, W, c) + b
    y = h.to(dt) * F.gelu(gate, approximate="tanh")
    out = layers.row_linear(y, p["out_proj"], dt, W)
    return out, layers.columns(h, W), new_buf
