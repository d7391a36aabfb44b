"""Mamba-2 (SSD — state-space duality) mixer.

The counterpart of ``repro.models.ssm``.  Prefill uses the chunked dual
form (:func:`ssd_chunked`), where the SSD kernel runs: on a CUDA tensor it
launches ``repro_torch.kernels.ssd_scan`` (one launch per sequence, the
state carried across chunks inside the kernel; in training its autograd
Function, whose backward is the hand-written backward kernel); on the CPU
it is the plain port of the JAX function, which autograd differentiates.  Decode is the O(1) recurrent update, in plain
torch on every device.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import layers
from repro_torch.models.layers import cdtype, dense_param
from repro_torch.parallel import collectives as coll


def softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) = log1p(e^-|x|) + max(x, 0)."""
    return torch.log1p(torch.exp(-x.abs())) + x.clamp_min(0)


def ssm_init(gen, cfg, device):
    D = cfg.d_model
    d_in = cfg.d_inner
    G, N, H = cfg.ssm_ngroups, cfg.ssm_state, cfg.n_ssm_heads
    conv_dim = d_in + 2 * G * N
    f32 = torch.float32
    in_proj = dense_param(gen, (D, 2 * d_in + 2 * G * N + H), D, device)
    conv_w = 0.1 * torch.randn((cfg.ssm_conv, conv_dim), generator=gen,
                               dtype=f32, device=device)
    u = torch.empty((H,), dtype=f32, device=device).uniform_(
        math.log(1e-3), math.log(1e-1), generator=gen)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_dim,), dtype=f32, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=f32,
                                          device=device)),
        "D_skip": torch.ones((H,), dtype=f32, device=device),
        "dt_bias": torch.log(torch.expm1(torch.exp(u))),
        "gate_norm": layers.norm_init(d_in, device),
        "out_proj": dense_param(gen, (d_in, D), d_in, device),
    }


def causal_conv(u, w, b):
    """Depthwise causal conv. u: (B,S,C), w: (K,C)."""
    K = w.shape[0]
    pad = F.pad(u, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + u.shape[1], :] * w[i] for i in range(K))
    return out + b


def _split_zxbcdt(p, x, cfg):
    dt_ = cdtype(cfg)
    d_in = cfg.d_inner
    G, N, H = cfg.ssm_ngroups, cfg.ssm_state, cfg.n_ssm_heads
    zxbcdt = x @ p["in_proj"].to(dt_)
    z = zxbcdt[..., :d_in]
    rest = zxbcdt[..., d_in:2 * d_in + 2 * G * N]
    dt_raw = zxbcdt[..., -H:]
    return z, rest, dt_raw


def ssd_chunked(x, dt, A, Bm, Cm, chunk):
    """Chunked SSD scan.

    x: (B,S,H,P)  dt: (B,S,H) f32  A: (H,) negative  Bm/Cm: (B,S,G,N)
    (group form — heads within a group share B/C).
    Returns (y (B,S,H,P), final_state (B,H,N,P))."""
    return ssd_ops.ssd_scan(x.contiguous(), dt.contiguous(), A.contiguous(),
                            Bm.contiguous(), Cm.contiguous(), chunk=chunk)


def ssm_apply_train(p, x, cfg, return_state=False):
    """x: (B,S,D) -> (B,S,D) [+ (state, conv_tail) when return_state]."""
    dt_ = cdtype(cfg)
    d_in = cfg.d_inner
    G, N, H, Pd = cfg.ssm_ngroups, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_headdim
    z, rest, dt_raw = _split_zxbcdt(p, x, cfg)
    conv_out = causal_conv(rest, p["conv_w"].to(dt_), p["conv_b"].to(dt_))
    conv_out = F.silu(conv_out)
    xs = conv_out[..., :d_in]
    Bm = conv_out[..., d_in:d_in + G * N]
    Cm = conv_out[..., d_in + G * N:]
    B_, S, _ = x.shape
    xh = xs.reshape(B_, S, H, Pd)
    Bg = Bm.reshape(B_, S, G, N)  # group form; broadcast inside ssd_chunked
    Cg = Cm.reshape(B_, S, G, N)
    dt = softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, state = ssd_chunked(xh, dt, A, Bg, Cg, cfg.ssm_chunk)
    y = y + xh * p["D_skip"].to(dt_)[None, None, :, None]
    y = y.reshape(B_, S, d_in)
    y = layers.rms_norm(y * F.silu(z), p["gate_norm"]["scale"], cfg.norm_eps)
    out = y @ p["out_proj"].to(dt_)
    if return_state:
        # pre-conv inputs, copied: a view would keep the whole in_proj
        # output alive in the cache
        conv_tail = rest[:, -(cfg.ssm_conv - 1):, :].clone()
        return out, (state, conv_tail)
    return out


def ssm_apply_decode(p, x, state, conv_buf, cfg, heads=None):
    """One-token decode.  x: (B,D); state: (B,H,N,P) f32;
    conv_buf: (B, K-1, conv_dim) pre-activation conv inputs.
    Returns (out, new state, new conv_buf) as new tensors.

    ``heads`` ((first head, group of ranks)): ``state`` is this rank's
    block of the heads (``cache_sharding`` splits them over ``model``);
    each rank updates its own heads and their outputs are gathered over
    the group before the gated norm, which mixes the heads."""
    dt_ = cdtype(cfg)
    d_in = cfg.d_inner
    G, N, H, Pd = cfg.ssm_ngroups, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_headdim
    z, rest, dt_raw = _split_zxbcdt(p, x, cfg)  # rest: (B, conv_dim)
    w = p["conv_w"].to(dt_)
    hist = torch.cat([conv_buf, rest[:, None, :]], dim=1)  # (B,K,conv)
    conv_out = torch.einsum("bkc,kc->bc", hist, w) + p["conv_b"].to(dt_)
    conv_out = F.silu(conv_out)
    new_buf = hist[:, 1:, :]
    xs = conv_out[..., :d_in]
    Bm = conv_out[..., d_in:d_in + G * N]
    Cm = conv_out[..., d_in + G * N:]
    B_ = x.shape[0]
    xh = xs.reshape(B_, H, Pd)
    rep = H // G
    Bh = Bm.reshape(B_, G, N).repeat_interleave(rep, dim=1).float()
    Ch = Cm.reshape(B_, G, N).repeat_interleave(rep, dim=1).float()
    dt = softplus(dt_raw.float() + p["dt_bias"])  # (B,H)
    A = -torch.exp(p["A_log"])
    D_skip = p["D_skip"]
    if heads is not None:
        h = slice(heads[0], heads[0] + state.shape[1])
        xh, Bh, Ch, dt, A, D_skip = (xh[:, h], Bh[:, h], Ch[:, h], dt[:, h],
                                     A[h], D_skip[h])
    dA = torch.exp(dt * A)  # (B,H)
    state = state * dA[..., None, None] + torch.einsum(
        "bhn,bhp->bhnp", Bh * dt[..., None], xh.float())
    y = torch.einsum("bhn,bhnp->bhp", Ch, state).to(dt_)
    y = y + xh * D_skip.to(dt_)[None, :, None]
    if heads is not None:
        y = torch.cat(coll.gather_blocks(y.contiguous(), heads[1]), dim=1)
    y = y.reshape(B_, d_in)
    y = layers.rms_norm(y * F.silu(z), p["gate_norm"]["scale"], cfg.norm_eps)
    out = y @ p["out_proj"].to(dt_)
    return out, state, new_buf
