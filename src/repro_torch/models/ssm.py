"""Mamba-2 (SSD — state-space duality) mixer.

The counterpart of ``repro.models.ssm``.  Prefill uses the chunked dual
form (:func:`ssd_chunked`), where the SSD kernel runs: on a CUDA tensor it
launches ``repro_torch.kernels.ssd_scan`` (one launch per sequence, the
state carried across chunks inside the kernel; in training its autograd
Function, whose backward is the hand-written backward kernel); on the CPU
it is the plain port of the JAX function, which autograd differentiates.  Decode is the O(1) recurrent update, in plain
torch on every device.

Tensor parallelism (``models.layers``): ``in_proj``'s ``model`` block is
a contiguous slice of the fused (z, x, B, C, dt) columns, not aligned to
the heads, so its column-parallel product is all-gathered over ``model``
and each rank takes its heads' z, x and dt and the shared B and C; the
depthwise conv runs on the rank's block of its channels (``conv_w``'s
block, the same trap) and is gathered likewise.  The SSD scan runs on the
rank's heads (all of them where the axis does not divide the heads), the
gated norm sums its squares over ``model``, and ``out_proj`` is
row-parallel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import layers
from repro_torch.models.layers import cdtype, dense_param
from repro_torch.parallel import api as par
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


def _head_block(cfg, first=None, n=None):
    """(first head, heads) this rank computes: its block of the heads
    where the ``model`` axis divides them (or the state's block,
    ``first`` and ``n``), else all of them."""
    H = cfg.n_ssm_heads
    if first is not None:
        return first, n
    ax = par.model_axis()
    if ax is None or H % ax.size:
        return 0, H
    return ax.index * (H // ax.size), H // ax.size


def _split_zxbcdt(p, x, cfg, h0=0, hl=None):
    """(z of the heads h0 .. h0 + hl, the conv's input whole, dt_raw of
    those heads): ``in_proj``'s product (its column blocks all-gathered
    over ``model``)."""
    dt_ = cdtype(cfg)
    d_in, Pd = cfg.d_inner, cfg.ssm_headdim
    G, N, H = cfg.ssm_ngroups, cfg.ssm_state, cfg.n_ssm_heads
    hl = H if hl is None else hl
    zxbcdt = layers.columns(x @ p["in_proj"].to(dt_), 2 * d_in + 2 * G * N
                            + H)
    z = zxbcdt[..., h0 * Pd:(h0 + hl) * Pd]
    rest = zxbcdt[..., d_in:2 * d_in + 2 * G * N]
    dt_raw = zxbcdt[..., 2 * d_in + 2 * G * N + h0:][..., :hl]
    return z, rest, dt_raw


def _conv_whole(p, hist, cfg, conv):
    """``conv`` (``causal_conv`` or the decode step's product) of the
    conv input ``hist`` (whole) by ``conv_w`` and ``conv_b``, SiLU'd, on
    the rank's block of the channels (``conv_w``'s), gathered whole."""
    dt_ = cdtype(cfg)
    conv_dim = hist.shape[-1]
    w = p["conv_w"].to(dt_)
    c = w.shape[1]
    out = F.silu(conv(layers.channel_block(hist, conv_dim, c), w,
                      layers.channel_block(p["conv_b"], conv_dim, c)
                      .to(dt_)))
    return layers.columns(out, conv_dim)


def _gated_norm(y, z, p, cfg, h0, hl):
    """``rms_norm(y * silu(z))`` over d_inner of the heads' channels
    ``y``, ``z``: the squares summed over ``model`` where the rank holds
    a block of the heads."""
    if hl == cfg.n_ssm_heads:
        return layers.rms_norm(y * F.silu(z), p["gate_norm"]["scale"],
                               cfg.norm_eps)
    Pd = cfg.ssm_headdim
    t = y * F.silu(z)
    t32 = t.float()
    var = coll.all_reduce(t32.square().sum(-1, keepdim=True),
                          par.model_axis().group) / cfg.d_inner
    scale = p["gate_norm"]["scale"][h0 * Pd:(h0 + hl) * Pd]
    return (t32 * torch.rsqrt(var + cfg.norm_eps)
            * (1.0 + scale.float())).to(t.dtype)


def _groups(t, cfg, h0, hl):
    """The groups (of B or C, (..., G, N)) the heads h0 .. h0 + hl read."""
    G, H = cfg.ssm_ngroups, cfg.n_ssm_heads
    if hl == H:
        return t
    per = H // G
    return t[..., h0 // per:(h0 + hl - 1) // per + 1, :]


def ssd_chunked(x, dt, A, Bm, Cm, chunk):
    """Chunked SSD scan.

    x: (B,S,H,P)  dt: (B,S,H) f32  A: (H,) negative  Bm/Cm: (B,S,G,N)
    (group form — heads within a group share B/C).
    Returns (y (B,S,H,P), final_state (B,H,N,P))."""
    return ssd_ops.ssd_scan(x.contiguous(), dt.contiguous(), A.contiguous(),
                            Bm.contiguous(), Cm.contiguous(), chunk=chunk)


def ssm_apply_train(p, x, cfg, return_state=False):
    """x: the residual stream (normed) -> its update [+ (state of the
    rank's heads, conv_tail) when return_state]."""
    dt_ = cdtype(cfg)
    d_in = cfg.d_inner
    G, N, H, Pd = cfg.ssm_ngroups, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_headdim
    x = layers.seq_gather(x)
    h0, hl = _head_block(cfg)
    z, rest, dt_raw = _split_zxbcdt(p, x, cfg, h0, hl)
    conv_out = _conv_whole(p, rest, cfg, causal_conv)
    xs = conv_out[..., h0 * Pd:(h0 + hl) * Pd]
    Bm = conv_out[..., d_in:d_in + G * N]
    Cm = conv_out[..., d_in + G * N:]
    B_, S, _ = x.shape
    xh = xs.reshape(B_, S, hl, Pd)
    # group form; broadcast inside ssd_chunked
    Bg = _groups(Bm.reshape(B_, S, G, N), cfg, h0, hl)
    Cg = _groups(Cm.reshape(B_, S, G, N), cfg, h0, hl)
    heads = slice(h0, h0 + hl)
    dt = softplus(dt_raw.float() + p["dt_bias"][heads])
    A = -torch.exp(p["A_log"][heads])
    y, state = ssd_chunked(xh, dt, A, Bg, Cg, cfg.ssm_chunk)
    y = y + xh * p["D_skip"][heads].to(dt_)[None, None, :, None]
    y = y.reshape(B_, S, hl * Pd)
    y = _gated_norm(y, z, p, cfg, h0, hl)
    out = layers.row_linear(y, p["out_proj"], dt_, d_in)
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

    ``heads`` (the first head): ``state`` is this rank's block of the
    heads (``cache_sharding`` splits them over ``model``, as tensor
    parallelism does): each rank updates its own heads, the gated norm
    sums its squares over ``model`` and ``out_proj`` is row-parallel."""
    dt_ = cdtype(cfg)
    d_in = cfg.d_inner
    G, N, H, Pd = cfg.ssm_ngroups, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_headdim
    h0, hl = _head_block(cfg, *((heads, state.shape[1]) if heads is not None
                                else ()))
    z, rest, dt_raw = _split_zxbcdt(p, x, cfg, h0, hl)  # rest: (B, conv)
    hist = torch.cat([conv_buf, rest[:, None, :]], dim=1)  # (B,K,conv)
    conv_out = _conv_whole(p, hist, cfg, lambda u, w, b: torch.einsum(
        "bkc,kc->bc", u, w) + b)
    new_buf = hist[:, 1:, :]
    xs = conv_out[..., h0 * Pd:(h0 + hl) * Pd]
    Bm = conv_out[..., d_in:d_in + G * N]
    Cm = conv_out[..., d_in + G * N:]
    B_ = x.shape[0]
    xh = xs.reshape(B_, hl, Pd)
    rep = H // G
    h = slice(h0, h0 + hl)
    Bh = Bm.reshape(B_, G, N).repeat_interleave(rep, dim=1)[:, h].float()
    Ch = Cm.reshape(B_, G, N).repeat_interleave(rep, dim=1)[:, h].float()
    dt = softplus(dt_raw.float() + p["dt_bias"][h])  # (B,hl)
    A = -torch.exp(p["A_log"][h])
    dA = torch.exp(dt * A)  # (B,hl)
    state = state * dA[..., None, None] + torch.einsum(
        "bhn,bhp->bhnp", Bh * dt[..., None], xh.float())
    y = torch.einsum("bhn,bhnp->bhp", Ch, state).to(dt_)
    y = y + xh * p["D_skip"][h].to(dt_)[None, :, None]
    y = _gated_norm(y.reshape(B_, hl * Pd), z, p, cfg, h0, hl)
    out = layers.row_linear(y, p["out_proj"], dt_, d_in)
    return out, state, new_buf
