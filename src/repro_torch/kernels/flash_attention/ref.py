"""Plain-torch version of the flash-attention kernel's function.

:func:`flash_attention_ref` is the blockwise online softmax of the Pallas
kernel ``repro.kernels.flash_attention.flash_attention`` (q scaled before
the dot, f32 statistics and ``p``, masked scores at -1e30 and ``p``
zeroed where masked, the causal upper bound and the window's lower bound
on the visited KV blocks, output divided by ``max(l, 1e-30)``), over the
CUDA kernel's 64 x 64 tiles.  It is the CPU path of
:func:`repro_torch.kernels.flash_attention.ops.flash_attention` and what
``chip_smoke.py`` holds the CUDA kernel to.

Layouts: q (B,S,H,Dk), k (B,S,KV,Dk), v (B,S,KV,Dv) -> (B,S,H,Dv); query
head h reads KV head h // (H // KV).

:func:`flash_attention_bwd_ref` is the plain backward: autograd of
:func:`flash_attention_ref`, what ``chip_smoke.py`` holds the backward
kernels (``csrc/flash_attention_bwd.cu``) to.
"""
from __future__ import annotations

import torch

NEG = -1e30
#: query and KV tile rows, the CUDA kernel's kBQ and kBK
BQ = BK = 64


def flash_attention_ref(q, k, v, *, causal=True, window=0):
    """Blockwise attention over (BQ, BK) tiles; returns q's dtype.

    A ragged last tile (S not a multiple of the tile) is masked, as the
    CUDA kernel masks it."""
    B, S, H, Dk = q.shape
    KV = k.shape[2]
    Dv = v.shape[-1]
    G = H // KV
    bq, bk = min(BQ, S), min(BK, S)
    nq, nk = -(-S // bq), -(-S // bk)
    dev = q.device
    qf = q.float().reshape(B, S, KV, G, Dk) * (Dk ** -0.5)
    kf, vf = k.float(), v.float()
    out = torch.empty((B, S, KV, G, Dv), dtype=torch.float32, device=dev)
    for qi in range(nq):
        q0 = qi * bq
        qblk = qf[:, q0:q0 + bq]
        qpos = torch.arange(q0, q0 + qblk.shape[1], device=dev)
        ub = min(-(-(q0 + bq) // bk), nk) if causal else nk
        lo = max(q0 // bk - (-(-window // bk)), 0) if window > 0 else 0
        shape = qblk.shape[:-1]
        m = torch.full(shape, NEG, dtype=torch.float32, device=dev)
        l = torch.zeros(shape, dtype=torch.float32, device=dev)
        acc = torch.zeros((*shape, Dv), dtype=torch.float32, device=dev)
        for j in range(lo, ub):
            k0 = j * bk
            kblk, vblk = kf[:, k0:k0 + bk], vf[:, k0:k0 + bk]
            kpos = torch.arange(k0, k0 + kblk.shape[1], device=dev)
            s = torch.einsum("bqkgd,bckd->bqkgc", qblk, kblk)
            ok = torch.ones((qpos.numel(), kpos.numel()), dtype=torch.bool,
                            device=dev)
            if causal:
                ok = kpos[None, :] <= qpos[:, None]
            if window > 0:
                ok = ok & (qpos[:, None] - kpos[None, :] < window)
            ok = ok[None, :, None, None, :]
            s = torch.where(ok, s, NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqkgc,bckd->bqkgd", p, vblk)
            m = m_new
        out[:, q0:q0 + bq] = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, S, H, Dv).to(q.dtype)


def flash_attention_bwd_ref(q, k, v, dout, *, causal=True, window=0):
    """(dq, dk, dv) of :func:`flash_attention_ref` given the output's
    gradient ``dout``, by autograd; each in its input's dtype."""
    with torch.enable_grad():
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        out = flash_attention_ref(q, k, v, causal=causal, window=window)
        return torch.autograd.grad(out, (q, k, v), dout)
