"""Plain-torch version of the SSD scan kernel's function.

:func:`ssd_scan_ref` is the chunked dual form over a whole sequence in
the model's layout, the plain port of ``repro.models.ssm.ssd_chunked``:
group form (heads of a group share B/C and the (B,S,H,N) expansion is
never made), dt = 0 padding of a ragged last chunk, and the rounding of
``exp(seg)``, of the intra-chunk weights ``w`` and of ``y`` to x's dtype
(no-ops in float32, where it is the Pallas kernel ``ssd_chunk`` driven by
``ssd_scan_op``).  One departure, which changes no value of the forward:
the decay above the diagonal is masked inside its exponent, so that the
gradient stays finite where the reference's overflows (ROADMAP §3).  It
is the CPU path of :func:`repro_torch.kernels.ssd_scan.ops.ssd_scan` and
what ``chip_smoke.py`` holds the CUDA kernel to.
:func:`ssd_scan_bwd_ref` is the plain backward: autograd of
:func:`ssd_scan_ref`, what ``chip_smoke.py`` holds the backward kernels
(``csrc/ssd_scan_bwd.cu``) to.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ssd_scan_ref(x, dt, A, Bm, Cm, *, chunk):
    """x: (B,S,H,P)  dt: (B,S,H) f32  A: (H,) negative  Bm/Cm: (B,S,G,N).

    Returns (y (B,S,H,P) in x's dtype, final_state (B,H,N,P) f32)."""
    f32 = torch.float32
    Bsz, S, H, Pd = x.shape
    G = Bm.shape[2]
    hg = H // G
    N = Bm.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        # dt=0 padding is inert: decay 1, zero state/output contribution
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    nc = (S + pad) // Q

    def to_chunks(t):
        return t.reshape(Bsz, nc, Q, *t.shape[2:])

    xc, dtc, Bc, Cc = map(to_chunks, (x, dt, Bm, Cm))
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    state = torch.zeros((Bsz, H, N, Pd), dtype=f32, device=x.device)
    ys = []
    for c in range(nc):
        xq, dq, bq, cq = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c]
        dA = dq * A  # (B,Q,H) negative increments
        seg = torch.cumsum(dA, dim=1)
        segg = seg.reshape(Bsz, Q, G, hg)
        total = seg[:, -1]  # (B,H)
        state_g = state.reshape(Bsz, G, hg, N, Pd)
        # --- inter-chunk: contribution of the incoming state
        y_inter = torch.einsum(
            "bqgn,bqgh,bghnp->bqghp", cq.to(f32),
            torch.exp(segg).to(cq.dtype).to(f32), state_g
        ).reshape(Bsz, Q, H, Pd)
        # --- intra-chunk (quadratic in Q); cb computed once per group
        cb = torch.einsum("bqgn,bkgn->bgqk", cq.to(f32), bq.to(f32))
        # decay[b,h,q,k] = exp(seg_q - seg_k), 0 above the diagonal (masked
        # in the exponent: there seg_q - seg_k > 0 may overflow, and the
        # gradient of the overflowed exp would be 0 * inf, a NaN)
        diff = seg[:, :, None] - seg[:, None, :]
        decay = torch.exp(diff.masked_fill(~mask[None, :, :, None],
                                           -float("inf"))).permute(0, 3, 1, 2)
        decay = decay.reshape(Bsz, G, hg, Q, Q)
        dqh = dq.transpose(1, 2).reshape(Bsz, G, hg, 1, Q)
        w = torch.where(mask, cb[:, :, None] * decay * dqh, 0.0)
        xg = xq.reshape(Bsz, Q, G, hg, Pd)
        y_intra = torch.einsum("bghqk,bkghp->bqghp",
                               w.to(xq.dtype).to(f32), xg.to(f32)
                               ).reshape(Bsz, Q, H, Pd)
        # --- state update
        wk = torch.exp(total[:, None] - seg) * dq  # (B,Q,H)
        wkg = wk.reshape(Bsz, Q, G, hg)
        state = state * torch.exp(total)[..., None, None] + torch.einsum(
            "bqgn,bqgh,bqghp->bghnp", bq.to(f32), wkg, xg.to(f32)
        ).reshape(Bsz, H, N, Pd)
        ys.append((y_inter + y_intra).to(xq.dtype))
    y = torch.stack(ys, dim=1).reshape(Bsz, nc * Q, H, Pd)[:, :S]
    return y, state


def ssd_scan_bwd_ref(x, dt, A, Bm, Cm, dy, dstate=None, *, chunk):
    """(dx, ddt, dA, dBm, dCm) of :func:`ssd_scan_ref` given the output's
    gradient ``dy`` and the final state's ``dstate`` (None: unused), by
    autograd; each in its input's dtype."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (x, dt, A, Bm, Cm)]
        y, state = ssd_scan_ref(*ins, chunk=chunk)
        outs, grads = [y], [dy]
        if dstate is not None:
            outs.append(state)
            grads.append(dstate)
        return torch.autograd.grad(outs, ins, grads)
