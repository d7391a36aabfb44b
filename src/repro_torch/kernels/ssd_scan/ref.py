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
(``csrc/ssd_scan_bwd.cu``, ``csrc/ssd_scan_bwd_tc.cu``) to.
:func:`ssd_scan_bwd_chunked` computes the same gradients by the
tensor-core backward's decomposition (each chunk's own state gradient,
the elementwise reverse pass, each chunk's gradients from its outgoing
state's), in plain torch.
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


def ssd_scan_bwd_chunked(x, dt, A, Bm, Cm, dy, dstate=None, *, chunk):
    """(dx, ddt, dA, dBm, dCm) of :func:`ssd_scan_ref` given ``dy`` and
    the final state's ``dstate`` (None: unused), by the decomposition of
    ``csrc/ssd_scan_bwd_tc.cu``; each in its input's dtype.  Per chunk of
    Q rows, head h, with seg = cumsum(dt A), e = e^seg, L_qk = e^(seg_q -
    seg_k) (k <= q), d_k = e^(total - seg_k), the incoming state s:

    1. U_c = (C * bf16(e))^T dy, the chunk's own state gradient;
    2. the reverse pass dS'_{c-1} = e^total_c dS'_c + U_c from dS' =
       dstate, dS'_c the gradient of chunk c's outgoing state;
    3. from dS'_c alone, G = dy x^T, w = C.B L dt_k, dcb = G L dt_k:
       dx = bf16(w)^T dy + d dt B dS', dB = dcb^T C + d dt dS' x, dC = dcb
       B + bf16(e) s dy, and d(seg) = e C.(s dy) + rowsum(w G) -
       colsum(w G) - R (R = d dt B.(dS' x); the last row adds e^total
       s.dS' + sum R), reverse-cumsummed into da: ddt = colsum(C.B L G) +
       d B.(dS' x) + A da, dA = sum da dt.

    bf16(.) rounds to x's dtype where the forward rounds (the identity in
    float32); every other quantity is float32."""
    f32 = torch.float32
    Bsz, S, H, Pd = x.shape
    G = Bm.shape[2]
    hg = H // G
    Q = min(chunk, S)
    nc = -(-S // Q)

    def rnd(t):
        return t.to(x.dtype).to(f32)

    xf, dyf, dtf = x.to(f32), dy.to(f32), dt.to(f32)
    Bh = Bm.to(f32).repeat_interleave(hg, dim=2)     # (B,S,H,N)
    Ch = Cm.to(f32).repeat_interleave(hg, dim=2)
    rows = [slice(c * Q, min(S, (c + 1) * Q)) for c in range(nc)]
    seg = [torch.cumsum(dtf[:, r] * A, dim=1) for r in rows]   # (B,q,H)
    # the forward's incoming states
    s_in, s = [], torch.zeros((Bsz, H, Bh.shape[3], Pd), dtype=f32,
                              device=x.device)
    for r, sg in zip(rows, seg):
        s_in.append(s)
        wk = torch.exp(sg[:, -1:] - sg) * dtf[:, r]
        s = s * torch.exp(sg[:, -1])[..., None, None] + torch.einsum(
            "bqhn,bqh,bqhp->bhnp", Bh[:, r], wk, xf[:, r])
    # 1, 2: each chunk's own state gradient, the reverse pass
    dS = [None] * nc
    dS[-1] = (torch.zeros_like(s) if dstate is None
              else dstate.to(f32))
    for c in range(nc - 1, 0, -1):
        r, sg = rows[c], seg[c]
        U = torch.einsum("bqhn,bqh,bqhp->bhnp", Ch[:, r], rnd(torch.exp(sg)),
                         dyf[:, r])
        dS[c - 1] = dS[c] * torch.exp(sg[:, -1])[..., None, None] + U
    # 3: each chunk's gradients from its outgoing state's
    dx, ddt, dB, dC = (torch.zeros_like(t) for t in (xf, dtf, Bh, Ch))
    dA = torch.zeros_like(A, dtype=f32)
    for c, (r, sg) in enumerate(zip(rows, seg)):
        q = sg.shape[1]
        xq, yq, bq, cq, dq = xf[:, r], dyf[:, r], Bh[:, r], Ch[:, r], dtf[:, r]
        mask = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                     device=x.device))
        diff = (sg[:, :, None] - sg[:, None, :]).permute(0, 3, 1, 2)
        L = torch.exp(diff.masked_fill(~mask, -float("inf")))  # (B,H,q,k)
        dtk = dq.transpose(1, 2)[:, :, None, :]                 # (B,H,1,k)
        e = torch.exp(sg)
        d = torch.exp(sg[:, -1:] - sg)                          # (B,q,H)
        Gm = torch.einsum("bqhp,bkhp->bhqk", yq, xq)
        cbL = torch.einsum("bqhn,bkhn->bhqk", cq, bq) * L
        w = cbL * dtk
        dcb = Gm * L * dtk
        u = torch.einsum("bhnp,bkhp->bkhn", dS[c], xq)          # dS' x
        bu = (bq * u).sum(-1)                                   # (B,k,H)
        ddk = (d * dq)[..., None]
        dx[:, r] = (torch.einsum("bhqk,bqhp->bkhp", rnd(w), yq)
                    + ddk * torch.einsum("bkhn,bhnp->bkhp", bq, dS[c]))
        dB[:, r] = torch.einsum("bhqk,bqhn->bkhn", dcb, cq) + ddk * u
        v = torch.einsum("bhnp,bqhp->bqhn", s_in[c], yq)        # s dy
        dC[:, r] = (torch.einsum("bhqk,bkhn->bqhn", dcb, bq)
                    + rnd(e)[..., None] * v)
        wG = w * Gm
        R = d * dq * bu
        dseg = (e * (cq * v).sum(-1) + wG.sum(3).transpose(1, 2)
                - wG.sum(2).transpose(1, 2) - R)
        dseg[:, -1] += (torch.exp(sg[:, -1]) * (s_in[c] * dS[c]).sum((2, 3))
                        + R.sum(1))
        da = torch.flip(torch.cumsum(torch.flip(dseg, [1]), 1), [1])
        ddt[:, r] = (cbL * Gm).sum(2).transpose(1, 2) + d * bu + A * da
        dA = dA + (da * dq).sum((0, 1))
    dBm = dB.reshape(Bsz, S, G, hg, -1).sum(3)
    dCm = dC.reshape(Bsz, S, G, hg, -1).sum(3)
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA.to(A.dtype),
            dBm.to(Bm.dtype), dCm.to(Cm.dtype))
