"""Dispatching wrapper of blockwise attention: what
``repro_torch.models.attention.blocked_attention`` calls on the card.

``flash_attention(q, k, v, causal=, window=)`` computes the Pallas kernel
``repro.kernels.flash_attention``'s function.  A CPU tensor goes to the
plain-torch version (:func:`.ref.flash_attention_ref`); a CUDA tensor
launches one of two hand-written CUDA kernels (:mod:`.flash_attention`)
on the current stream, or raises — there is no fallback.  :func:`route`
picks the kernel from the dtype and the head widths alone:

* ``"sm90"`` — ``csrc/flash_attention_sm90.cu`` (TMA and wgmma): bfloat16
  with Dk and Dv multiples of 16, at most 256 (every width of the ported
  and planned model families: 64, 128, 192/128, 256);
* ``"scalar"`` — ``csrc/flash_attention.cu`` (scalar FMAs): float32 at
  any width, and bfloat16 at the widths ``"sm90"`` does not take (whole
  rows where they fit shared memory, Dv up to 256; above, the head
  dimensions in slices and blocks).

``launches`` counts the launches of both kernels and ``launches_sm90``
those of the tensor-core kernel (never plain-version calls); callers may
reset either to 0.

Training: where autograd records (grad enabled and an input that needs a
gradient), a CUDA call goes through :class:`FlashAttention`, whose
forward also writes each row's log-sum-exp and whose backward launches
the kernels :func:`route_bwd` picks (``launches_bwd`` counts those
backward calls, two kernels each, and ``launches_bwd_sm90`` those on the
tensor-core route):

* ``"sm90"`` — ``csrc/flash_attention_bwd_sm90.cu`` (TMA and wgmma):
  bfloat16 with Dk and Dv multiples of 16, at most 256 (the forward
  ``"sm90"`` route's widths);
* ``"scalar"`` — ``csrc/flash_attention_bwd.cu`` (scalar FMAs): float32,
  and bfloat16 at the widths ``"sm90"`` does not take, at any width
  (whole rows up to Dk, Dv 192; above, the head dimensions in slices and
  blocks).

The plain backward is autograd of :func:`.ref.flash_attention_ref`
(:func:`.ref.flash_attention_bwd_ref`).  A serving call passes no
log-sum-exp and its output is unchanged.

A meta tensor (shapes alone: the dry-run, ``repro_torch.launch``) goes to
:func:`flash_attention_meta`, one custom op standing for the card's
kernel, with :func:`flash_attention_bwd_meta` as its backward: so the
dry-run's counters see one attention call a layer, reading q, k, v and
writing o once, as the kernel does (``launch/cost.py`` prices it), and
not the plain version's blockwise temporaries, which the card never
makes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    DTYPES, flash_attention_bwd_cuda, flash_attention_bwd_sm90_cuda,
    flash_attention_cuda, flash_attention_sm90_cuda)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

#: CUDA kernel launches made by :func:`flash_attention` (a plain integer)
launches = 0
#: of which launches of the tensor-core kernel
launches_sm90 = 0
#: backward calls (a dq and a dk/dv kernel each) made by
#: :class:`FlashAttention`
launches_bwd = 0
#: of which on the tensor-core route
launches_bwd_sm90 = 0

#: the tensor-core kernel's widths: multiples of SM90_STEP up to SM90_MAX
#: (one wgmma k-step of bf16 is 16 wide; TMA rows are 16-byte multiples;
#: its accumulators hold 256 columns)
SM90_STEP, SM90_MAX = 16, 256


def route(dtype: torch.dtype, dk: int, dv: int) -> str:
    """The CUDA kernel that takes a (dtype, Dk, Dv) call: ``"sm90"`` or
    ``"scalar"`` (which takes every width).  Raises ``TypeError`` for a
    dtype neither kernel takes and ``ValueError`` for a width below 1."""
    if dtype not in DTYPES:
        raise TypeError(f"flash_attention: {dtype}; the kernels take "
                        "float32 or bfloat16")
    if dk < 1 or dv < 1:
        raise ValueError(f"flash_attention: Dk {dk}, Dv {dv}; the kernels "
                         "take widths from 1")
    if (dtype == torch.bfloat16 and dk <= SM90_MAX and dv <= SM90_MAX
            and dk % SM90_STEP == 0 and dv % SM90_STEP == 0):
        return "sm90"
    return "scalar"


def route_bwd(dtype: torch.dtype, dk: int, dv: int) -> str:
    """The backward kernels that take a (dtype, Dk, Dv) call: ``"sm90"``
    or ``"scalar"``, the forward's choice (:func:`route`): the tensor-core
    backward takes every width its forward takes, the scalar one every
    width.  Raises as :func:`route` does."""
    return route(dtype, dk, dv)


@torch.library.custom_op("repro_torch::flash_attention_meta",
                         mutates_args=())
def flash_attention_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, window: int) -> torch.Tensor:
    """The kernel's output on the meta device (shapes alone: its fake
    implementation); it computes nothing anywhere else."""
    raise ValueError(f"flash_attention_meta: {q.device} is not meta")


@flash_attention_meta.register_fake
def _(q, k, v, causal, window):
    B, S, H, _ = q.shape
    return q.new_empty((B, S, H, v.shape[3]))


@torch.library.custom_op("repro_torch::flash_attention_bwd_meta",
                         mutates_args=())
def flash_attention_bwd_meta(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
        do: torch.Tensor, causal: bool, window: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' dq, dk, dv on the meta device."""
    raise ValueError(f"flash_attention_bwd_meta: {q.device} is not meta")


@flash_attention_bwd_meta.register_fake
def _(q, k, v, o, do, causal, window):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _meta_setup(ctx, inputs, output):
    q, k, v, ctx.causal, ctx.window = inputs
    ctx.save_for_backward(q, k, v, output)


def _meta_backward(ctx, do):
    q, k, v, o = ctx.saved_tensors
    return (*flash_attention_bwd_meta(q, k, v, o, do, ctx.causal,
                                      ctx.window), None, None)


flash_attention_meta.register_autograd(_meta_backward,
                                       setup_context=_meta_setup)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B,S,H,Dk), k (B,S,KV,Dk), v (B,S,KV,Dv) -> (B,S,H,Dv) in q's
    dtype.  H must be a multiple of KV (query head h reads KV head
    h // (H // KV)); ``window > 0`` limits each query to its trailing
    ``window`` positions."""
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if dev.type == "meta":
        return flash_attention_meta(q, k, v, causal, window)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window)
    return _forward(q, k, v, causal, window, None)


def _forward(q, k, v, causal, window, lse):
    """One forward launch on the routed kernel; ``lse`` (B,H,S) float32 or
    None."""
    global launches, launches_sm90
    dev = q.device
    _check(q, k, v)
    B, S, H, Dk = q.shape
    Dv = v.shape[3]
    kernel = route(q.dtype, Dk, Dv)
    out = torch.empty((B, S, H, Dv), dtype=q.dtype, device=dev)
    if kernel == "sm90":
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"flash_attention: {name}'s data is not "
                                 "16-byte aligned (the kernel loads it by "
                                 "TMA)")
        flash_attention_sm90_cuda(q, k, v, out, causal, window, lse)
        launches_sm90 += 1
    else:
        flash_attention_cuda(q, k, v, out, causal, window, lse)
    launches += 1
    return out


class FlashAttention(torch.autograd.Function):
    """Flash attention on the card with its hand-written backward: the
    forward kernel also writes the rows' log-sum-exp, and the backward
    kernels read q, k, v, the output and it (nothing falls back to the
    plain version)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        B, S, H, _ = q.shape
        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        out = _forward(q, k, v, causal, window, lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        global launches_bwd, launches_bwd_sm90
        q, k, v, out, lse = ctx.saved_tensors
        Dk, Dv = q.shape[3], v.shape[3]
        dout = dout.contiguous().to(q.dtype)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        if route_bwd(q.dtype, Dk, Dv) == "sm90":
            if dout.data_ptr() % 16:
                raise ValueError("flash_attention backward: do's data is not "
                                 "16-byte aligned (the kernels load it by "
                                 "TMA)")
            flash_attention_bwd_sm90_cuda(q, k, v, out, dout, lse, dq, dk,
                                          dv, ctx.causal, ctx.window)
            launches_bwd_sm90 += 1
        else:
            flash_attention_bwd_cuda(q, k, v, out, dout, lse, dq, dk, dv,
                                     ctx.causal, ctx.window)
        launches_bwd += 1
        return dq, dk, dv, None, None


def _check(q, k, v):
    """Raise the precise reason neither kernel can take (q, k, v)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{q.device}")
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}; the "
                            "kernels take q, k, v all float32 or all "
                            "bfloat16")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be a contiguous "
                             "4-d tensor")
    B, S, H, Dk = q.shape
    if (k.shape[:2] != (B, S) or v.shape[:3] != k.shape[:3]
            or k.shape[3] != Dk or H % k.shape[2] != 0):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    if q.numel() == 0 or v.numel() == 0:
        raise ValueError("flash_attention: empty input")
