"""Dispatching wrapper of the SSD scan: what
``repro_torch.models.ssm.ssd_chunked`` calls.

``ssd_scan(x, dt, A, Bm, Cm, chunk=)`` computes the chunked Mamba-2 SSD
scan of a whole sequence (``repro.models.ssm.ssd_chunked``; in float32 the
Pallas kernel ``repro.kernels.ssd_scan`` driven by ``ssd_scan_op``).  A
CPU tensor goes to the plain-torch version (:func:`.ref.ssd_scan_ref`); a
CUDA tensor launches one of two hand-written CUDA routes
(:mod:`.ssd_scan`) on the current stream, or raises — there is no
fallback.  :func:`route` picks it from the dtype, the widths and the
chunk alone:

* ``"tc"`` — ``csrc/ssd_scan_tc.cu`` (chunk-parallel, mma.sync tensor
  cores, four launches): bfloat16 with N and P multiples of 16 up to 128
  and a chunk that is a multiple of 64 (mamba2-130m: N 128, P 64, chunk
  256);
* ``"scalar"`` — ``csrc/ssd_scan.cu`` (scalar FMAs): float32, and
  bfloat16 at the shapes ``"tc"`` does not take, at any N, P and chunk
  (one CTA per (head, batch) where the state fits, N and P up to 128;
  else one per (64 state columns, head, batch), N in slices).

``launches`` counts the scans handed to either route and ``launches_tc``
those of the tensor-core route (never plain-version calls); callers may
reset either to 0.

Training: where autograd records (grad enabled and an input that needs a
gradient), a CUDA call goes through :class:`SsdScan`, whose forward also
keeps each chunk's incoming state and whose backward launches the kernels
:func:`route_bwd` picks (``launches_bwd`` counts those backward calls and
``launches_bwd_tc`` those on the tensor-core route); it returns the
gradients of x, dt, A, Bm and Cm and takes one for the final state:

* ``"tc"`` — ``csrc/ssd_scan_bwd_tc.cu`` (chunk-parallel, mma.sync, six
  launches): the shapes the forward ``"tc"`` route takes, from its bf16
  hi + lo states;
* ``"scalar"`` — ``csrc/ssd_scan_bwd.cu`` (scalar FMAs): everything
  else, at any shape (two kernels where the whole rows fit, N x P up to
  128 x 64 at Q 256; else six head-tiled ones).

The plain backward is autograd of :func:`.ref.ssd_scan_ref`
(:func:`.ref.ssd_scan_bwd_ref`); :func:`.ref.ssd_scan_bwd_chunked`
mirrors the tensor-core route's decomposition in plain torch.

A meta tensor (shapes alone: the dry-run, ``repro_torch.launch``) goes to
:func:`ssd_scan_meta`, one custom op standing for the card's kernels,
with :func:`ssd_scan_bwd_meta` as its backward: so the dry-run's counters
see one scan a layer, reading x, dt, A, B, C and writing y and the final
state once (``launch/cost.py`` prices it), and not the plain version's
per-chunk temporaries, which the card never makes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.kernels.ssd_scan.ssd_scan import (
    DTYPES, TC_TILE, smem_fits_bwd_tc, smem_fits_tc, ssd_scan_bwd_cuda,
    ssd_scan_bwd_tc_cuda, ssd_scan_cuda, ssd_scan_tc_cuda)

#: scans handed to a CUDA route by :func:`ssd_scan` (a plain integer)
launches = 0
#: of which on the tensor-core route
launches_tc = 0
#: backward calls made by :class:`SsdScan`
launches_bwd = 0
#: of which on the tensor-core route
launches_bwd_tc = 0

#: the tensor-core route's widths: multiples of one bf16 mma k-step up to
#: what its instances hold (its chunks: multiples of its TC_TILE-row tiles)
TC_STEP, TC_MAX = 16, 128


def route(dtype: torch.dtype, n: int, p: int, chunk: int) -> str:
    """The CUDA route that takes a (dtype, N, P, chunk) scan: ``"tc"`` or
    ``"scalar"`` (which takes every shape).  Raises ``TypeError`` for a
    dtype neither takes and ``ValueError`` for a width or a chunk below
    1."""
    if dtype not in DTYPES:
        raise TypeError(f"ssd_scan: {dtype}; the kernels take float32 or "
                        "bfloat16")
    if n < 1 or p < 1 or chunk < 1:
        raise ValueError(f"ssd_scan: N {n}, P {p}, chunk {chunk}; the "
                         "kernels take each from 1")
    if (dtype == torch.bfloat16 and n <= TC_MAX and p <= TC_MAX
            and n % TC_STEP == 0 and p % TC_STEP == 0
            and chunk % TC_TILE == 0):
        return "tc"
    return "scalar"


def route_bwd(dtype: torch.dtype, n: int, p: int, chunk: int) -> str:
    """The backward kernels that take a (dtype, N, P, chunk) scan:
    ``"tc"`` or ``"scalar"``, the forward's choice (:func:`route`): the
    tensor-core backward reads the tensor-core forward's states and takes
    every shape it takes, the scalar one every shape.  Raises as
    :func:`route` does."""
    return route(dtype, n, p, chunk)


@torch.library.custom_op("repro_torch::ssd_scan_meta", mutates_args=())
def ssd_scan_meta(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  Bm: torch.Tensor, Cm: torch.Tensor,
                  chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels' y and final state on the meta device (shapes alone:
    its fake implementation); it computes nothing anywhere else."""
    raise ValueError(f"ssd_scan_meta: {x.device} is not meta")


@ssd_scan_meta.register_fake
def _(x, dt, A, Bm, Cm, chunk):
    B, _, H, P = x.shape
    return (torch.empty_like(x),
            x.new_empty((B, H, Bm.shape[3], P), dtype=torch.float32))


@torch.library.custom_op("repro_torch::ssd_scan_bwd_meta", mutates_args=())
def ssd_scan_bwd_meta(
        x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, dy: torch.Tensor, chunk: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor]:
    """The backward kernels' dx, ddt, dA, dB, dC on the meta device (the
    final state's gradient is not read: training leaves it unused)."""
    raise ValueError(f"ssd_scan_bwd_meta: {x.device} is not meta")


@ssd_scan_bwd_meta.register_fake
def _(x, dt, A, Bm, Cm, dy, chunk):
    return tuple(torch.empty_like(t) for t in (x, dt, A, Bm, Cm))


def _meta_setup(ctx, inputs, output):
    *tensors, ctx.chunk = inputs
    ctx.save_for_backward(*tensors)


def _meta_backward(ctx, dy, dstate):
    return (*ssd_scan_bwd_meta(*ctx.saved_tensors, dy, ctx.chunk), None)


ssd_scan_meta.register_autograd(_meta_backward, setup_context=_meta_setup)


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int):
    """x (B,S,H,P), dt (B,S,H) f32, A (H,) f32 negative, Bm/Cm (B,S,G,N)
    with G dividing H -> (y (B,S,H,P) in x's dtype, final state
    (B,H,N,P) f32)."""
    dev = x.device
    if dev.type == "cpu":
        return ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk)
    if dev.type == "meta":
        return ssd_scan_meta(x, dt, A, Bm, Cm, chunk)
    if dev.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {dev}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, Bm, Cm)):
        return SsdScan.apply(x, dt, A, Bm, Cm, chunk)
    y, state, _ = _forward(x, dt, A, Bm, Cm, chunk, keep_states=False)
    return y, state


def _forward(x, dt, A, Bm, Cm, chunk, keep_states):
    """One scan on the routed kernel: (y, final state, each chunk's
    incoming state or None)."""
    global launches, launches_tc
    dev = x.device
    _check(x, dt, A, Bm, Cm, chunk)
    B, S, H, P = x.shape
    N = Bm.shape[3]
    Q = min(chunk, S)
    kernel = route(x.dtype, N, P, chunk)
    if kernel == "tc" and not smem_fits_tc(N, P, Q):
        raise ValueError(f"ssd_scan: N {N}, P {P}, chunk {Q} exceed the "
                         "tensor-core kernels' shared memory")
    y = torch.empty_like(x)
    state = torch.empty((B, H, N, P), dtype=torch.float32, device=dev)
    if kernel == "tc":
        for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
            if t.data_ptr() % 16:
                raise ValueError(f"ssd_scan: {name}'s data is not 16-byte "
                                 "aligned (the kernels copy it by cp.async)")
        states = ssd_scan_tc_cuda(x, dt, A, Bm, Cm, y, state, Q)
        launches_tc += 1
    else:
        states = None
        if keep_states:
            states = torch.empty((B, H, -(-S // Q), N, P),
                                 dtype=torch.float32, device=dev)
        ssd_scan_cuda(x, dt, A, Bm, Cm, y, state, Q, states)
    launches += 1
    return y, state, states if keep_states else None


class SsdScan(torch.autograd.Function):
    """The SSD scan on the card with its hand-written backward: the
    forward keeps each chunk's incoming state, the backward kernels read
    it (nothing falls back to the plain version).  The gradients of Bm and
    Cm come per head from the kernel and are summed over each group's
    heads here, dA's per (batch, chunk) over both; all in a fixed order."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        y, state, states = _forward(x, dt, A, Bm, Cm, chunk,
                                    keep_states=True)
        ctx.save_for_backward(x, dt, A, Bm, Cm, states)
        ctx.chunk_asked, ctx.chunk = chunk, min(chunk, x.shape[1])
        # an unused output's gradient comes as None, not zeros (training
        # leaves the final state unused: the kernels take no dfinal then)
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        global launches_bwd, launches_bwd_tc
        x, dt, A, Bm, Cm, states = ctx.saved_tensors
        B, S, H, P = x.shape
        G, N = Bm.shape[2], Bm.shape[3]
        kernel = route_bwd(x.dtype, N, P, ctx.chunk_asked)
        if kernel == "tc" and not smem_fits_bwd_tc(N, P, ctx.chunk):
            raise ValueError(f"ssd_scan backward: N {N}, P {P}, chunk "
                             f"{ctx.chunk} exceed its tensor-core kernels' "
                             "shared memory")
        dy = (torch.zeros_like(x) if dy is None
              else dy.contiguous().to(x.dtype))
        dfinal = None if dstate is None else dstate.float().contiguous()
        if kernel == "tc":
            if dy.data_ptr() % 16:
                raise ValueError("ssd_scan backward: dy's data is not "
                                 "16-byte aligned (the kernels copy it by "
                                 "cp.async)")
            dx, ddt, dBh, dCh, dA = ssd_scan_bwd_tc_cuda(
                x, dt, A, Bm, Cm, dy, states, dfinal, ctx.chunk)
            launches_bwd_tc += 1
        else:
            dx, ddt, dBh, dCh, dA = ssd_scan_bwd_cuda(
                x, dt, A, Bm, Cm, dy, states, dfinal, ctx.chunk)
        launches_bwd += 1
        dB = dBh.view(B, S, G, H // G, N).sum(3).to(Bm.dtype)
        dC = dCh.view(B, S, G, H // G, N).sum(3).to(Cm.dtype)
        return dx, ddt, dA.sum((0, 1)), dB, dC, None


def _check(x, dt, A, Bm, Cm, chunk):
    """Raise the precise reason the kernel cannot take the inputs."""
    named = (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm))
    for name, t in named:
        if t.device != x.device:
            raise ValueError(f"ssd_scan: {name} on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan: {name} must be contiguous")
    if x.dtype not in DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"ssd_scan: x, Bm, Cm are {x.dtype}, {Bm.dtype}, "
                        f"{Cm.dtype}; the kernel takes all three float32 or "
                        "all bfloat16")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError("ssd_scan: dt and A must be float32")
    if x.dim() != 4 or Bm.dim() != 4 or x.numel() == 0:
        raise ValueError("ssd_scan: x and Bm must be non-empty 4-d tensors")
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if (dt.shape != (B, S, H) or A.shape != (H,) or Bm.shape[:2] != (B, S)
            or Cm.shape != Bm.shape or H % G != 0):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)} do not fit")
    if chunk < 1:
        raise ValueError(f"ssd_scan: chunk {chunk} < 1")
