"""The port's SSD scan against the JAX package, on the CPU.

* the plain version of the CUDA kernel (``ops.ssd_scan`` on a CPU tensor)
  against the Pallas kernel driven by ``ssd_scan_op`` (interpret mode, as
  tests/test_kernels.py runs it) and against the sequential recurrence
  ``ssd_chunk_ref``, at the cases of tests/test_kernels.py;
* the port's CPU ``ssd_chunked`` against the JAX package's, in group form
  with G = 1 and with G = 2 at H = 4 (heads sharing a group), and with S
  not a multiple of the chunk (dt = 0 padding);
* the chunk-parallel decomposition the tensor-core route computes (chunk
  states, then state passing, then chunk outputs; :func:`_ssd_decomposed`,
  plain torch) against the same JAX functions, so the reordered algorithm
  is the reference's before any card runs it;
* ``ops.route``: which CUDA route takes which scan.

Tolerance 2e-4 (float32), as tests/test_kernels.py.  The same inputs,
made from a numpy seed, go to both packages."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan.ops import ssd_scan_op  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_chunk_ref as jax_chunk_ref  # noqa: E402
from repro.models.ssm import ssd_chunked as jax_ssd_chunked  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.models.ssm import ssd_chunked  # noqa: E402

TOL = 2e-4


def _softplus(x):
    return np.log1p(np.exp(-np.abs(x))) + np.maximum(x, 0)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("s,p,n,chunk", [
    (64, 8, 8, 16), (128, 16, 8, 32), (128, 32, 16, 64), (96, 8, 8, 96),
])
def test_plain_scan_matches_pallas_kernel_and_sequential_ref(s, p, n, chunk):
    """tests/test_kernels.py::test_ssd_kernel_vs_sequential_ref: (BH, S, .)
    rows with their own A, B and C are one sequence of BH heads, each its
    own group, in the model's layout."""
    bh = 3
    rng = np.random.default_rng(s + p + n)
    x = rng.standard_normal((bh, s, p), np.float32)
    dt = _softplus(rng.standard_normal((bh, s))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(bh))).astype(np.float32)
    Bm = rng.standard_normal((bh, s, n), np.float32)
    Cm = rng.standard_normal((bh, s, n), np.float32)
    before = ops.launches
    y, state = ops.ssd_scan(
        torch.from_numpy(x.transpose(1, 0, 2)[None].copy()),
        torch.from_numpy(dt.T[None].copy()), torch.from_numpy(A),
        torch.from_numpy(Bm.transpose(1, 0, 2)[None].copy()),
        torch.from_numpy(Cm.transpose(1, 0, 2)[None].copy()), chunk=chunk)
    assert ops.launches == before  # the CPU path launches no kernel
    y, state = y[0].transpose(0, 1), state[0]  # (BH, S, P), (BH, N, P)
    yk, sk = ssd_scan_op(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk=chunk)
    _close(y, yk)
    _close(state, sk)
    for h in range(bh):
        args = (x[h], dt[h], A[h], Bm[h], Cm[h], np.zeros((n, p), np.float32))
        yw, sw = jax_chunk_ref(*map(jnp.asarray, args))
        _close(y[h], yw)
        _close(state[h], sw)


@pytest.mark.parametrize("S,H,G,chunk", [
    (64, 3, 1, 16),     # tests/test_kernels.py::test_ssd_kernel_matches_model_path
    (64, 4, 2, 16),     # two heads per group
    (50, 4, 2, 16),     # ragged last chunk: dt = 0 padding
    (40, 2, 1, 64),     # one chunk shorter than the chunk size
])
def test_cpu_ssd_chunked_matches_jax(S, H, G, chunk):
    B, P, N = 2, 8, 8
    rng = np.random.default_rng(S + H + G)
    x = rng.standard_normal((B, S, H, P), np.float32)
    dt = _softplus(rng.standard_normal((B, S, H))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H))).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N), np.float32)
    Cm = rng.standard_normal((B, S, G, N), np.float32)
    y, state = ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bm, Cm)), chunk)
    yj, sj = jax_ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk)
    assert y.shape == (B, S, H, P) and state.shape == (B, H, N, P)
    _close(y, yj)
    _close(state, sj)


def _ssd_decomposed(x, dt, A, Bm, Cm, chunk):
    """The tensor-core route's algorithm (csrc/ssd_scan_tc.cu) in plain
    torch: (1) per chunk seg, its total and the chunk's own state dS_c =
    (B * e^(total - seg) * dt)^T @ x; (2) s_c = s_{c-1} e^total_c + dS_c
    in chunk order, keeping each chunk's incoming state; (3) per chunk y =
    (C e^seg) @ s_in + tril(C B^T e^(seg_q - seg_k) dt_k) @ x.  float32,
    model layout, dt = 0 padding of a ragged last chunk."""
    f = torch.nn.functional
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    x, Bm, Cm = (f.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, Bm, Cm))
    dt = f.pad(dt, (0, 0, 0, pad))
    head_group = torch.arange(H) // (H // G)
    xc = x.reshape(Bsz, nc, Q, H, P)
    dtc = dt.reshape(Bsz, nc, Q, H)
    Bh = Bm.reshape(Bsz, nc, Q, G, N)[:, :, :, head_group]
    Ch = Cm.reshape(Bsz, nc, Q, G, N)[:, :, :, head_group]
    # (1) chunk states
    seg = torch.cumsum(dtc * A, dim=2)               # (B, nc, Q, H)
    total = seg[:, :, -1]                            # (B, nc, H)
    wk = torch.exp(total[:, :, None] - seg) * dtc
    dS = torch.einsum("bcqhn,bcqh,bcqhp->bchnp", Bh, wk, xc)
    # (2) state passing
    state = torch.zeros((Bsz, H, N, P))
    s_in = []
    for c in range(nc):
        s_in.append(state)
        state = state * torch.exp(total[:, c])[..., None, None] + dS[:, c]
    s_in = torch.stack(s_in, dim=1)                  # (B, nc, H, N, P)
    # (3) chunk outputs
    y_inter = torch.einsum("bcqhn,bchnp->bcqhp", Ch, s_in) \
        * torch.exp(seg)[..., None]
    cb = torch.einsum("bcqhn,bckhn->bchqk", Ch, Bh)
    segh = seg.permute(0, 1, 3, 2)                   # (B, nc, H, Q)
    decay = torch.exp(segh[..., :, None] - segh[..., None, :])
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    w = torch.where(mask, cb * decay * dtc.permute(0, 1, 3, 2)[..., None, :],
                    0.0)
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", w, xc)
    y = (y_inter + y_intra).reshape(Bsz, nc * Q, H, P)[:, :S]
    return y, state


@pytest.mark.parametrize("S,H,G,chunk", [
    (64, 3, 1, 16),     # whole chunks, G = 1
    (64, 4, 2, 16),     # two heads per group
    (50, 4, 2, 16),     # ragged last chunk: dt = 0 padding
    (40, 2, 1, 64),     # one chunk shorter than the chunk size
    (200, 4, 4, 64),    # ragged, four chunks, a group per head
])
def test_decomposed_scan_matches_jax(S, H, G, chunk):
    """Chunk states, state passing, chunk outputs == the JAX package's
    ssd_chunked (2e-4, float32), y and the final state."""
    B, P, N = 2, 16, 16
    rng = np.random.default_rng(S + H + G + chunk)
    x = rng.standard_normal((B, S, H, P), np.float32)
    dt = _softplus(rng.standard_normal((B, S, H))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H))).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N), np.float32)
    Cm = rng.standard_normal((B, S, G, N), np.float32)
    y, state = _ssd_decomposed(*map(torch.from_numpy, (x, dt, A, Bm, Cm)),
                               chunk)
    yj, sj = jax_ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk)
    assert y.shape == (B, S, H, P) and state.shape == (B, H, N, P)
    _close(y, yj)
    _close(state, sj)


@pytest.mark.parametrize("s,chunk", [(128, 64), (192, 64)])
def test_decomposed_scan_matches_pallas_kernel(s, chunk):
    """The decomposition against the Pallas kernel driven by ssd_scan_op
    (interpret mode): (BH, S, .) rows, each head its own group."""
    bh, p, n = 3, 16, 16
    rng = np.random.default_rng(s + chunk)
    x = rng.standard_normal((bh, s, p), np.float32)
    dt = _softplus(rng.standard_normal((bh, s))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(bh))).astype(np.float32)
    Bm = rng.standard_normal((bh, s, n), np.float32)
    Cm = rng.standard_normal((bh, s, n), np.float32)
    y, state = _ssd_decomposed(
        torch.from_numpy(x.transpose(1, 0, 2)[None].copy()),
        torch.from_numpy(dt.T[None].copy()), torch.from_numpy(A),
        torch.from_numpy(Bm.transpose(1, 0, 2)[None].copy()),
        torch.from_numpy(Cm.transpose(1, 0, 2)[None].copy()), chunk)
    yk, sk = ssd_scan_op(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk=chunk)
    _close(y[0].transpose(0, 1), yk)
    _close(state[0], sk)


@pytest.mark.parametrize("dtype,n,p,chunk,want", [
    (torch.bfloat16, 128, 64, 256, "tc"),       # mamba2-130m
    (torch.bfloat16, 16, 16, 64, "tc"),
    (torch.bfloat16, 128, 128, 128, "tc"),
    (torch.float32, 128, 64, 256, "scalar"),    # float32: the scalar kernel
    (torch.bfloat16, 8, 64, 256, "scalar"),     # N not a multiple of 16
    (torch.bfloat16, 128, 40, 256, "scalar"),   # P not a multiple of 16
    (torch.bfloat16, 128, 64, 16, "scalar"),    # chunk not a multiple of 64
    (torch.bfloat16, 256, 64, 64, "scalar"),    # N above 128 (head-tiled)
])
def test_route_picks_the_kernel(dtype, n, p, chunk, want):
    assert ops.route(dtype, n, p, chunk) == want


@pytest.mark.parametrize("dtype,n,p,chunk,exc", [
    (torch.float16, 64, 64, 64, TypeError),
    (torch.bfloat16, 64, 64, 0, ValueError),
])
def test_route_refuses_what_no_kernel_takes(dtype, n, p, chunk, exc):
    with pytest.raises(exc):
        ops.route(dtype, n, p, chunk)
