"""The port's SSD scan against the JAX package, on the CPU.

* the plain version of the CUDA kernel (``ops.ssd_scan`` on a CPU tensor)
  against the Pallas kernel driven by ``ssd_scan_op`` (interpret mode, as
  tests/test_kernels.py runs it) and against the sequential recurrence
  ``ssd_chunk_ref``, at the cases of tests/test_kernels.py;
* the port's CPU ``ssd_chunked`` against the JAX package's, in group form
  with G = 1 and with G = 2 at H = 4 (heads sharing a group), and with S
  not a multiple of the chunk (dt = 0 padding).

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
