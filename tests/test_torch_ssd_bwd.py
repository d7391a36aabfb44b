"""The plain backward of the port's SSD scan against the JAX package's
gradients, on the CPU, float32, the same numpy-made inputs and output
gradients to both: ``ssd_scan_bwd_ref`` (autograd of the plain version of
the CUDA kernels, the CPU path of ``models.ssm.ssd_chunked``, what
``chip_smoke.py`` holds the backward kernels to) against ``jax.vjp`` of
``repro.models.ssm.ssd_chunked``, with and without a gradient on the
final state; G < H, S not a multiple of the chunk, S below it; dx, ddt,
dA, dB, dC within 1e-4 of each one's largest magnitude.  Where a chunk's
decay overflows above the diagonal, the reference's gradient is NaN and
the port's is finite (its plain version masks the decay in the exponent:
ROADMAP §3)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.ssm import ssd_chunked as jax_ssd  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_bwd_ref  # noqa: E402

TOL = 1e-4

#: (B, S, H, G, P, N, chunk)
CASES = [
    (2, 64, 4, 4, 8, 8, 16),
    (2, 50, 4, 2, 8, 8, 16),      # G < H, ragged last chunk
    (1, 96, 6, 3, 16, 8, 32),
    (1, 40, 2, 1, 8, 16, 64),     # S below the chunk
]


def _inputs(B, S, H, G, P, N, seed=0, dt_scale=0.25):
    """Inputs and output gradients; ``dt_scale`` 0.25 keeps every chunk's
    decay span below float32's exp overflow (the parity cases)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((B, S, H, P)).astype(f)
    dt = (dt_scale * np.log1p(np.exp(rng.standard_normal((B, S, H)) - 1))
          ).astype(f)
    A = -np.exp(rng.standard_normal(H)).astype(f)
    Bm = rng.standard_normal((B, S, G, N)).astype(f)
    Cm = rng.standard_normal((B, S, G, N)).astype(f)
    dy = rng.standard_normal((B, S, H, P)).astype(f)
    dst = rng.standard_normal((B, H, N, P)).astype(f)
    return (x, dt, A, Bm, Cm), dy, dst


def _grads(ins, dy, dst, chunk):
    """(JAX's, the port's) gradients of (x, dt, A, Bm, Cm)."""
    (_, state), vjp = jax.vjp(lambda *a: jax_ssd(*a, chunk),
                              *map(jnp.asarray, ins))
    want = vjp((jnp.asarray(dy), jnp.zeros_like(state) if dst is None
                else jnp.asarray(dst)))
    got = ssd_scan_bwd_ref(*map(torch.from_numpy, ins), torch.from_numpy(dy),
                           None if dst is None else torch.from_numpy(dst),
                           chunk=chunk)
    return want, got


@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_jax_grad(case, with_state):
    B, S, H, G, P, N, chunk = case
    ins, dy, dst = _inputs(B, S, H, G, P, N)
    want, got = _grads(ins, dy, dst if with_state else None, chunk)
    for name, g, w in zip(("x", "dt", "A", "Bm", "Cm"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= TOL, (name, err)


def test_overflowing_decay_stays_finite():
    """dt large enough that exp(seg_q - seg_k) above the diagonal
    overflows float32: the reference's gradient is NaN, the port's is
    finite (its forward is the same)."""
    ins, dy, dst = _inputs(1, 64, 2, 1, 8, 8, dt_scale=40.0)
    want, got = _grads(ins, dy, dst, 64)
    assert not all(np.isfinite(np.asarray(w)).all() for w in want)
    assert all(torch.isfinite(g).all() for g in got)
