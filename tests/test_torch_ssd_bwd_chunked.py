"""The tensor-core SSD backward's decomposition, in plain torch, against
the JAX package's gradients, on the CPU, float32, the same numpy-made
inputs and output gradients to both: ``ssd_scan_bwd_chunked`` (each
chunk's own state gradient, the elementwise reverse pass over the chunks,
each chunk's gradients from its outgoing state's; what
``csrc/ssd_scan_bwd_tc.cu`` computes on the card) against ``jax.vjp`` of
``repro.models.ssm.ssd_chunked``, with and without a gradient on the
final state, at ``tests/test_torch_ssd_bwd.py``'s cases (G < H, S not a
multiple of the chunk, S below it) and over several chunks: dx, ddt, dA,
dB, dC within 1e-5 of each one's largest magnitude (float32 sums in other
orders); and against the port's autograd backward in bfloat16, where
both round w and e^seg as the forward does."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.ssm import ssd_chunked as jax_ssd  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_scan_bwd_chunked, ssd_scan_bwd_ref)

TOL = 1e-5
NAMES = ("x", "dt", "A", "Bm", "Cm")

#: (B, S, H, G, P, N, chunk): test_torch_ssd_bwd.py's, then more chunks
CASES = [
    (2, 64, 4, 4, 8, 8, 16),
    (2, 50, 4, 2, 8, 8, 16),      # G < H, ragged last chunk
    (1, 96, 6, 3, 16, 8, 32),
    (1, 40, 2, 1, 8, 16, 64),     # S below the chunk
    (1, 200, 4, 1, 16, 16, 32),   # seven chunks, the last ragged
]


def _inputs(B, S, H, G, P, N, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((B, S, H, P)).astype(f)
    dt = (0.25 * np.log1p(np.exp(rng.standard_normal((B, S, H)) - 1))
          ).astype(f)
    A = -np.exp(rng.standard_normal(H)).astype(f)
    Bm = rng.standard_normal((B, S, G, N)).astype(f)
    Cm = rng.standard_normal((B, S, G, N)).astype(f)
    dy = rng.standard_normal((B, S, H, P)).astype(f)
    dst = rng.standard_normal((B, H, N, P)).astype(f)
    return (x, dt, A, Bm, Cm), dy, dst


@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_decomposition_matches_jax_grad(case, with_state):
    B, S, H, G, P, N, chunk = case
    ins, dy, dst = _inputs(B, S, H, G, P, N)
    (_, state), vjp = jax.vjp(lambda *a: jax_ssd(*a, chunk),
                              *map(jnp.asarray, ins))
    want = vjp((jnp.asarray(dy), jnp.asarray(dst) if with_state
                else jnp.zeros_like(state)))
    got = ssd_scan_bwd_chunked(
        *map(torch.from_numpy, ins), torch.from_numpy(dy),
        torch.from_numpy(dst) if with_state else None, chunk=chunk)
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= TOL, (name, err)


@pytest.mark.parametrize("case", [(1, 100, 2, 1, 16, 16, 32),
                                  (2, 64, 4, 2, 16, 16, 64)])
def test_decomposition_in_bf16_matches_autograd(case):
    """In bfloat16 the decomposition rounds bf16(w) and bf16(e^seg) where
    the forward does and keeps every gradient in f32; autograd of the
    plain forward also rounds its intermediate gradients to bf16.  The
    two agree within the card's bf16 tolerance (2e-2)."""
    B, S, H, G, P, N, chunk = case
    ins, dy, dst = _inputs(B, S, H, G, P, N, seed=1)
    bf = torch.bfloat16
    args = [torch.from_numpy(t) for t in ins]
    for i in (0, 3, 4):
        args[i] = args[i].to(bf)
    dy_t, dst_t = torch.from_numpy(dy).to(bf), torch.from_numpy(dst)
    got = ssd_scan_bwd_chunked(*args, dy_t, dst_t, chunk=chunk)
    want = ssd_scan_bwd_ref(*args, dy_t, dst_t, chunk=chunk)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        err = float((g.float() - w.float()).abs().max()
                    / w.float().abs().max())
        assert err <= 2e-2, (name, err)
