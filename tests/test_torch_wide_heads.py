"""Head and state widths past the scalar kernels' whole-row instances, on
the CPU, float32, against the JAX package (the same numpy-made inputs and
output gradients to both).  On the card those widths run on the head-tiled
kernels (``flash_wide_kernel``, ``flash_bwd_*_wide``, ``ssd_wide_*``),
which ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold to the plain
versions; here the plain versions are held to the reference:

* flash attention at Dk 320 / Dv 288 (Dv past 256, both past the f32 rows'
  shared memory) and Dk 272 / Dv 64 (Dk past the rows' shared memory),
  each causal, bidirectional and windowed, and one GQA case: the port's
  ``flash_attention_ref`` against ``attention_ref``, its autograd
  gradients against ``jax.vjp`` of it;
* the SSD scan at N 192, P 160, chunk 96 and at N 144, P 200, chunk 64:
  ``ssd_scan_ref`` against ``ssd_chunked`` and the Pallas kernel
  (``ssd_scan_op``, interpret mode), its gradients against ``jax.vjp`` of
  ``ssd_chunked``;
* recurrentgemma-smoke widened to recurrentgemma-9b's head width (D 256):
  the loss and every gradient leaf, and one train step, against the JAX
  package's.

Tolerances: outputs within 2e-4 (rtol = atol, as ``tests/test_kernels.py``
holds float32), gradients within 1e-4 of each leaf's largest magnitude
(float32 sums in another order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_train import check_gradients, check_trajectory  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro.kernels.ssd_scan.ops import ssd_scan_op  # noqa: E402
from repro.models.ssm import ssd_chunked  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_bwd_ref, flash_attention_ref)
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_scan_bwd_ref, ssd_scan_ref)

OUT_TOL = 2e-4
GRAD_TOL = 1e-4

#: (S, H, KV, Dk, Dv, causal, window)
FLASH_CASES = [
    (80, 2, 2, 320, 288, True, 0),
    (80, 2, 2, 320, 288, False, 0),
    (80, 2, 2, 320, 288, True, 24),
    (80, 2, 2, 272, 64, True, 0),
    (80, 2, 2, 272, 64, False, 0),
    (80, 2, 2, 272, 64, True, 24),
    (70, 4, 1, 320, 288, True, 0),     # GQA (MQA), S ragged to the tile
]
#: (B, S, H, G, P, N, chunk)
SSD_CASES = [(1, 192, 2, 2, 160, 192, 96), (1, 128, 2, 1, 200, 144, 64)]


def _normal(rng, *shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _grad_close(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        err = np.abs(g.detach().numpy() - w).max() / np.abs(w).max()
        assert err <= GRAD_TOL, err


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_version_matches_jax(case):
    S, H, KV, Dk, Dv, causal, window = case
    rng = np.random.default_rng(Dk + Dv + S)
    q, k, v, do = _normal(rng, (1, S, H, Dk), (1, S, KV, Dk), (1, S, KV, Dv),
                          (1, S, H, Dv))
    kw = dict(causal=causal, window=window)
    out, vjp = jax.vjp(lambda *a: attention_ref(*a, **kw),
                       *map(jnp.asarray, (q, k, v)))
    got = flash_attention_ref(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), rtol=OUT_TOL,
                               atol=OUT_TOL)
    _grad_close(flash_attention_bwd_ref(*map(torch.from_numpy,
                                             (q, k, v, do)), **kw),
                vjp(jnp.asarray(do)))


def _ssd_inputs(B, S, H, G, P, N, seed):
    rng = np.random.default_rng(seed)
    x, Bm, Cm, dy, dst = _normal(rng, (B, S, H, P), (B, S, G, N),
                                 (B, S, G, N), (B, S, H, P), (B, H, N, P))
    # dt at a quarter of softplus's: every chunk's decay span stays inside
    # float32's exp range (the reference's gradient is NaN past it, §3)
    dt = (0.25 * np.log1p(np.exp(rng.standard_normal((B, S, H)) - 1))
          ).astype(np.float32)
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    return (x, dt, A, Bm, Cm), dy, dst


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_plain_version_matches_jax(case):
    B, S, H, G, P, N, chunk = case
    ins, dy, dst = _ssd_inputs(B, S, H, G, P, N, seed=N + P)
    (y, state), vjp = jax.vjp(lambda *a: ssd_chunked(*a, chunk),
                              *map(jnp.asarray, ins))
    got_y, got_state = ssd_scan_ref(*map(torch.from_numpy, ins), chunk=chunk)
    for g, w in ((got_y, y), (got_state, state)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=OUT_TOL,
                                   atol=OUT_TOL)
    _grad_close(ssd_scan_bwd_ref(*map(torch.from_numpy, ins),
                                 torch.from_numpy(dy), torch.from_numpy(dst),
                                 chunk=chunk),
                vjp((jnp.asarray(dy), jnp.asarray(dst))))


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_plain_version_matches_pallas_kernel(case):
    """The Pallas chunk kernel in interpret mode, in its (B H, S, .)
    layout: each head its own row of B and C (the group's, repeated)."""
    B, S, H, G, P, N, chunk = case
    (x, dt, A, Bm, Cm), _, _ = _ssd_inputs(B, S, H, G, P, N, seed=N + P)
    rep = H // G
    per_head = [np.repeat(t, rep, axis=2).transpose(0, 2, 1, 3)
                .reshape(B * H, S, N) for t in (Bm, Cm)]
    y, state = ssd_scan_op(
        jnp.asarray(x.transpose(0, 2, 1, 3).reshape(B * H, S, P)),
        jnp.asarray(dt.transpose(0, 2, 1).reshape(B * H, S)),
        jnp.asarray(np.tile(A, B)), *map(jnp.asarray, per_head), chunk=chunk)
    got_y, got_state = ssd_scan_ref(
        *map(torch.from_numpy, (x, dt, A, Bm, Cm)), chunk=chunk)
    np.testing.assert_allclose(
        got_y.numpy(), np.asarray(y).reshape(B, H, S, P).transpose(0, 2, 1, 3),
        rtol=OUT_TOL, atol=OUT_TOL)
    np.testing.assert_allclose(got_state.numpy(),
                               np.asarray(state).reshape(B, H, N, P),
                               rtol=OUT_TOL, atol=OUT_TOL)


def test_recurrentgemma_d256_gradients_match_jax():
    """Every gradient leaf of recurrentgemma-smoke at head width 256 (the
    9b's; the smoke's 16 widened) against ``jax.value_and_grad``."""
    check_gradients("recurrentgemma-9b", "block", d_head=256)


def test_recurrentgemma_d256_train_step_matches_jax():
    """One AdamW step of the same model against the JAX package's: the
    step's metrics, every parameter and moment."""
    check_trajectory("recurrentgemma-9b", 1, steps=1, d_head=256)
