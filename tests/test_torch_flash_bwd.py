"""The plain backward of the port's flash attention against the JAX
package's gradients, on the CPU, float32, the same numpy-made inputs and
output gradient to both:

* ``flash_attention_bwd_ref`` (autograd of the plain version of the CUDA
  kernel, what ``chip_smoke.py`` holds the backward kernels to) against
  ``jax.grad`` of ``repro/kernels/flash_attention/ref.py::attention_ref``;
* the port's CPU ``blocked_attention`` (the training path's attention on
  the CPU) against ``jax.grad`` of the JAX package's ``blocked_attention``
  (what ``jax.value_and_grad`` differentiates in training, its window
  blocking included);

causal, bidirectional and windowed, GQA and MQA, Dk != Dv, S not a
multiple of the 64-row tile; dq, dk, dv within 1e-5 of each one's largest
magnitude."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref  # noqa: E402
from repro.models.attention import blocked_attention as jax_blocked  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref  # noqa: E402
from repro_torch.models.attention import blocked_attention  # noqa: E402

TOL = 1e-5

#: (S, H, KV, Dk, Dv, causal, window)
CASES = [
    (128, 4, 4, 32, 32, True, 0),
    (128, 8, 2, 16, 16, True, 0),     # GQA
    (256, 4, 1, 32, 64, True, 0),     # MQA + Dv != Dk
    (128, 4, 4, 32, 32, False, 0),    # bidirectional (encoder)
    (256, 4, 2, 32, 32, True, 64),    # local window
    (100, 4, 2, 24, 16, True, 0),     # S ragged to the tile, Dk != Dv
    (200, 4, 2, 16, 16, True, 50),    # ragged and windowed
]


def _inputs(S, H, KV, Dk, Dv, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((2, S, H, Dk), (2, S, KV, Dk), (2, S, KV, Dv),
                      (2, S, H, Dv))]


def _close(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= TOL, err


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_jax_grad(case):
    S, H, KV, Dk, Dv, causal, window = case
    q, k, v, do = _inputs(S, H, KV, Dk, Dv)
    want = jax.vjp(lambda *a: jax_attention_ref(*a, causal=causal,
                                                window=window),
                   *map(jnp.asarray, (q, k, v)))[1](jnp.asarray(do))
    got = flash_attention_bwd_ref(*map(torch.from_numpy, (q, k, v, do)),
                                  causal=causal, window=window)
    _close(got, want)


@pytest.mark.parametrize("case", [c for c in CASES if c[0] % 32 == 0])
def test_cpu_blocked_attention_grad_matches_jax(case):
    S, H, KV, Dk, Dv, causal, window = case
    q, k, v, do = _inputs(S, H, KV, Dk, Dv, seed=1)
    kw = dict(causal=causal, window=window, q_chunk=32, kv_chunk=32)
    want = jax.vjp(lambda *a: jax_blocked(*a, **kw),
                   *map(jnp.asarray, (q, k, v)))[1](jnp.asarray(do))
    ins = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = blocked_attention(*ins, **kw)
    got = torch.autograd.grad(out, ins, torch.from_numpy(do))
    _close(got, want)
