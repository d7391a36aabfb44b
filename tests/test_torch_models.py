"""The port's LM serving path against the JAX package, on the CPU.

``llama3-smoke`` (dense) and ``mamba2-smoke`` (ssm) in float32: the JAX
package's ``init_params`` go to the port through ``params_from_jax``, so
both run on identical weights, and the same numpy-made tokens go to both.
Compared: ``prefill`` logits and every cache leaf, the logits after 6
``decode_step``s past the prefill (cache padded as in
tests/test_decode_continuation.py, or given that room by ``prefill``'s
``capacity``), ``forward_hidden``, and a bf16
prefill.  Tolerances: 1e-4 in float32 (it holds; the 3e-3 of
test_decode_continuation.py is not needed), 5e-2 in bf16 for the dense
family (the ssm family's bf16 case: see its test).  The
``ServeEngine`` of both packages gives identical tokens and stats.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_lm import (B, BF16_TOL, S, check_consumes_cache,  # noqa: E402
                       check_decode, check_forward_hidden, check_prefill,
                       check_serve_engine, close, make_pair)
from repro.configs.base import get_smoke_config as jax_smoke_config  # noqa: E402,E501
from repro.models import transformer as JT  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

ARCHS = ["llama3-8b", "mamba2-130m"]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return make_pair(request.param)


def test_prefill_logits_and_every_cache_leaf(pair):
    assert check_prefill(pair)["pos"] == S


def test_decode_continuation_matches_jax(pair):
    check_decode(pair)


def test_decode_into_prefill_capacity_matches_jax(pair):
    """``prefill(capacity=...)``'s room is ``pad_cache``'s: the decode
    steps write new positions (the ssm state has none to add)."""
    check_decode(pair, capacity=True)


def test_decode_step_consumes_its_cache(pair):
    """Both families write the step into the given cache in place and
    return those same tensors (decode_step's contract)."""
    check_consumes_cache(pair)


def test_forward_hidden_matches_jax(pair):
    assert check_forward_hidden(pair) == 0.0


def _bf16_prefills(arch):
    """(port bf16, JAX bf16, JAX float32) prefill logits on one set of
    weights and tokens."""
    jcfg = jax_smoke_config(arch)
    cfg = get_smoke_config(arch)
    assert cfg.dtype == "bfloat16"
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(3))
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, S))
    batch = {"tokens": jnp.asarray(toks, jnp.int32)}
    jl, _ = JT.prefill(jparams, batch, jcfg)
    jl32, _ = JT.prefill(jparams, batch, jcfg.replace(dtype="float32"))
    logits, _ = model.prefill({"tokens": torch.from_numpy(toks)})
    assert logits.dtype == torch.bfloat16
    return (logits.float().numpy(), np.asarray(jl.astype(jnp.float32)),
            np.asarray(jl32))


def test_bf16_prefill_matches_jax():
    got, want, _ = _bf16_prefills("llama3-8b")
    close(got, want, BF16_TOL)


def test_bf16_prefill_ssm_errs_like_jax():
    """mamba2-smoke's logits reach |38| (tied embeddings), where bf16's
    step is 0.25: the JAX package's own bf16 prefill is 0.18 from its
    float32 one, past 5e-2.  So the ssm family's bf16 case holds the port
    to the JAX package's own bf16 error against the float32 logits."""
    got, jax_bf16, jax_f32 = _bf16_prefills("mamba2-130m")
    jax_err = np.abs(jax_bf16 - jax_f32).max()
    assert np.abs(got - jax_f32).max() <= 1.5 * jax_err
    close(got, jax_bf16, 2 * jax_err)


def test_serve_engine_identical_to_jax(pair):
    check_serve_engine(pair)


class _FlakyPool:
    """A duck-typed PIM pool whose every third tick faults."""

    def __init__(self, faults):
        self.faults = faults
        self.ticks = []

    def tick(self, n_active):
        self.ticks.append(n_active)
        if len(self.ticks) % 3 == 0:
            raise self.faults.DpuFaultError(
                self.faults.FaultReport("permanent", detail="pool below floor"))


def test_serve_engine_pim_pool_identical_to_jax(pair):
    """Faulted ticks fall back to the host and are counted, as in JAX."""
    import repro.faults.model as jax_faults
    import repro_torch.faults.model as faults
    runs = []
    for cls, conf, params, mod in ((JaxServeEngine, pair.jcfg, pair.jparams,
                                    jax_faults),
                                   (ServeEngine, pair.cfg, pair.model,
                                    faults)):
        pool = _FlakyPool(mod)
        eng = cls(conf, params, batch=2, capacity=16, pim_pool=pool)
        for r in range(3):
            eng.submit(pair.toks[r % B, :4], max_new=3)
        runs.append((eng.run(), dict(eng.stats), pool.ticks))
    assert runs[0] == runs[1]
    assert runs[1][1]["host_ticks"] > 0 and runs[1][1]["pim_ticks"] > 0
