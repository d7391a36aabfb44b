"""The port's training step against ``repro.train.loop.make_train_step``
on the CPU, for llama3-smoke (dense) and mamba2-smoke (ssm) in float32 on
identical weights and batches (tests/_torch_train.py): ``loss_and_metrics``
and every gradient leaf (within 1e-4 of the leaf's largest magnitude),
with remat ``block`` and ``none``; a three-step trajectory of the train
step (loss, xent, aux, grad_norm each step, then every parameter and
optimizer-state leaf) with microbatches 1 and 2 and both remat settings.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from _torch_train import (GRAD_TOL, batches, configs, jax_batch,  # noqa: E402
                          jax_grads, jax_loop, leaf_errors, loop, optimizers,
                          port_grads, states, train_state_to_jax)

ARCHS = ["llama3-8b", "mamba2-130m"]
REMAT = ["block", "none"]
#: metrics of a step, relative to the JAX package's value
METRIC_TOL = 1e-5


@pytest.mark.parametrize("remat", REMAT)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf(arch, remat):
    jcfg, cfg = configs(arch, remat=remat)
    jstate, state = states(jcfg, cfg)
    b = batches(cfg, 1)[0]
    want_m, want_g = jax_grads(jstate["params"], jax_batch(b), jcfg)
    got_m, got_g = port_grads(state["params"], loop.to_device(b, "cpu"))
    for k in ("loss", "xent", "aux"):
        assert got_m[k] == pytest.approx(want_m[k], rel=METRIC_TOL,
                                         abs=1e-7), k
    errs = leaf_errors(got_g, want_g)
    assert max(errs.values()) <= GRAD_TOL, errs
    # every parameter gets a gradient that is not all zero
    assert all(np.abs(np.asarray(v)).max() > 0
               for v in jax.tree.leaves(want_g))


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("remat", REMAT)
@pytest.mark.parametrize("arch", ARCHS)
def test_three_step_trajectory(arch, remat, microbatches):
    jcfg, cfg = configs(arch, remat=remat)
    jopt, opt = optimizers(cfg)
    jstate, state = states(jcfg, cfg)
    jstep = jax.jit(jax_loop.make_train_step(jcfg, jopt,
                                             microbatches=microbatches))
    step = loop.make_train_step(cfg, opt, microbatches=microbatches)
    losses = []
    for b in batches(cfg, 3):
        jstate, jm = jstep(jstate, jax_batch(b))
        state, m = step(state, loop.to_device(b, "cpu"))
        for k in ("loss", "xent", "aux", "grad_norm"):
            assert float(m[k]) == pytest.approx(float(jm[k]),
                                                rel=METRIC_TOL, abs=1e-7), k
        losses.append(float(m["loss"]))
    assert state["step"] == int(jstate["step"]) == 3
    errs = leaf_errors(train_state_to_jax(state)["params"],
                       jax.tree.map(np.asarray, jstate["params"]))
    assert max(errs.values()) <= GRAD_TOL, errs
    errs = leaf_errors(train_state_to_jax(state)["opt"],
                       jax.tree.map(np.asarray, jstate["opt"]))
    assert max(errs.values()) <= GRAD_TOL, errs
    assert np.isfinite(losses).all()
