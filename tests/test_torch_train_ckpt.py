"""Train-state checkpoints between the two packages, on the CPU: a JAX
train state saved by ``repro.ckpt.store`` (after two steps, beside the
data pipeline's state) restores in the port (``repro_torch.ckpt.store``
into the JAX layout of the port's own state, ``train_state_from_jax``),
and the port's next step equals JAX's (metrics within 1e-5, every
parameter and optimizer-state leaf within 1e-4 of its largest
magnitude); the other way round, a port checkpoint restores in the JAX
package.  AdamW (llama3-smoke, mamba2-smoke) and Adafactor (llama3-smoke
with ``optimizer="adafactor"``: its per-leaf state)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from _torch_train import (GRAD_TOL, configs, jax_batch,  # noqa: E402
                          jax_loop, leaf_errors, loop, optimizers, pipeline,
                          states, train_state_to_jax)
from repro.ckpt import store as jax_store  # noqa: E402
from repro_torch.ckpt import store  # noqa: E402
from repro_torch.models.convert import train_state_from_jax  # noqa: E402

CASES = [("llama3-8b", {}), ("mamba2-130m", {}),
         ("llama3-8b", {"optimizer": "adafactor"})]


def _same(state, jstate, jm, m):
    for k in ("loss", "xent", "aux", "grad_norm"):
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5,
                                            abs=1e-7), k
    got, want = train_state_to_jax(state), jax.tree.map(np.asarray, jstate)
    assert int(got["step"]) == int(want["step"])
    for part in ("params", "opt"):
        errs = leaf_errors(got[part], want[part])
        assert max(errs.values()) <= GRAD_TOL, (part, errs)


@pytest.mark.parametrize("arch,replace", CASES)
def test_jax_checkpoint_restored_by_port(tmp_path, arch, replace):
    jcfg, cfg = configs(arch, **replace)
    jopt, opt = optimizers(cfg)
    jstate, _ = states(jcfg, cfg)
    jstep = jax.jit(jax_loop.make_train_step(jcfg, jopt))
    jds = pipeline(jcfg, True)
    for _ in range(2):
        jstate, _ = jstep(jstate, jax_batch(next(jds)))
    jax_store.save(str(tmp_path), 2, {"state": jstate,
                                      "data": jds.state_dict()})

    # a fresh port state (its own random weights) takes the checkpoint
    state = loop.init_train_state(cfg, opt, device="cpu")
    ds = pipeline(cfg, False)
    like = {"state": train_state_to_jax(state), "data": ds.state_dict()}
    restored, step = store.restore(str(tmp_path), like)
    assert step == 2
    state = train_state_from_jax(restored["state"], state)
    ds.load_state_dict(restored["data"])
    assert state["step"] == 2 and ds.step == jds.step

    b = next(ds)
    jb = next(jds)
    for k in b:
        np.testing.assert_array_equal(b[k], jb[k])
    jstate, jm = jstep(jstate, jax_batch(jb))
    state, m = loop.make_train_step(cfg, opt)(state, loop.to_device(b, "cpu"))
    _same(state, jstate, jm, m)


@pytest.mark.parametrize("arch,replace", CASES[:1] + CASES[2:])
def test_port_checkpoint_restored_by_jax(tmp_path, arch, replace):
    jcfg, cfg = configs(arch, **replace)
    jopt, opt = optimizers(cfg)
    jstate0, state = states(jcfg, cfg)
    step = loop.make_train_step(cfg, opt)
    ds = pipeline(cfg, False)
    for _ in range(2):
        state, _ = step(state, loop.to_device(next(ds), "cpu"))
    store.save(str(tmp_path), 2, {"state": train_state_to_jax(state),
                                  "data": ds.state_dict()})

    jds = pipeline(jcfg, True)
    restored, _ = jax_store.restore(str(tmp_path), {"state": jstate0,
                                                    "data": jds.state_dict()})
    jstate = restored["state"]
    jds.load_state_dict(restored["data"])
    assert int(jstate["step"]) == 2
    jstate, jm = jax.jit(jax_loop.make_train_step(jcfg, jopt))(
        jstate, jax_batch(next(jds)))
    state, m = step(state, loop.to_device(next(ds), "cpu"))
    _same(state, jstate, jm, m)
