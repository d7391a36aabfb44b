"""The port's fault-tolerance runtime (repro_torch.runtime.coordinator)
against tests/test_ckpt_runtime.py's scenarios, on the CPU: training of
llama3-smoke with worker failures injected at two steps completes and
ends bit-equal to the run without failures (restored from the JAX-layout
checkpoints of ``run_with_restarts``' default save); the step monitor's
verdicts; the rebalancer against the naive assignment; and a checkpoint
the JAX package's ``run_with_restarts`` wrote is taken by the port's
default restore, and the port's comes back to the JAX package."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from _torch_train import (  # noqa: E402
    GRAD_TOL, configs, jax_batch, jax_loop, jax_train_step,
    leaf_errors, loop, optimizers, pipeline, train_state_to_jax)
from repro.ckpt import store as jax_store  # noqa: E402
from repro.runtime import coordinator as jax_coordinator  # noqa: E402
from repro_torch.runtime.coordinator import (StepMonitor,  # noqa: E402
                                             WorkerFailure, WorkRebalancer,
                                             run_with_restarts)

ARCH = "llama3-8b"


def test_restart_driver_survives_failures(tmp_path):
    """Training with injected step failures completes and ends where the
    failure-free run does, bit for bit (exact replay from checkpoints)."""
    cfg = configs(ARCH)[1]
    opt = optimizers(cfg)[1]
    step = loop.make_train_step(cfg, opt)

    def run(inject):
        data = pipeline(cfg, False)
        ref = {"state": loop.init_train_state(cfg, opt, device="cpu")}
        fail_at = {3, 7} if inject else set()
        seen = set()

        def one_step(i):
            if inject and i in fail_at and i not in seen:
                seen.add(i)
                raise WorkerFailure(f"node died at step {i}")
            batch = loop.to_device(data.batch_at(i), "cpu")
            ref["state"], _ = step(ref["state"], batch)
            data.step = i + 1

        stats = run_with_restarts(
            one_step, state_ref=ref, data=data, n_steps=10,
            ckpt_dir=str(tmp_path / ("f" if inject else "c")), ckpt_every=2)
        return ref["state"], stats

    s_clean, st_clean = run(False)
    s_fail, st_fail = run(True)
    assert st_fail["failures"] == 2 and st_fail["restores"] == 2
    assert st_clean["completed"] == st_fail["completed"] == 10
    assert s_clean["step"] == s_fail["step"] == 10
    clean = dict(s_clean["params"].named_parameters())
    for name, p in s_fail["params"].named_parameters():
        assert torch.equal(p, clean[name]), name
    for part in ("m", "v"):
        for name, t in s_fail["opt"][part].items():
            assert torch.equal(t, s_clean["opt"][part][name]), (part, name)


def test_step_monitor_detects():
    m = StepMonitor(deadline_factor=5.0, straggler_factor=1.5)
    for _ in range(5):
        assert m.observe(1.0) == "ok"
    assert m.observe(2.0) == "straggler"
    assert m.observe(10.0) == "failed"
    assert m.stragglers == 1


def test_rebalancer_beats_naive():
    """Greedy LPT with observed rates beats contiguous assignment when one
    worker is 4x slow (the straggler-mitigation path), with the JAX
    package's assignment."""
    rng = np.random.default_rng(0)
    costs = rng.uniform(1, 5, 64)
    rates = np.array([1.0, 1.0, 1.0, 0.25])  # worker 3 is the straggler
    rb = WorkRebalancer(4)
    smart = rb.assign(costs, rates)
    naive = [list(range(i * 16, (i + 1) * 16)) for i in range(4)]
    assert rb.makespan(smart, costs, rates) < 0.5 * rb.makespan(
        naive, costs, rates)
    ref = jax_coordinator.WorkRebalancer(4)
    assert smart == ref.assign(costs, rates)
    assert rb.makespan(smart, costs, rates) == ref.makespan(smart, costs,
                                                            rates)


def test_jax_checkpoint_restores_in_the_port_and_back(tmp_path):
    """The JAX package's ``run_with_restarts`` trains 4 steps
    (checkpoints at 0, 2, 4); a port run, from its own random weights,
    loses its first step after that step-4 checkpoint lands in its
    directory, so its default restore takes the JAX state and data
    position; two more steps agree with the JAX package's two (metrics
    within 1e-5, parameters and optimizer state within 1e-4), and the
    port's step-6 checkpoint restores in the JAX package bit for bit."""
    jcfg, cfg = configs(ARCH)
    jopt, opt = optimizers(cfg)
    jstep = jax_train_step(ARCH)
    jref = {"state": jax_loop.init_train_state(jcfg, jopt,
                                               jax.random.PRNGKey(0))}
    jdata = pipeline(jcfg, True)
    jm = {}

    def jax_one(i):
        jref["state"], m = jstep(jref["state"],
                                 jax_batch(jdata.batch_at(i)))
        jm[i] = m
        jdata.step = i + 1

    stats = jax_coordinator.run_with_restarts(
        jax_one, state_ref=jref, data=jdata, n_steps=4,
        ckpt_dir=str(tmp_path / "jax"), ckpt_every=2)
    assert stats["completed"] == 4

    ref = {"state": loop.init_train_state(cfg, opt, device="cpu")}
    data = pipeline(cfg, False)
    step = loop.make_train_step(cfg, opt)
    port_dir = str(tmp_path / "port")
    metrics = {}

    def one_step(i):
        if "died" not in metrics:
            metrics["died"] = i
            jax_store.save(port_dir, 4, {"state": jref["state"],
                                         "data": jdata.state_dict()})
            raise WorkerFailure(f"node died at step {i}")
        ref["state"], metrics[i] = step(
            ref["state"], loop.to_device(data.batch_at(i), "cpu"))
        data.step = i + 1

    stats = run_with_restarts(one_step, state_ref=ref, data=data,
                              n_steps=6, ckpt_dir=port_dir, ckpt_every=2)
    assert stats["failures"] == stats["restores"] == 1
    assert stats["completed"] == 6 and set(metrics) == {"died", 4, 5}
    for i in (4, 5):
        jax_one(i)
        for k in ("loss", "xent", "aux", "grad_norm"):
            assert float(metrics[i][k]) == pytest.approx(
                float(jm[i][k]), rel=1e-5, abs=1e-7), (i, k)
    got = train_state_to_jax(ref["state"])
    want = jax.tree.map(np.asarray, jref["state"])
    assert int(got["step"]) == int(want["step"]) == 6
    for part in ("params", "opt"):
        errs = leaf_errors(got[part], want[part])
        assert max(errs.values()) <= GRAD_TOL, (part, errs)

    restored, at = jax_store.restore(port_dir, {"state": jref["state"],
                                                "data": jdata.state_dict()})
    assert at == 6 and restored["data"]["step"] == 6
    back = jax.tree.map(np.asarray, restored["state"])
    for part in ("params", "opt"):
        assert all(e == 0 for e in leaf_errors(back[part],
                                               got[part]).values()), part
