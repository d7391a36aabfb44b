"""Helpers of the tests that hold the port's training path against the JAX
package on the CPU (test_torch_train*.py): a smoke configuration in
float32 on identical weights in both packages (the JAX package's
``init_train_state``, carried over by ``train_state_from_jax``), the same
batches from the data pipeline (a copy in both packages), and the
comparisons those tests share."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.models import transformer as JT
from repro.optim import get_optimizer as jax_get_optimizer
from repro.optim import warmup_cosine as jax_warmup_cosine
from repro.train import loop as jax_loop
from repro_torch.configs.base import get_smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.convert import (jax_tree, train_state_from_jax,
                                        train_state_to_jax)
from repro_torch.optim import get_optimizer, warmup_cosine
from repro_torch.train import loop

#: |port - JAX| / (the leaf's largest |JAX| value), float32 throughout
GRAD_TOL = 1e-4
SEQ, BATCH = 32, 4
LR = dict(peak_lr=3e-3, warmup=2, total=20)


def configs(arch, **replace):
    """(JAX config, port config) of ``arch``'s smoke width in float32."""
    return (jax_smoke_config(arch).replace(dtype="float32", **replace),
            get_smoke_config(arch).replace(dtype="float32", **replace))


def optimizers(cfg):
    return (jax_get_optimizer(cfg.optimizer, jax_warmup_cosine(**LR)),
            get_optimizer(cfg.optimizer, warmup_cosine(**LR)))


def states(jcfg, cfg, seed=0):
    """(JAX train state, the port's holding the same numbers on the CPU)."""
    jopt, opt = optimizers(cfg)
    jstate = jax_loop.init_train_state(jcfg, jopt, jax.random.PRNGKey(seed))
    state = loop.init_train_state(cfg, opt, device="cpu")
    return jstate, train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                        state)


def batches(cfg, n, seed=0):
    """``n`` numpy batches of the data pipeline (both packages' copies
    give the same ones; this is the JAX package's)."""
    ds = JaxSyntheticLM(cfg, JaxDataConfig(seq_len=SEQ, global_batch=BATCH,
                                           vocab_size=cfg.vocab_size,
                                           seed=seed))
    out = [next(ds) for _ in range(n)]
    mine = SyntheticLM(cfg, DataConfig(seq_len=SEQ, global_batch=BATCH,
                                       vocab_size=cfg.vocab_size, seed=seed))
    for b in out:
        for k, v in next(mine).items():
            np.testing.assert_array_equal(v, b[k])
    return out


def jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def leaf_errors(got: dict, want: dict, prefix="") -> dict:
    """path -> max |got - want| / max |want| over two nested numpy trees
    of one structure."""
    assert set(got) == set(want), (prefix, set(got) ^ set(want))
    out = {}
    for k in want:
        if isinstance(want[k], dict):
            out.update(leaf_errors(got[k], want[k], f"{prefix}{k}/"))
        else:
            w = np.asarray(want[k], np.float64)
            g = np.asarray(got[k], np.float64)
            assert g.shape == w.shape, (prefix + k, g.shape, w.shape)
            out[prefix + k] = float(np.abs(g - w).max()
                                    / max(np.abs(w).max(), 1e-30))
    return out


def port_grads(model, batch):
    """(metrics, the JAX tree of the gradients) of the port's
    ``loss_and_metrics`` on a batch of tensors."""
    metrics, grads = loop.grads_and_metrics(model, batch)
    return {k: float(v) for k, v in metrics.items()}, jax_tree(grads)


def jax_grads(params, batch, cfg):
    (_, metrics), grads = jax.value_and_grad(
        lambda p: JT.loss_and_metrics(p, batch, cfg), has_aux=True)(params)
    return ({k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, grads))


# ---------------------------------------------------------------------------
# the moe, hybrid, encdec and vlm families' steps (test_torch_train_moe.py,
# test_torch_train_hybrid.py, test_torch_train_encdec_vlm.py)
# ---------------------------------------------------------------------------

#: metrics of a step, relative to the JAX package's value
METRIC_TOL = 1e-5
#: repro.optim.adamw's defaults
ADAMW_B1, ADAMW_B2, ADAMW_EPS = 0.9, 0.95, 1e-8


@functools.lru_cache(maxsize=None)
def jax_train_step(arch, microbatches=1):
    """The JAX package's jitted ``make_train_step`` of ``arch``'s smoke
    width in float32 (one compilation a module for each microbatch count:
    the trajectories and the checkpoint tests share it)."""
    jcfg, cfg = configs(arch)
    return jax.jit(jax_loop.make_train_step(jcfg, optimizers(cfg)[0],
                                            microbatches=microbatches))


def adamw_max_u(t: int) -> float:
    """The largest |m^ / sqrt(v^)| of AdamW at step ``t``:
    sqrt(sum a_s^2 / b_s) by Cauchy-Schwarz, a_s and b_s the
    bias-corrected weights of step s's gradient in m^ and v^ (each summing
    to 1); 1.0017 at step 3."""
    s = np.arange(1, t + 1)
    a = (1 - ADAMW_B1) * ADAMW_B1 ** (t - s) / (1 - ADAMW_B1 ** t)
    b = (1 - ADAMW_B2) * ADAMW_B2 ** (t - s) / (1 - ADAMW_B2 ** t)
    return float(np.sqrt((a * a / b).sum()))


def adamw_trajectory_bound(moments, want_params, first_step=0) -> dict:
    """How far the port's parameters may be from JAX's after AdamW steps
    whose gradients agree to GRAD_TOL: path -> per-element bound.

    AdamW's update u = m^ / (sqrt(v^) + eps) has slope 1 / eps where the
    gradient is near 0 (eps = 1e-8), so float32 noise in a gradient
    element of ~1e-8 (an expert that sees few tokens, a gate bias summed
    with heavy cancellation) moves its update by O(1): one step of
    qwen3-moe-smoke's ``moe_blocks/moe/wo`` has elements with |g| ~1e-8
    whose gradients differ by 1e-9 between the packages (4 ulp of the
    leaf's 0.032), and their updates by up to 0.023 (u -0.5169 against
    -0.5398), 1.1e-4 of the leaf's largest weight after one step of lr
    1.5e-3.  The bound: if every gradient element agrees to Delta_t =
    GRAD_TOL x max |g^_t| (g^ the clipped gradient of the leaf at step t,
    which the gradient test asserts), then m^_t and sqrt(v^_t) each move
    by at most Delta_t (a convex combination and a weighted RMS of the
    gradients so far), so

        |du_t| <= min(2 adamw_max_u(t),
                      2 Delta_t / (max(sqrt(v^_t) - Delta_t, 0) + eps))

    (|dm^| / (sqrt(v^) + eps) and |m^| |d sqrt(v^)| / (sqrt(v^) + eps)^2,
    each at most Delta_t over the smallest denominator on the way), and
    the parameter, moved by -lr_t u_t a step, by at most the sum of
    lr_t |du_t|.  Added to the GRAD_TOL x max |p| that holds the dense and
    ssm trajectories, it is the tolerance of each element.  Where the
    gradient is large against Delta_t the added term is small against
    GRAD_TOL x max |p|; it is wide only for elements whose gradient is
    within a few Delta_t of zero, where AdamW makes any two float32
    evaluations disagree.

    ``moments``: JAX's optimizer state (numpy trees ``{"m", "v"}``) at
    ``first_step`` (the same in both packages: zeros for a fresh state, a
    restored checkpoint's) and after each step from there, in order;
    ``want_params``: JAX's parameters after the last step (numpy tree)."""
    lr_fn = jax_warmup_cosine(**LR)
    out = {}

    def walk(ms, vs, p, prefix):
        if isinstance(p, dict):
            for k in p:
                walk([m[k] for m in ms], [v[k] for v in vs], p[k],
                     f"{prefix}{k}/")
            return
        bound = GRAD_TOL * np.abs(p).max() * np.ones(p.shape)
        m_prev = np.asarray(ms[0], np.float64)
        for t, (m, v) in enumerate(zip(ms[1:], vs[1:]),
                                   start=first_step + 1):
            m, v = np.asarray(m, np.float64), np.asarray(v, np.float64)
            g = (m - ADAMW_B1 * m_prev) / (1 - ADAMW_B1)
            m_prev = m
            delta = GRAD_TOL * np.abs(g).max()
            root = np.sqrt(v / (1 - ADAMW_B2 ** t))
            du = np.minimum(2 * adamw_max_u(t), 2 * delta / (
                np.maximum(root - delta, 0) + ADAMW_EPS))
            bound = bound + float(lr_fn(t)) * du
        out[prefix[:-1]] = bound

    walk([m["m"] for m in moments], [m["v"] for m in moments],
         want_params, "")
    return out


def assert_within(got: dict, want: dict, bounds: dict, prefix=""):
    """Every element of the nested numpy tree ``got`` within its bound
    (``bounds``: path -> array) of ``want``'s."""
    assert set(got) == set(want), (prefix, set(got) ^ set(want))
    for k in want:
        if isinstance(want[k], dict):
            assert_within(got[k], want[k], bounds, f"{prefix}{k}/")
            continue
        d = np.abs(np.asarray(got[k], np.float64)
                   - np.asarray(want[k], np.float64))
        b = bounds[prefix + k]
        over = d > b
        assert not over.any(), (prefix + k, int(over.sum()),
                                float(d[over].max()), float(b[over].min()))


def check_gradients(arch, remat, **replace):
    """``loss_and_metrics`` (loss, xent, aux within METRIC_TOL) and every
    gradient leaf (within GRAD_TOL of its largest magnitude) of ``arch``'s
    smoke width (``replace``'s fields replaced) against
    ``jax.value_and_grad`` (jitted, as the train step's); every leaf not
    all zero.  Returns (JAX's metrics, each leaf's error)."""
    jcfg, cfg = configs(arch, remat=remat, **replace)
    jstate, state = states(jcfg, cfg)
    b = batches(cfg, 1)[0]
    (_, want_m), want_g = jax.jit(jax.value_and_grad(
        lambda p, jb: JT.loss_and_metrics(p, jb, jcfg), has_aux=True))(
            jstate["params"], jax_batch(b))
    want_m = {k: float(v) for k, v in want_m.items()}
    want_g = jax.tree.map(np.asarray, want_g)
    got_m, got_g = port_grads(state["params"], loop.to_device(b, "cpu"))
    for k in ("loss", "xent", "aux"):
        assert abs(got_m[k] - want_m[k]) <= METRIC_TOL * abs(want_m[k]) \
            + 1e-7, (k, got_m[k], want_m[k])
    errs = leaf_errors(got_g, want_g)
    assert max(errs.values()) <= GRAD_TOL, errs
    assert all(np.abs(np.asarray(v)).max() > 0
               for v in jax.tree.leaves(want_g))
    return want_m, errs


def check_trajectory(arch, microbatches, steps=3):
    """``steps`` train steps of ``arch``'s smoke width in both packages
    from identical weights on identical batches: each step's loss, xent,
    aux and grad_norm within METRIC_TOL; then every parameter within
    :func:`adamw_trajectory_bound` of JAX's (AdamW; Adafactor: GRAD_TOL of
    each leaf's largest magnitude) and every optimizer-state leaf within
    GRAD_TOL.  Returns the port's losses."""
    jcfg, cfg = configs(arch)
    opt = optimizers(cfg)[1]
    jstate, state = states(jcfg, cfg)
    jstep = jax_train_step(arch, microbatches)
    step = loop.make_train_step(cfg, opt, microbatches=microbatches)
    losses, moments = [], [jax.tree.map(np.asarray, jstate["opt"])]
    for b in batches(cfg, steps):
        jstate, jm = jstep(jstate, jax_batch(b))
        state, m = step(state, loop.to_device(b, "cpu"))
        for k in ("loss", "xent", "aux", "grad_norm"):
            assert abs(float(m[k]) - float(jm[k])) \
                <= METRIC_TOL * abs(float(jm[k])) + 1e-7, \
                (k, float(m[k]), float(jm[k]))
        losses.append(float(m["loss"]))
        moments.append(jax.tree.map(np.asarray, jstate["opt"]))
    assert state["step"] == int(jstate["step"]) == steps
    got = train_state_to_jax(state)
    want = jax.tree.map(np.asarray, jstate)
    if cfg.optimizer == "adamw":
        assert_within(got["params"], want["params"],
                      adamw_trajectory_bound(moments, want["params"]))
    else:
        errs = leaf_errors(got["params"], want["params"])
        assert max(errs.values()) <= GRAD_TOL, errs
    errs = leaf_errors(got["opt"], want["opt"])
    assert max(errs.values()) <= GRAD_TOL, errs
    assert np.isfinite(losses).all()
    return losses


def pipeline(cfg, jax_side):
    """The data pipeline of the JAX package (``jax_side``) or the port's
    at the tests' batch and sequence."""
    cls, dc = ((JaxSyntheticLM, JaxDataConfig) if jax_side
               else (SyntheticLM, DataConfig))
    return cls(cfg, dc(seq_len=SEQ, global_batch=BATCH,
                       vocab_size=cfg.vocab_size))


def _assert_same_step(cfg, state, jstate, jm, m, moments, first_step):
    """One more step of each package from the same restored state:
    metrics within METRIC_TOL, parameters within the AdamW bound
    (Adafactor: GRAD_TOL), optimizer state and step equal to GRAD_TOL."""
    for k in ("loss", "xent", "aux", "grad_norm"):
        assert abs(float(m[k]) - float(jm[k])) \
            <= METRIC_TOL * abs(float(jm[k])) + 1e-7, k
    got, want = train_state_to_jax(state), jax.tree.map(np.asarray, jstate)
    assert int(got["step"]) == int(want["step"])
    if cfg.optimizer == "adamw":
        assert_within(got["params"], want["params"], adamw_trajectory_bound(
            moments + [want["opt"]], want["params"], first_step))
    else:
        errs = leaf_errors(got["params"], want["params"])
        assert max(errs.values()) <= GRAD_TOL, errs
    errs = leaf_errors(got["opt"], want["opt"])
    assert max(errs.values()) <= GRAD_TOL, errs


def check_jax_checkpoint_in_port(ckpt_dir, arch, steps=2):
    """A JAX train state saved by ``repro.ckpt.store`` after ``steps``
    steps, beside its data pipeline's state, restores in a fresh port
    state (its own random weights) through ``repro_torch.ckpt.store`` and
    ``train_state_from_jax``; the next step of each package agrees
    (:func:`_assert_same_step`)."""
    from repro.ckpt import store as jax_store
    from repro_torch.ckpt import store
    jcfg, cfg = configs(arch)
    opt = optimizers(cfg)[1]
    jstate, _ = states(jcfg, cfg)
    jstep = jax_train_step(arch)
    jds = pipeline(jcfg, True)
    for _ in range(steps):
        jstate, _ = jstep(jstate, jax_batch(next(jds)))
    jax_store.save(str(ckpt_dir), steps, {"state": jstate,
                                          "data": jds.state_dict()})

    state = loop.init_train_state(cfg, opt, device="cpu")
    ds = pipeline(cfg, False)
    like = {"state": train_state_to_jax(state), "data": ds.state_dict()}
    restored, step = store.restore(str(ckpt_dir), like)
    assert step == steps
    state = train_state_from_jax(restored["state"], state)
    ds.load_state_dict(restored["data"])
    assert state["step"] == steps and ds.step == jds.step
    moments = [jax.tree.map(np.asarray, jstate["opt"])]
    b, jb = next(ds), next(jds)
    for k in b:
        np.testing.assert_array_equal(b[k], jb[k])
    jstate, jm = jstep(jstate, jax_batch(jb))
    state, m = loop.make_train_step(cfg, opt)(state, loop.to_device(b, "cpu"))
    _assert_same_step(cfg, state, jstate, jm, m, moments, steps)


def check_port_checkpoint_in_jax(ckpt_dir, arch, steps=2):
    """The other way: the port's train state after ``steps`` steps, saved
    in the JAX layout (``train_state_to_jax``, ``repro_torch.ckpt.store``),
    restores in the JAX package; the next step of each agrees."""
    from repro.ckpt import store as jax_store
    from repro_torch.ckpt import store
    jcfg, cfg = configs(arch)
    opt = optimizers(cfg)[1]
    jstate0, state = states(jcfg, cfg)
    step = loop.make_train_step(cfg, opt)
    ds = pipeline(cfg, False)
    for _ in range(steps):
        state, _ = step(state, loop.to_device(next(ds), "cpu"))
    store.save(str(ckpt_dir), steps, {"state": train_state_to_jax(state),
                                      "data": ds.state_dict()})

    jds = pipeline(jcfg, True)
    restored, _ = jax_store.restore(str(ckpt_dir), {"state": jstate0,
                                                    "data": jds.state_dict()})
    jstate = restored["state"]
    jds.load_state_dict(restored["data"])
    assert int(jstate["step"]) == steps
    moments = [jax.tree.map(np.asarray, jstate["opt"])]
    jstate, jm = jax_train_step(arch)(jstate, jax_batch(next(jds)))
    state, m = step(state, loop.to_device(next(ds), "cpu"))
    _assert_same_step(cfg, state, jstate, jm, m, moments, steps)
