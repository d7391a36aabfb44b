"""The port's optimizers (repro_torch.optim) against the JAX package's on
identical parameters, gradients and steps, on the CPU, within 1e-6 of
each leaf's largest magnitude: ``warmup_cosine`` at every step of a
schedule, ``clip_by_global_norm`` below and above its bound, and three
steps of AdamW and of Adafactor (updates and state) on the parameter
trees of llama3-smoke (stacked norm scales: factored, their column
statistic over the layers, the RMS clip over a whole stacked leaf) and
deepseek-smoke (Adafactor's model; dense and MoE stacks, MLA).  Each step
starts both optimizers from the same parameters and state (the JAX
package's, carried over), so that what is compared is one update.
Adafactor's updates are held, in both packages, within 1e-6 of a float64
evaluation of the JAX package's formula (:func:`_adafactor_f64`): the
reference's own float32 sums are up to ~9e-7 of a leaf's largest update
off it (its RMS over deepseek's (2, 8, 48, 64) MoE output projection, an
8-lane running sum on the CPU; the port's ~2.5e-7), so port and JAX can
differ by slightly more than 1e-6 between themselves.  Three chained
train steps are held at 1e-4 in test_torch_train.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_train import leaf_errors  # noqa: E402
from repro.configs.base import get_smoke_config as jax_smoke_config  # noqa: E402,E501
from repro.models import transformer as JT  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.models.convert import (jax_tree, leaf_groups,  # noqa: E402
                                        opt_state_from_jax, opt_state_to_jax,
                                        state_dict_from_jax)
from repro_torch.optim import optimizers as popt  # noqa: E402

TOL = 1e-6


def _params(arch):
    """(JAX params, the port's name -> tensor dict of the same numbers)."""
    jp = JT.init_params(jax_smoke_config(arch), jax.random.PRNGKey(0))
    return jp, state_dict_from_jax(jax.tree.map(np.asarray, jp))


def _grads(jp, seed, scale=1.0):
    """Random gradients shaped as ``jp``: (JAX tree, the port's dict)."""
    rng = np.random.default_rng(seed)
    g = jax.tree.map(lambda p: (scale * rng.standard_normal(p.shape))
                     .astype(np.float32), jp)
    return jax.tree.map(jnp.asarray, g), state_dict_from_jax(g)


def test_warmup_cosine_every_step():
    for kw in (dict(peak_lr=3e-3, warmup=10, total=200),
               dict(peak_lr=1e-4, warmup=0, total=50, floor=0.0)):
        jl, pl = jopt.warmup_cosine(**kw), popt.warmup_cosine(**kw)
        steps = range(0, kw["total"] + 20)
        want = np.array([float(jl(jnp.int32(s))) for s in steps])
        got = np.array([float(pl(s)) for s in steps])
        np.testing.assert_allclose(got, want, rtol=TOL, atol=0)


@pytest.mark.parametrize("scale", [1e-4, 1.0])
def test_clip_by_global_norm(scale):
    jp, _ = _params("llama3-8b")
    jg, pg = _grads(jp, 1, scale)
    jc, jn = jopt.clip_by_global_norm(jg, 1.0)
    pc, pn = popt.clip_by_global_norm(pg, 1.0)
    assert float(pn) == pytest.approx(float(jn), rel=TOL)
    errs = leaf_errors(jax_tree(pc), jax.tree.map(np.asarray, jc))
    assert max(errs.values()) <= TOL, errs


def _adafactor_f64(g, s, step, lr, decay=0.8, eps=1e-30):
    """The JAX package's Adafactor update of one leaf in float64 (no
    weight decay, clip threshold 1)."""
    g = np.asarray(g, np.float64)
    beta = 1.0 - (step + 2.0) ** (-decay)
    g2 = g * g + eps
    if "vr" in s:
        vr = beta * np.asarray(s["vr"], np.float64) + (1 - beta) * g2.mean(-1)
        vc = beta * np.asarray(s["vc"], np.float64) + (1 - beta) * g2.mean(-2)
        r = vr / np.maximum(vr.mean(-1, keepdims=True), eps)
        u = g / np.sqrt(r)[..., None] / np.sqrt(vc)[..., None, :]
    else:
        u = g / np.sqrt(beta * np.asarray(s["v"], np.float64)
                        + (1 - beta) * g2)
    u = u / max(1.0, np.sqrt((u * u).mean() + 1e-12))
    return -lr * u


def _leaf_paths(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict) and not ({"v"} <= set(v) or "vr" in v):
            yield from _leaf_paths(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-v3-671b"])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_three_updates(name, arch):
    kw = dict(peak_lr=1e-2, warmup=1, total=10)
    jo = jopt.get_optimizer(name, jopt.warmup_cosine(**kw))
    po = popt.get_optimizer(name, popt.warmup_cosine(**kw))
    jp, pp = _params(arch)
    js, ps = jo.init(jp), po.init(pp)
    if name == "adafactor":
        # the stacked (L, D) norm scales are factored as JAX factors them
        stacked = [p for p, n in leaf_groups(pp).items()
                   if len(n) > 1 and pp[n[0]].ndim == 1]
        assert stacked and all(set(ps[p]) == {"vr", "vc"} for p in stacked)
    for step in range(3):
        jg, pg = _grads(jp, 10 + step)
        ps = opt_state_from_jax(jax.tree.map(np.asarray, js), ps, "cpu")
        pp = state_dict_from_jax(jax.tree.map(np.asarray, jp))
        js_np = jax.tree.map(np.asarray, js)
        ju, js = jax.jit(jo.update)(jg, js, jp, jnp.int32(step))
        pu, ps = po.update(pg, ps, pp, step)
        if name == "adamw":
            errs = leaf_errors(jax_tree(pu), jax.tree.map(np.asarray, ju))
            assert max(errs.values()) <= TOL, (step, errs)
        else:
            lr = float(popt.warmup_cosine(**kw)(step + 1))
            g_np = jax.tree.map(np.asarray, jg)
            exact = {}
            for path, s_leaf in _leaf_paths(js_np):
                node = g_np
                for k in path.split("/"):
                    node = node[k]
                exact[path] = _adafactor_f64(node, s_leaf, step, lr)
            for got in (jax_tree(pu), jax.tree.map(np.asarray, ju)):
                flat = dict(_leaf_paths(got))
                errs = {p: float(np.abs(flat[p] - e).max() / np.abs(e).max())
                        for p, e in exact.items()}
                assert max(errs.values()) <= TOL, (step, errs)
        errs = leaf_errors(opt_state_to_jax(ps),
                           jax.tree.map(np.asarray, js))
        assert max(errs.values()) <= TOL, (step, errs)
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)
