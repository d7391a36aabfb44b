"""Helpers of the tests that hold the port's training path against the JAX
package on the CPU (test_torch_train*.py): a smoke configuration in
float32 on identical weights in both packages (the JAX package's
``init_train_state``, carried over by ``train_state_from_jax``), the same
batches from the data pipeline (a copy in both packages), and the
comparisons those tests share."""
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

