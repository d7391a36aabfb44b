"""Helpers of the tests that hold the port's LM families against the JAX
package on the CPU (test_torch_models*.py): one smoke configuration run
through both packages on identical weights (``params_from_jax``) and the
same numpy-made inputs, and the comparisons those tests share."""
from dataclasses import dataclass
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models import transformer as JT
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.admission import AdmissionRejected
from repro_torch.configs.base import get_smoke_config
from repro_torch.models.convert import params_from_jax
from repro_torch.serve.engine import ServeEngine

F32_TOL = 1e-4
BF16_TOL = 5e-2
B, S, EXTRA = 2, 32, 6


def close(got, want, tol):
    # forward_hidden records autograd (training): its outputs are detached
    np.testing.assert_allclose(np.asarray(got.detach().float()
                                          if torch.is_tensor(got) else got,
                                          np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@dataclass
class Pair:
    """One smoke configuration in both packages on the same weights, with
    tokens (B, S + EXTRA) and the family's other inputs."""
    arch: str
    jcfg: Any
    jparams: Any
    cfg: Any
    model: Any
    toks: np.ndarray
    extra: dict          # patches (vlm) or frames (encdec), numpy

    def batch(self, n=S):
        """The prefill batch of the first ``n`` tokens: (JAX's, the
        port's).  encdec's holds the frames alone."""
        np_batch = dict(self.extra)
        if self.cfg.family != "encdec":
            np_batch["tokens"] = self.toks[:, :n]
        return ({k: jnp.asarray(v) for k, v in np_batch.items()},
                {k: torch.from_numpy(v) for k, v in np_batch.items()})


def make_pair(arch, dtype="float32", seed=0, **replace) -> Pair:
    jcfg = jax_smoke_config(arch).replace(dtype=dtype, **replace)
    cfg = get_smoke_config(arch).replace(dtype=dtype, **replace)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    rng = np.random.default_rng(seed + 1)
    toks = rng.integers(0, cfg.vocab_size, (B, S + EXTRA)).astype(np.int32)
    extra = {}
    if cfg.family == "vlm":
        extra["patches"] = rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        extra["frames"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    return Pair(arch, jcfg, jparams, cfg, model, toks, extra)


def check_prefill(pair: Pair, tol=F32_TOL):
    """Prefill logits and every cache leaf (shape, dtype, values)."""
    jb, tb = pair.batch()
    jl, jc = JT.prefill(pair.jparams, jb, pair.jcfg)
    logits, cache = pair.model.prefill(tb)
    assert logits.shape == (B, pair.cfg.vocab_size)
    close(logits, jl, tol)
    assert sorted(cache) == sorted(jc)
    for key, leaf in jc.items():
        if key == "pos":
            assert cache["pos"] == int(leaf)
            continue
        assert tuple(cache[key].shape) == leaf.shape, key
        assert str(cache[key].dtype).split(".")[-1] == str(leaf.dtype), key
        close(cache[key], leaf, tol)
    return cache


def pad_cache(cache, extra, family):
    """tests/test_decode_continuation.py::_extend_dense_cache: room for
    ``extra`` more positions in the dense, moe and vlm leaves."""
    if family not in ("dense", "moe", "vlm"):
        return cache
    out = {}
    for k, v in cache.items():
        if hasattr(v, "ndim") and v.ndim >= 4:
            if torch.is_tensor(v):
                pads = [0, 0] * (v.ndim - 3) + [0, extra]
                v = torch.nn.functional.pad(v, pads)
            else:
                pads = [(0, 0)] * v.ndim
                pads[2] = (0, extra)
                v = jnp.pad(v, pads)
        out[k] = v
    return out


def decode_both(pair: Pair, start=S, stop=S + EXTRA):
    """Prefill of ``start`` tokens, then decode steps ``start..stop-1`` in
    both packages; returns (port logits, port cache, JAX logits, JAX
    cache).  encdec's prefill decodes a BOS first, so its steps feed the
    tokens from 0."""
    jb, tb = pair.batch(start)
    _, jc = JT.prefill(pair.jparams, jb, pair.jcfg)
    _, cache = pair.model.prefill(tb)
    n = stop - start
    jc = pad_cache(jc, n, pair.cfg.family)
    cache = pad_cache(cache, n, pair.cfg.family)
    first = 0 if pair.cfg.family == "encdec" else start
    jl = logits = None
    for t in range(first, first + n):
        jl, jc = JT.decode_step(pair.jparams, jc,
                                jnp.asarray(pair.toks[:, t]), pair.jcfg)
        logits, cache = pair.model.decode_step(
            cache, torch.from_numpy(pair.toks[:, t]))
    return logits, cache, jl, jc


def check_decode(pair: Pair, tol=F32_TOL, **kw):
    logits, cache, jl, jc = decode_both(pair, **kw)
    assert cache["pos"] == int(jc["pos"])
    close(logits, jl, tol)
    for key, leaf in jc.items():
        if key != "pos":
            close(cache[key], leaf, tol)
    return logits


def teacher_forced(pair: Pair, n):
    """The port's logits at position n - 1 of a full forward (vlm: after
    its patches; encdec: of the target stream [BOS, t0..t_{n-2}])."""
    model, extra = pair.model, pair.extra
    toks = torch.from_numpy(pair.toks[:, :n])
    if pair.cfg.family == "encdec":
        tgt = torch.cat([torch.zeros((B, 1), dtype=toks.dtype),
                         toks[:, :-1]], dim=1)
        hidden, _ = model.forward_hidden(
            None, frames=torch.from_numpy(extra["frames"]), tgt_tokens=tgt)
    else:
        hidden, _ = model.forward_hidden(
            toks, **{k: torch.from_numpy(v) for k, v in extra.items()})
    return model.logits(hidden[:, -1])


def check_forward_hidden(pair: Pair, tol=F32_TOL):
    """forward_hidden of both packages: hidden states and aux loss."""
    cfg = pair.cfg
    if cfg.family == "encdec":
        # equal source and target lengths (the blocked cross-attention's)
        tgt = pair.toks[:, :S]
        jh, jaux = JT.forward_hidden(
            pair.jparams, None, pair.jcfg,
            frames=jnp.asarray(pair.extra["frames"]),
            tgt_tokens=jnp.asarray(tgt))
        hidden, aux = pair.model.forward_hidden(
            None, frames=torch.from_numpy(pair.extra["frames"]),
            tgt_tokens=torch.from_numpy(tgt))
    else:
        jx = {k: jnp.asarray(v) for k, v in pair.extra.items()}
        tx = {k: torch.from_numpy(v) for k, v in pair.extra.items()}
        jh, jaux = JT.forward_hidden(pair.jparams, jnp.asarray(pair.toks),
                                     pair.jcfg, **jx)
        hidden, aux = pair.model.forward_hidden(torch.from_numpy(pair.toks),
                                                **tx)
    assert hidden.shape == jh.shape
    assert aux.dtype == torch.float32 and aux.shape == ()
    close(hidden, jh, tol)
    close(aux, jaux, tol)
    return float(aux)


def check_consumes_cache(pair: Pair):
    """decode_step writes the step into the given cache in place and
    returns those same tensors; every leaf it writes changes (encdec's
    cross K/V, empty here, are only read)."""
    model = pair.model
    cache = model.init_cache(B, S)
    before = {k: v.clone() for k, v in cache.items() if torch.is_tensor(v)}
    _, new = model.decode_step(cache, torch.from_numpy(pair.toks[:, 0]))
    assert cache["pos"] == 0 and new["pos"] == 1
    for key, old in before.items():
        assert new[key] is cache[key], key
        if old.numel():
            assert not torch.equal(cache[key], old), key


def drive(engine_cls, cfg, params, reject):
    """Three requests with max_queue 1, a capacity rejection and a shed
    deadline; returns (outputs, stats, shed flags, the shed request's id)."""
    eng = engine_cls(cfg, params, batch=2, capacity=24, max_queue=1)
    prompts = [np.arange(5) % cfg.vocab_size, np.arange(3, 10),
               np.arange(7, 11)]
    with pytest.raises(reject) as ei:
        eng.submit(prompts[0], max_new=20)          # 5 + 20 > 23 positions
    assert ei.value.reason == "capacity"
    eng.submit(prompts[0], max_new=6)
    eng.step()                                      # takes a slot
    eng.submit(prompts[1], max_new=5)
    eng.step()                                      # takes the other slot
    rid = eng.submit(prompts[2], max_new=4, deadline=3)   # waits
    with pytest.raises(reject) as ei:
        eng.submit(prompts[0], max_new=2)
    assert ei.value.reason == "queue_full"
    out = eng.run()
    shed = {r: q.shed for r, q in eng.requests.items()}
    return out, dict(eng.stats), shed, rid


def check_serve_engine(pair: Pair):
    from repro.admission import AdmissionRejected as JaxRejected
    want = drive(JaxServeEngine, pair.jcfg, pair.jparams, JaxRejected)
    got = drive(ServeEngine, pair.cfg, pair.model, AdmissionRejected)
    assert got == want
    out, stats, shed, rid = got
    assert shed[rid] and stats["shed"] == 1 and out[rid] == []
    assert all(len(out[r]) > 0 for r in out if r != rid)


def bf16_prefills(arch, seed=3):
    """(port bf16, JAX bf16, JAX float32) prefill logits on one set of
    weights and inputs."""
    pair = make_pair(arch, dtype="bfloat16", seed=seed)
    assert pair.cfg.dtype == "bfloat16"
    jb, tb = pair.batch()
    jl, _ = JT.prefill(pair.jparams, jb, pair.jcfg)
    jl32, _ = JT.prefill(pair.jparams, jb, pair.jcfg.replace(dtype="float32"))
    logits, _ = pair.model.prefill(tb)
    assert logits.dtype == torch.bfloat16
    return (logits.float().numpy(), np.asarray(jl.astype(jnp.float32)),
            np.asarray(jl32))
