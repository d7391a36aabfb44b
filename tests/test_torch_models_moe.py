"""The port's moe family against the JAX package, on the CPU.

``qwen3-moe-smoke`` (GQA attention, 8 experts top-2) and
``deepseek-v3-smoke`` (MLA attention, one dense layer, 8 routed experts
top-2 and a shared one) in float32 on the JAX package's weights
(``params_from_jax``), with the same numpy-made tokens: prefill logits
and every cache leaf, ``forward_hidden`` with its MoE aux loss, 6
``decode_step``s past the prefill (cache padded as in
tests/test_decode_continuation.py), the ``ServeEngine``'s tokens and
stats, and a bf16 prefill.  Tolerances: 1e-4 in float32, 5e-2 in bf16.
Also: a zeroed router (all expert probabilities tied) selects experts
0..k-1, as ``jax.lax.top_k`` does, and MLA's absorbed-matrix decode
continues its materialised prefill.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_lm import (BF16_TOL, EXTRA, F32_TOL, S, bf16_prefills,  # noqa: E402
                       check_consumes_cache, check_decode,
                       check_forward_hidden, check_prefill,
                       check_serve_engine, close, decode_both, make_pair,
                       teacher_forced)
from repro.configs.base import get_smoke_config as jax_smoke_config  # noqa: E402,E501
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.convert import state_dict_from_jax  # noqa: E402

ARCHS = ["qwen3-moe-30b-a3b", "deepseek-v3-671b"]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return make_pair(request.param)


def test_prefill_logits_and_every_cache_leaf(pair):
    cache = check_prefill(pair)
    want = ({"ckv_d", "krope_d", "ckv_m", "krope_m", "pos"}
            if pair.cfg.use_mla else {"k_m", "v_m", "pos"})
    assert set(cache) == want


def test_forward_hidden_and_aux_match_jax(pair):
    aux = check_forward_hidden(pair)
    assert aux > 0.0        # the switch-style load-balance loss


def test_decode_continuation_matches_jax(pair):
    check_decode(pair)


def test_decode_step_consumes_its_cache(pair):
    check_consumes_cache(pair)


def test_serve_engine_identical_to_jax(pair):
    check_serve_engine(pair)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_matches_jax(arch):
    got, want, _ = bf16_prefills(arch)
    close(got, want, BF16_TOL)


def test_mla_absorbed_decode_continues_materialised_prefill():
    """deepseek's decode attends in the latent space (W^UK / W^UV absorbed
    into q and o); its logits after 6 steps equal the teacher-forced
    logits of the materialised-KV forward over all S + 6 tokens."""
    pair = make_pair("deepseek-v3-671b")
    assert pair.cfg.use_mla
    logits, cache, _, _ = decode_both(pair)
    assert cache["pos"] == S + EXTRA
    close(logits, teacher_forced(pair, S + EXTRA), F32_TOL)


def _moe_params(cfg):
    """One MoE layer's JAX parameters with a zeroed router, and the same
    tensors as the port's nested dict."""
    jp = jmoe.moe_init(jax.random.PRNGKey(5), cfg)
    jp["router"] = jnp.zeros_like(jp["router"])
    tree = {}
    for key, v in state_dict_from_jax(
            {"moe": jax.tree.map(np.asarray, jp)}).items():
        node = tree
        parts = key.split(".")[1:]
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return jp, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_tied_router_picks_experts_like_jax(arch):
    """moe_apply alone with a zeroed router: every expert's probability
    ties, and both packages route each token to experts 0..k-1 (equal
    gates), so their outputs and aux losses agree."""
    jcfg = jax_smoke_config(arch).replace(dtype="float32")
    cfg = get_smoke_config(arch).replace(dtype="float32")
    jp, tp = _moe_params(jcfg)
    x = np.random.default_rng(7).standard_normal(
        (2, 5, cfg.d_model)).astype(np.float32)
    jout, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    out, aux = moe.moe_apply(tp, torch.from_numpy(x), cfg)
    close(out, jout, F32_TOL)
    close(aux, jaux, F32_TOL)
    k, E = cfg.experts_per_token, cfg.n_experts
    probs = torch.full((2, 5, E), 1.0 / E)
    _, idx = moe.top_k(probs, k)
    _, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), k)
    assert idx.tolist() == np.asarray(jidx).tolist()
    assert (idx == torch.arange(k)).all()
