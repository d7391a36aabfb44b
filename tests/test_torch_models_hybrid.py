"""The port's hybrid family (RecurrentGemma: rglru, rglru, local
attention) against the JAX package, on the CPU.

``recurrentgemma-smoke`` (3 layers: one group; window 16) and a 5-layer
variant (one group and two remaining rglru blocks) in float32 on the JAX
package's weights (``params_from_jax``), with the same numpy-made tokens:
prefill logits and every cache leaf, ``forward_hidden``, 6
``decode_step``s past the 32-token prefill (the window's ring already
wrapped), the ``ServeEngine``'s tokens and stats, and a bf16 prefill.
Tolerances: 1e-4 in float32, 5e-2 in bf16.  Also: 16 decode steps to 3x
the window against JAX and against the port's own teacher-forced
forward, and ``linear_scan`` alone at lengths that are not a multiple of
its chunk.  Every prompt here is at most ``attn_chunk`` (1,024) long,
where the JAX package's window blocking is exact (ROADMAP §3).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from _torch_lm import (BF16_TOL, F32_TOL, bf16_prefills,  # noqa: E402
                       check_consumes_cache, check_decode,
                       check_forward_hidden, check_prefill,
                       check_serve_engine, close, decode_both, make_pair,
                       teacher_forced)
from repro.models import rglru as jrglru  # noqa: E402
from repro_torch.models import rglru  # noqa: E402

LAYERS = [3, 5]


@pytest.fixture(scope="module", params=LAYERS, ids=lambda n: f"{n}layers")
def pair(request):
    return make_pair("recurrentgemma-9b", n_layers=request.param)


def test_prefill_logits_and_every_cache_leaf(pair):
    cache = check_prefill(pair)
    rem = pair.cfg.n_layers % 3
    assert ("rem_lru_h" in cache) == bool(rem)
    assert cache["attn_k"].shape[2] == pair.cfg.window == 16


def test_forward_hidden_matches_jax(pair):
    assert check_forward_hidden(pair) == 0.0


def test_decode_continuation_matches_jax(pair):
    check_decode(pair)


def test_decode_step_consumes_its_cache(pair):
    check_consumes_cache(pair)


def test_serve_engine_identical_to_jax(pair):
    check_serve_engine(pair)


def test_bf16_prefill_errs_like_jax():
    """recurrentgemma-smoke's logits reach |28| (tied embeddings, softcap
    30), where bf16's step is 0.125: the JAX package's own bf16 prefill is
    0.18 from its float32 one, past 5e-2 (as mamba2-smoke's in
    test_torch_models.py).  So the port's bf16 prefill is held to the JAX
    package's own bf16 error against the float32 logits, and to twice it
    against JAX's bf16 logits; its mean error against JAX's bf16 logits
    stays within 5e-2."""
    got, jax_bf16, jax_f32 = bf16_prefills("recurrentgemma-9b")
    jax_err = np.abs(jax_bf16 - jax_f32).max()
    assert jax_err > BF16_TOL
    assert np.abs(got - jax_f32).max() <= 1.5 * jax_err
    close(got, jax_bf16, 2 * jax_err)
    assert np.abs(got - jax_bf16).mean() <= BF16_TOL


def test_window_ring_wraps_past_three_windows():
    """tests/test_decode_continuation.py::test_hybrid_window_ring_wraps:
    prefill 32 tokens, decode to 48 (3x the window): the ring's slots wrap
    and old tokens fall out of scope, in both packages alike, and the
    logits equal the teacher-forced logits of all 48 tokens."""
    pair = make_pair("recurrentgemma-9b", seed=2)
    assert pair.cfg.window == 16
    pair.toks = np.random.default_rng(2).integers(
        0, pair.cfg.vocab_size, (2, 48)).astype(np.int32)
    logits, cache, jl, jc = decode_both(pair, start=32, stop=48)
    assert cache["pos"] == 48
    close(logits, jl, F32_TOL)
    for key in ("attn_k", "attn_v", "lru_h", "lru_conv"):
        close(cache[key], jc[key], F32_TOL)
    close(logits, teacher_forced(pair, 48), F32_TOL)


@pytest.mark.parametrize("S,chunk", [(37, 16), (5, 16), (48, 16), (100, 32)])
def test_linear_scan_matches_jax(S, chunk):
    """The log-depth scan within chunks and the carry across them, with
    the inert padding of a ragged last chunk and its last real step."""
    rng = np.random.default_rng(S)
    B, W = 2, 8
    log_a = -rng.uniform(0.0, 0.5, (B, S, W)).astype(np.float32)
    b = rng.standard_normal((B, S, W)).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32)
    jh, jlast = jrglru.linear_scan(jnp.asarray(log_a), jnp.asarray(b),
                                   jnp.asarray(h0), chunk)
    h, last = rglru.linear_scan(torch.from_numpy(log_a), torch.from_numpy(b),
                                torch.from_numpy(h0), chunk)
    assert h.shape == (B, S, W) and last.shape == (B, W)
    close(h, jh, 1e-5)
    close(last, jlast, 1e-5)
    # the recurrence itself, step by step
    ref, hh = [], h0.astype(np.float64)
    for t in range(S):
        hh = np.exp(log_a[:, t].astype(np.float64)) * hh + b[:, t]
        ref.append(hh)
    close(h, np.stack(ref, axis=1), 1e-5)
