"""The port's encdec (seamless: bidirectional encoder, causal decoder with
cross-attention) and vlm (llava: patch embeddings in front of the text)
families against the JAX package, on the CPU.

``seamless-smoke`` and ``llava-smoke`` in float32 on the JAX package's
weights (``params_from_jax``), with the same numpy-made tokens, frames
(B, 32, D) and patches (B, 8, D): prefill logits and every cache leaf
(encdec's prefill encodes the frames and decodes one BOS),
``forward_hidden`` (encdec at equal source and target lengths, the only
ones the blocked cross-attention takes), 6 ``decode_step``s past the
prefill, the ``ServeEngine``'s tokens and stats (encdec's engine cache
has no encoder positions, ``src_len`` 0, in both packages), and a bf16
prefill.  Tolerances: 1e-4 in float32, 5e-2 in bf16.  Also: encdec's BOS
prefill then teacher-forced decoding equals the full forward.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from _torch_lm import (B, BF16_TOL, F32_TOL, S, bf16_prefills,  # noqa: E402
                       check_consumes_cache, check_decode,
                       check_forward_hidden, check_prefill,
                       check_serve_engine, close, make_pair,
                       teacher_forced)

ARCHS = ["seamless-m4t-large-v2", "llava-next-mistral-7b"]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return make_pair(request.param)


def test_prefill_logits_and_every_cache_leaf(pair):
    cache = check_prefill(pair)
    if pair.cfg.family == "encdec":
        assert cache["pos"] == 1                    # the BOS step
        assert cache["cross_k"].shape[2] == cache["self_k"].shape[2] == S
    else:
        assert cache["pos"] == pair.cfg.n_frontend_tokens + S


def test_forward_hidden_matches_jax(pair):
    assert check_forward_hidden(pair) == 0.0


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


def test_encdec_teacher_forced_decoding():
    """tests/test_models.py::test_decode_matches_teacher_forcing: after the
    BOS prefill, feeding t0..t_{S-2} reaches the logits of the full
    forward of [BOS, t0..t_{S-2}] over the same frames."""
    pair = make_pair("seamless-m4t-large-v2", seed=4)
    _, tb = pair.batch()
    logits, cache = pair.model.prefill(tb)
    for t in range(S - 1):
        logits, cache = pair.model.decode_step(
            cache, torch.from_numpy(pair.toks[:, t]))
    assert cache["pos"] == S
    assert logits.shape == (B, pair.cfg.vocab_size)
    close(logits, teacher_forced(pair, S), F32_TOL)


def test_encdec_engine_cross_memory_is_empty():
    """The engine's cache (``init_cache`` with ``src_len`` 0, as the JAX
    engine builds it) holds no encoder positions, and cross-attention
    over it adds zeros: a decode step equals one whose cross-attention
    weights are zeroed."""
    pair = make_pair("seamless-m4t-large-v2")
    model = pair.model
    cache = model.init_cache(B, 8)
    assert cache["cross_k"].shape == (pair.cfg.n_dec_layers, B, 0,
                                      pair.cfg.n_kv_heads, pair.cfg.d_head)
    tok = torch.from_numpy(pair.toks[:, 0])
    logits, _ = model.decode_step(cache, tok)
    assert torch.isfinite(logits).all()
    for p in model.dec_blocks:
        p["cross_attn"]["wo"].data.zero_()
    again, _ = model.decode_step(model.init_cache(B, 8), tok)
    close(again, logits.numpy(), 0.0)
