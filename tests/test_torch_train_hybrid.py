"""The port's training of the hybrid family against the JAX package on
the CPU (tests/_torch_train.py): recurrentgemma-smoke (one (rglru, rglru,
local) group: the RG-LRU scan's gradient through autograd of the port's
log-depth scan, the windowed local attention, tied embeddings and the
logit soft-cap; AdamW) in float32 on identical weights and batches:
``loss_and_metrics`` and every gradient leaf with remat ``block`` and
``none``, also with the scan over several chunks, and ``linear_scan``'s
gradient against ``jax.grad``; three steps with microbatches 1 and 2 (parameters within the
AdamW bound of ``adamw_trajectory_bound``); train-state checkpoints both
ways.  The smoke window (16) is below ``attn_chunk``, so the CPU path's
blocked attention is exact window attention here (ROADMAP §3)."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from _torch_train import (  # noqa: E402
    check_gradients, check_jax_checkpoint_in_port,
    check_port_checkpoint_in_jax, check_trajectory)

ARCH = "recurrentgemma-9b"


@pytest.mark.parametrize("remat", ["block", "none"])
def test_loss_and_every_gradient_leaf(remat):
    check_gradients(ARCH, remat)


def test_gradient_across_scan_chunks():
    """The RG-LRU scan over several chunks (``ssm_chunk`` 8 at 32
    positions: four), where the carry from one chunk feeds the next, with
    remat ``none``: autograd keeps each chunk's carried state (an in-place
    write of the chunk outputs broke that backward; remat's recompute hid
    it)."""
    check_gradients(ARCH, "none", ssm_chunk=8)


@pytest.mark.parametrize("seq,chunk", [(64, 16), (70, 16)])
def test_linear_scan_gradient_matches_jax(seq, chunk):
    """``rglru.linear_scan``'s gradient (autograd of the chunked
    log-depth scan with its carry) against ``jax.grad`` of the JAX
    package's, float32, over several chunks, a ragged last one too."""
    import jax
    import numpy as np
    from repro.models import rglru as jax_rglru
    from repro_torch.models import rglru
    rng = np.random.default_rng(seq)
    la = -rng.uniform(0.0, 0.5, (2, seq, 8)).astype(np.float32)
    b = rng.standard_normal((2, seq, 8)).astype(np.float32)
    h0 = rng.standard_normal((2, 8)).astype(np.float32)
    w = rng.standard_normal((2, seq, 8)).astype(np.float32)

    def loss(la, b, h0):
        h, last = jax_rglru.linear_scan(la, b, h0, chunk)
        return (h * w).sum() + last.sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(la, b, h0)
    t = [torch.tensor(x, requires_grad=True) for x in (la, b, h0)]
    h, last = rglru.linear_scan(*t, chunk)
    got = torch.autograd.grad((h * torch.tensor(w)).sum() + last.sum(), t)
    for g, x in zip(got, want):
        x = np.asarray(x)
        assert np.abs(g.numpy() - x).max() <= 1e-5 * np.abs(x).max()


@pytest.mark.parametrize("microbatches", [1, 2])
def test_three_step_trajectory(microbatches):
    losses = check_trajectory(ARCH, microbatches)
    assert losses[-1] < losses[0]


def test_jax_checkpoint_restored_by_port(tmp_path):
    check_jax_checkpoint_in_port(tmp_path, ARCH)


def test_port_checkpoint_restored_by_jax(tmp_path):
    check_port_checkpoint_in_jax(tmp_path, ARCH)
