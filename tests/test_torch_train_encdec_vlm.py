"""The port's training of the encdec and vlm families against the JAX
package on the CPU (tests/_torch_train.py): seamless-smoke (frames
through the bidirectional encoder, the decoder's causal self-attention
and its equal-length cross-attention) and llava-smoke (patch embeddings
in front of the text, the loss on the text positions alone), both AdamW,
in float32 on identical weights and batches: ``loss_and_metrics`` and
every gradient leaf with remat ``block`` and ``none``; three steps with
microbatches 1 and 2 (parameters within the AdamW bound of
``adamw_trajectory_bound``); train-state checkpoints both ways."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from _torch_train import (  # noqa: E402
    check_gradients, check_jax_checkpoint_in_port,
    check_port_checkpoint_in_jax, check_trajectory)

ARCHS = ["seamless-m4t-large-v2", "llava-next-mistral-7b"]


@pytest.mark.parametrize("remat", ["block", "none"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf(arch, remat):
    check_gradients(arch, remat)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_three_step_trajectory(arch, microbatches):
    losses = check_trajectory(arch, microbatches)
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_checkpoint_restored_by_port(tmp_path, arch):
    check_jax_checkpoint_in_port(tmp_path, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_restored_by_jax(tmp_path, arch):
    check_port_checkpoint_in_jax(tmp_path, arch)
