"""The port's training of the moe family against the JAX package on the
CPU (tests/_torch_train.py): qwen3-moe-smoke (AdamW; top-k routing, the
masked combine and the switch aux loss through autograd) and
deepseek-v3-smoke (MLA, 1 dense + 2 MoE layers with a shared expert,
Adafactor on the stacked MoE leaves) in float32 on identical weights and
batches: ``loss_and_metrics`` (loss, xent, aux within 1e-5) and every
gradient leaf (within 1e-4 of its largest magnitude) with remat ``block``
and ``none``; three steps of ``make_train_step`` with microbatches 1 and
2 (metrics within 1e-5, parameters within the AdamW bound of
``adamw_trajectory_bound`` or 1e-4 under Adafactor, optimizer state
within 1e-4); train-state checkpoints both ways."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from _torch_train import (  # noqa: E402
    check_gradients, check_jax_checkpoint_in_port,
    check_port_checkpoint_in_jax, check_trajectory)

ARCHS = ["qwen3-moe-30b-a3b", "deepseek-v3-671b"]


@pytest.mark.parametrize("remat", ["block", "none"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf(arch, remat):
    metrics, _ = check_gradients(arch, remat)
    assert metrics["aux"] > 0          # the load-balance term is in play


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
