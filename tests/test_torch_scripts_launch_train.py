"""The training CLI's twin, ``python -m repro_torch.launch.train``,
against ``python -m repro.launch.train`` on the CPU: from the reference's
initial weights (the two frameworks draw different numbers from one
seed, so the twin's fresh state is given the JAX package's
``init_train_state`` at its key) on the same batches, it prints the
reference's lines, the wall-clock numbers masked (tools/script_runs.py's
WALL_KEYS["launch_train"]: the step lines' ms and tok/s, the stragglers
and the median step); and with no ``--device`` it runs on the card,
raising without one."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from _torch_scripts import script_runs  # noqa: E402
from _torch_train import configs, jax_loop, optimizers  # noqa: E402
from repro.launch import train as ref_train  # noqa: E402
from repro_torch.launch import train as twin  # noqa: E402
from repro_torch.models.convert import train_state_from_jax  # noqa: E402
from repro_torch.train import loop  # noqa: E402

#: 12 steps print the lines of steps 0 and 10 and the summary; a
#: checkpoint every 5.  llama3-smoke (the CLI's default arch) with
#: microbatches 1, qwen3-moe-smoke (this family's routing and aux loss)
#: with 2
CASES = [["--arch", "llama3-8b"],
         ["--arch", "qwen3-moe-30b-a3b", "--microbatches", "2"]]
COMMON = ["--smoke", "--steps", "12", "--batch", "4", "--seq", "32",
          "--ckpt-every", "5"]


def _reference_init(monkeypatch, arch):
    """The twin's fresh train state holds the reference's initial
    weights (``init_train_state`` at ``PRNGKey(0)``, the CLI's)."""
    jcfg, cfg = configs(arch)
    jopt = optimizers(cfg)[0]
    jstate = jax.tree.map(np.asarray, jax_loop.init_train_state(
        jcfg, jopt, jax.random.PRNGKey(0)))
    fresh = loop.init_train_state

    def init(cfg, optimizer, device=None, generator=None):
        state = fresh(cfg, optimizer, device=device, generator=generator)
        return train_state_from_jax(jstate, state)

    monkeypatch.setattr(loop, "init_train_state", init)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[1])
def test_launch_train_lines_match(tmp_path, monkeypatch, case):
    argv = case + COMMON
    _reference_init(monkeypatch, case[1])
    out = []
    for mod, extra in ((ref_train, ["--ckpt-dir", str(tmp_path / "ref")]),
                       (twin, ["--ckpt-dir", str(tmp_path / "twin"),
                               "--device", "cpu"])):
        rc, text = script_runs.run_main(mod, argv + extra)
        out.append((rc, script_runs.masked_lines(text, "launch_train")))
    (rc_ref, ref), (rc, got) = out
    assert rc == rc_ref == 0
    assert got == ref
    assert ref[0].startswith("mesh: {'data': 1, 'model': 1}  arch: ")
    assert [line.split()[:2] for line in ref[1:3]] == [["step", "0"],
                                                      ["step", "10"]]
    assert ref[1].endswith(" * ms (* tok/s)")
    assert ref[-1].startswith("done: {'completed': 12, 'failures': 0, "
                              "'restores': 0, 'stragglers': *}; median "
                              "step * ms")


def test_launch_train_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        twin.main(["--smoke", "--steps", "1", "--ckpt-dir",
                   str(tmp_path)])
