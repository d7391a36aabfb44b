"""The training CLI on several ranks: ``python -m repro_torch.launch.train
--smoke --device cpu`` on 4 gloo ranks (``torch.multiprocessing``, a
``FileStore``) against ``python -m repro.launch.train --smoke`` on 4 host
devices (``XLA_FLAGS`` set in its own process; ``tests/_torch_dist.py``),
from the reference's initial train state (the two frameworks draw
different numbers from one seed).  Both build ``make_elastic_mesh()``,
``{'data': 1, 'model': 4}``, place the state by ``param_shardings`` and
each batch by ``batch_sharding`` (qwen3-moe-smoke's 8 experts 2 a rank,
expert-parallel), and print the same lines, the wall-clock numbers
masked (tools/script_runs.py's WALL_KEYS["launch_train"]); rank 0 alone
prints."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import _torch_dist as td  # noqa: E402
from _torch_scripts import script_runs  # noqa: E402

COMMON = ["--smoke", "--steps", "12", "--batch", "4", "--seq", "32",
          "--ckpt-every", "5"]
CASES = [["--arch", "llama3-8b"],
         ["--arch", "qwen3-moe-30b-a3b", "--microbatches", "2"]]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[1])
def test_launch_train_on_four_ranks_matches(tmp_path, case):
    argv = case + COMMON
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, str(Path(td.__file__)), "cli",
                           str(tmp_path)] + argv, capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    torch.multiprocessing.spawn(
        td.torch_cli_worker,
        args=(td.CLI_WORLD, str(tmp_path / "store"), str(tmp_path), argv),
        nprocs=td.CLI_WORLD, join=True)
    ref, got = (script_runs.masked_lines(
        (tmp_path / f"cli_{p}.txt").read_text(), "launch_train")
        for p in ("jax", "torch"))
    assert got == ref
    assert ref[0].startswith("mesh: {'data': 1, 'model': 4}  arch: ")
    assert [line.split()[:2] for line in ref[1:3]] == [["step", "0"],
                                                      ["step", "10"]]
    assert ref[-1].startswith("done: {'completed': 12, 'failures': 0, ")
