"""Sharded training of the ssm, hybrid, encdec and vlm families on a
(data 2, model 4) mesh: the port on 8 gloo ranks (tensor and sequence
parallel on ``model``) against the JAX package on 8 host devices
(``tests/_torch_dist.py families``, a process of its own), float32, at the
smoke widths of mamba2-130m, recurrentgemma-9b, seamless-m4t-large-v2 and
llava-next-mistral-7b (``td.FAMILY_ARCHS``; tests/test_torch_mesh.py holds
llama3, qwen3-moe and deepseek): from the reference's initial parameters
and the same synthetic batch, every rank's loss within 1e-5 relative of
the reference's sharded loss, and every leaf's gradient, gathered whole,
within 1e-4 of the largest value of ``jax.grad``'s.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import _torch_dist as td  # noqa: E402


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("families")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, str(Path(td.__file__)),
                           "families", str(out)], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    torch.multiprocessing.spawn(
        td.torch_families_worker,
        args=(td.MESH_WORLD, str(out / "store"), str(out)),
        nprocs=td.MESH_WORLD, join=True)
    return {"jax": np.load(out / "jax_families.npz"),
            "ranks": [np.load(out / f"families_rank{r}.npz")
                      for r in range(td.MESH_WORLD)]}


@pytest.mark.parametrize("arch", td.FAMILY_ARCHS)
def test_sharded_loss_and_grads_match_jax(runs, arch):
    j = runs["jax"]
    loss = float(j[f"{arch}/loss"])
    for got in runs["ranks"]:
        assert abs(float(got[f"{arch}/loss"]) - loss) <= 1e-5 * abs(loss)
    got = runs["ranks"][0]
    keys = [k for k in j.files if k.startswith(f"{arch}/grad/")]
    assert len(keys) > 10 and sorted(keys) == sorted(
        k for k in got.files if k.startswith(f"{arch}/grad/"))
    for k in keys:
        want = j[k]
        np.testing.assert_allclose(
            got[k], want, rtol=0,
            atol=1e-4 * max(np.abs(want).max(), 1e-30), err_msg=k)
