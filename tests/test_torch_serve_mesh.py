"""Sharded serving on a (data 2, model 4) mesh: the port on 8 gloo ranks
(``torch.multiprocessing`` with a ``FileStore``) against the JAX package
on 8 host devices (``tests/_torch_dist.py serve``, a process of its own),
float32, at the smoke widths of every family (``td.SERVE_ARCHS``): the
reference's weights (``convert.params_from_jax``) placed by
``param_shardings``, each rank's rows of the prompt by ``batch_rows``.

* Each rank's logits (its rows) after the prefill and after each of
  ``td.DECODE_STEPS`` decode steps within 1e-5 of the reference's (its
  sharded ``prefill`` and ``jax.jit(T.decode_step, in_shardings=...,
  out_shardings=(None, cache_sharding))``; qwen3-moe on both packages'
  expert-parallel branch).
* Each rank's block of every cache leaf after the last step within 1e-5
  of the reference's ``addressable_shards`` on the device of the same
  mesh coordinate: the sequence over ``model`` (the prompt's 32 positions
  and, for the dense, moe and vlm caches, ``td.DECODE_STEPS`` more of room,
  the port's ``prefill(capacity=...)`` and the reference's ``pad_cache``,
  10 a rank: the steps write on the last model rank),
  the ssm state's heads over ``model``, the hybrid's stacked (2, B) leaves
  as ``cache_sharding`` places them.
* llama3-smoke's decode from an empty cache of ``td.FRESH_CAPACITY``
  positions: its four writes land on the first model rank, whose partial
  softmax alone is not empty.
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

COORDS = [(d, m) for d in range(td.MESH["data"])
          for m in range(td.MESH["model"])]
TOL = 1e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax": the reference's arrays, "ranks": each rank's npz}."""
    out = tmp_path_factory.mktemp("serve")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, str(Path(td.__file__)), "serve",
                           str(out)], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    torch.multiprocessing.spawn(
        td.torch_serve_worker,
        args=(td.MESH_WORLD, str(out / "store"), str(out)),
        nprocs=td.MESH_WORLD, join=True)
    return {"jax": np.load(out / "jax_serve.npz"),
            "ranks": [np.load(out / f"serve_rank{r}.npz")
                      for r in range(td.MESH_WORLD)]}


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * max(np.abs(want).max(), 1.0))


def _rows(a, d):
    n = a.shape[0] // td.MESH["data"]
    return a[d * n:(d + 1) * n]


@pytest.mark.parametrize("arch", td.SERVE_ARCHS)
def test_logits_match_jax(runs, arch):
    j = runs["jax"]
    for got, (d, _) in zip(runs["ranks"], COORDS):
        for i in range(td.DECODE_STEPS + 1):
            _close(got[f"{arch}/logits/{i}"],
                   _rows(j[f"{arch}/logits/{i}"], d))


@pytest.mark.parametrize("arch", td.SERVE_ARCHS)
def test_cache_blocks_are_addressable_shards(runs, arch):
    j = runs["jax"]
    keys = sorted(k for k in j if k.startswith(f"{arch}/cache/"))
    assert keys
    for r, got in enumerate(runs["ranks"]):
        assert sorted(k for k in got if k.startswith(f"{arch}/cache/")) \
            == keys
        for k in keys:
            assert got[k].shape == j[k][r].shape, (k, r)
            _close(got[k], j[k][r])


def test_decode_from_an_empty_cache(runs):
    j = runs["jax"]
    for r, (got, (d, _)) in enumerate(zip(runs["ranks"], COORDS)):
        for i in range(1, td.DECODE_STEPS + 1):
            _close(got[f"fresh/logits/{i}"], _rows(j[f"fresh/logits/{i}"], d))
        for k in ("k", "v"):
            _close(got[f"fresh/cache/{k}"], j[f"fresh/cache/{k}"][r])
    # the steps wrote positions 0-3: the first model rank's block alone
    k = runs["ranks"][1]["fresh/cache/k"]
    assert not k.any() and runs["ranks"][0]["fresh/cache/k"][:, :, :4].any()
