"""repro_torch.parallel and repro_torch.launch.mesh against the JAX
package on the CPU.

* Sharding rules: ``resolve_spec``, ``param_logical_axes`` and the
  sharding functions give the reference's ``PartitionSpec`` entries for
  every parameter leaf of every architecture at full width (the port's
  per-layer tensors: the stacked leaf's spec without its layer entry), and
  for every cell's batch and decode cache, on the (16, 16) production mesh
  and the (2, 16, 16) pod mesh (``AbstractMesh``: no devices).
* ``quantize_int8`` bit for bit against the reference as its step runs it
  (jitted: XLA turns ``/ 127.0`` into a multiply by the float32
  reciprocal, where an eager JAX call divides), on exact .5 ties, a zero
  block and a ragged last block.
* Multi-rank: the port on a gloo group of 4 ranks (``torch.multiprocessing``
  with a ``FileStore`` in ``tmp_path``) against the JAX package on 4 of 16
  host devices (``tests/_torch_dist.py``, in a process of its own):
  ``compressed_psum`` (means and residuals within 1e-6), each step of
  ``make_dp_compressed_step`` on the reference's ``scenario_compressed_dp``
  problem from the reference's state before it (loss within 1e-5
  relative, parameters and moments within 1e-5 of their largest value,
  each rank's residuals within 1e-6), the port's own 60 steps through the
  reference scenario's gate, and ``pipeline_apply``'s outputs and
  gradients (within 1e-5 of ``jax.grad``'s); ``make_elastic_mesh``'s
  shapes for 1-16 devices and the meshes of a 4-rank group.

The free-running trajectories are not held step by step: float32 sums in
another order (7e-8 of the loss at step 0) grow through Adam near the
noise floor to ~1e-4 relative by step 57, so each step is held from the
reference's own state instead.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

import _torch_dist as td  # noqa: E402
from repro.configs.base import ARCH_IDS as REF_ARCHS  # noqa: E402
from repro.configs.base import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs.base import get_config as ref_config  # noqa: E402
from repro.launch import specs as ref_specs  # noqa: E402
from repro.parallel import api as ref_par  # noqa: E402
from repro.parallel.compress import quantize_int8 as ref_quantize  # noqa: E402
from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config  # noqa: E402
from repro_torch.launch import mesh as pt_mesh  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models.convert import leaf_key  # noqa: E402
from repro_torch.parallel import api as par  # noqa: E402
from repro_torch.parallel.compress import (dequantize_int8,  # noqa: E402
                                           quantize_int8)

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), dict(zip(axes, shape))


def _ref_specs(tree, mesh, fn):
    """``fn``'s NamedSharding tree as {leaf path: spec entries}."""
    flat, _ = ref_par._flatten_with_paths(fn(tree, mesh))
    return {path: tuple(s.spec) for path, s in flat}


def test_arch_ids_match():
    assert ARCH_IDS == REF_ARCHS and list(SHAPES) == list(REF_SHAPES)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, mesh_name):
    ref_mesh, mesh = _meshes(mesh_name)
    ref_params = ref_specs.abstract_params(ref_config(arch))
    want = _ref_specs(ref_params, ref_mesh, ref_par.param_shardings)
    shapes = dict(ref_par._flatten_with_paths(ref_params)[0])
    model = specs.abstract_params(get_config(arch))
    got = par.param_shardings(model, mesh)
    assert {leaf_key(n)[0] for n in got} == set(want)
    for name, spec in got.items():
        path, layer = leaf_key(name)
        ndim = len(shapes[path].shape)
        assert spec == (want[path][1:] if layer >= 0 else want[path]), name
        # the logical axes alone, as the reference derives them
        assert par.param_logical_axes(path, ndim) == \
            ref_par.param_logical_axes(path, ndim)
        assert par.resolve_spec(par.param_logical_axes(path, ndim),
                                shapes[path].shape, mesh) == want[path]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_match_reference(arch, mesh_name):
    ref_mesh, mesh = _meshes(mesh_name)
    cfg, ref_cfg = get_config(arch), ref_config(arch)
    for shape in SHAPES:
        if not cfg.supports_shape(SHAPES[shape]):
            continue
        ref_in = ref_specs.input_specs(ref_cfg, shape)
        got_in = specs.input_specs(cfg, shape)
        if SHAPES[shape].kind != "decode":
            want = _ref_specs(ref_in, ref_mesh, ref_par.batch_sharding)
            assert par.batch_sharding(got_in, mesh) == want, shape
            continue
        want = _ref_specs(ref_in["cache"], ref_mesh, ref_par.cache_sharding)
        assert par.cache_sharding(got_in["cache"], mesh) == want, shape
        want = tuple(ref_par.batch_sharding(ref_in["tokens"], ref_mesh).spec)
        assert par.batch_sharding(got_in["tokens"], mesh) == want


def test_resolve_spec_gates_divisibility():
    _, mesh = _meshes("2x16x16")
    for logical, shape in ((("dp", "tp_kv", None), (64, 8, 3)),
                           (("fsdp", "tp"), (4096, 32)),
                           (("ep", "sp", "dp"), (0, 48, 31))):
        assert par.resolve_spec(logical, shape, mesh) == tuple(
            ref_par.resolve_spec(logical, shape,
                                 AbstractMesh(*MESHES["2x16x16"])))
    assert par.resolve_spec(("dp", "tp_kv"), (64, 8), mesh) == \
        (("pod", "data"), None)


def test_shard_activation_is_a_noop():
    x = torch.ones(4, 6)
    assert par.shard_activation(x, ("dp", None)) is x
    with par.mesh_context({"data": 2, "model": 3}):
        assert par.current_mesh() == {"data": 2, "model": 3}
        assert par.shard_activation(x, ("dp", "tp")) is x
        assert par.named_sharding(("dp", "tp"), (4, 6)) == ("data", "model")
    assert par.current_mesh() is None


def _quantize_inputs():
    """Exact .5 ties (a block whose scale is exactly 1), a zero block,
    seeded normals, and a ragged last block."""
    rng = np.random.default_rng(3)
    ties = np.array([127.0, -126.5, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5]
                    * 32, np.float32)
    return np.concatenate([ties, np.zeros(256, np.float32),
                           rng.normal(size=256 * 40).astype(np.float32),
                           (rng.normal(size=77) * 1e3).astype(np.float32)])


def test_quantize_int8_bitwise():
    x = _quantize_inputs()
    q_ref, s_ref = jax.jit(ref_quantize)(jnp.asarray(x))
    q, s = quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    assert s[0] == 1.0 and s[1] == np.float32(1e-12)
    assert q[0, :8].tolist() == [127, -126, 2, -4, 0, 0, 2, 126]
    assert (q[1] == 0).all()
    np.testing.assert_array_equal(
        dequantize_int8(q, s, x.size).numpy(),
        np.asarray(q_ref, np.float32).__mul__(
            np.asarray(s_ref)[:, None]).reshape(-1)[:x.size])
    # an eager JAX call divides: its scales differ from the jitted ones
    # by an ulp in some blocks
    _, s_eager = ref_quantize(jnp.asarray(x))
    assert (np.asarray(s_eager) != s.numpy()).any()


def test_meshes_raise_without_a_group():
    for make in (lambda: pt_mesh.make_production_mesh(),
                 lambda: pt_mesh.make_production_mesh(multi_pod=True),
                 lambda: pt_mesh.make_elastic_mesh(),
                 lambda: pt_mesh.make_elastic_mesh(4),
                 lambda: pt_mesh.make_pipe_mesh(2)):
        with pytest.raises(RuntimeError, match="process group"):
            make()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' multi-rank runs: {"jax": npz, "ranks": [npz] * 4}."""
    out = tmp_path_factory.mktemp("dist")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, str(Path(td.__file__)), str(out)],
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    torch.multiprocessing.spawn(
        td.torch_worker, args=(td.WORLD, str(out / "store"), str(out)),
        nprocs=td.WORLD, join=True)
    return {"jax": np.load(out / "jax.npz"),
            "ranks": [np.load(out / f"rank{r}.npz")
                      for r in range(td.WORLD)]}


def test_compressed_psum_matches_reference(runs):
    j = runs["jax"]
    for r, got in enumerate(runs["ranks"]):
        for k in td.GRAD_SHAPES:
            np.testing.assert_allclose(got[f"mean_{k}"], j[f"mean_{k}"][r],
                                       rtol=0, atol=1e-6)
            np.testing.assert_allclose(got[f"res_{k}"], j[f"res_{k}"][r],
                                       rtol=0, atol=1e-6)


def test_dp_compressed_step_matches_each_step(runs):
    j = runs["jax"]
    for r, got in enumerate(runs["ranks"]):
        np.testing.assert_allclose(got["step_loss"], j["dp_losses"],
                                   rtol=1e-5, atol=0)
        for k in ("w", "m", "v"):
            want = j[f"dp_{k}"][1:]
            np.testing.assert_allclose(got[f"step_{k}"], want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
        np.testing.assert_allclose(got["step_res"], j["dp_res"][1:, r],
                                   rtol=0, atol=1e-6)


def test_dp_compressed_trajectory_passes_reference_gate(runs):
    """The reference scenario's own gate on the port's 60 steps: converged
    below 0.05, within 0.05 of the reference's last loss; every rank saw
    the same (averaged) losses."""
    got = runs["ranks"][0]["free_losses"]
    assert got[-1] < 0.05
    assert abs(got[-1] - runs["jax"]["dp_losses"][-1]) < 0.05
    for other in runs["ranks"][1:]:
        np.testing.assert_array_equal(other["free_losses"], got)


def test_pipeline_apply_matches_reference(runs):
    j = runs["jax"]
    inp = td.inputs()
    want = inp["xm"]
    for s in range(td.WORLD):
        want = td.stage_np(inp["ws"][s], want)
    for r, got in enumerate(runs["ranks"]):
        np.testing.assert_allclose(got["pipe_out"], j["pipe_out"], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(got["pipe_out"], want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(
            got["pipe_gw"], j["pipe_gw"][r], rtol=0,
            atol=1e-5 * np.abs(j["pipe_gw"]).max())
    # the input's gradient reaches stage 0 alone
    gx = [got["pipe_gx"] for got in runs["ranks"]]
    np.testing.assert_allclose(gx[0], j["pipe_gx"], rtol=0,
                               atol=1e-5 * np.abs(j["pipe_gx"]).max())
    assert not any(g.any() for g in gx[1:])


def test_elastic_mesh_shapes_match_reference(runs):
    want = runs["jax"]["elastic"]
    for n in range(1, td.N_DEV + 1):
        assert list(pt_mesh.elastic_shape(n).values()) == \
            want[n - 1].tolist(), n
    for got in runs["ranks"]:
        assert got["elastic"].tolist() == want[td.WORLD - 1].tolist()
        assert got["pipe_mesh"].tolist() == [td.WORLD]
