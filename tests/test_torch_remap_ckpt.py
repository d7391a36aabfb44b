"""The port's remap recovery (repro_torch.faults.remap) and checkpoint
store (repro_torch.ckpt.store) against the JAX package on the CPU: the
kernel-level scenarios of tests/test_faults.py (spare lanes,
checkpointed re-execution) at smaller sizes give identical reports,
fault logs, Timelines and states, and a checkpoint written by either
package restores in the other.  Workloads killed mid-run are in
test_torch_remap_histo.py and test_torch_remap_graph_sort.py."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.workloads as ref_wl  # noqa: E402
import repro_torch.workloads as pt_wl  # noqa: E402
from repro.ckpt import store as ref_store  # noqa: E402
from repro.core.host import PIMSystem as RefSystem  # noqa: E402
from repro.faults import FaultPlan as RefPlan  # noqa: E402
from repro.faults import kill_dpu as ref_kill  # noqa: E402
from repro.faults.remap import launch_with_remap as ref_remap  # noqa: E402
from repro_torch.ckpt import store as pt_store  # noqa: E402
from repro_torch.core.carry import config_from  # noqa: E402
from repro_torch.core.host import PIMSystem as PtSystem  # noqa: E402
from repro_torch.faults import FaultPlan as PtPlan  # noqa: E402
from repro_torch.faults import kill_dpu as pt_kill  # noqa: E402
from repro_torch.faults.remap import launch_with_remap as pt_remap  # noqa: E402
from test_torch_workloads import (_assert_report, _assert_state,  # noqa: E402
                                  _assert_timeline, _small_cfg)

#: HST-S at one tasklet: its per-tasklet bins make it cheapest there
T = 1


def _hst(cfg):
    """HST-S's kernel inputs and both packages' binaries of it."""
    hd = ref_wl.get("HST-S").host_data(cfg, scale=0.001, seed=0)
    ref_bin = ref_wl.get("HST-S").build(T).binary(cfg.iram_instrs)
    pt_bin = pt_wl.get("HST-S").build(T).binary(cfg.iram_instrs)
    return hd, ref_bin, pt_bin


def _same_systems(ref_sys, pt_sys):
    _assert_timeline(ref_sys.timeline, pt_sys.timeline)
    assert [(f.kind, f.dpus, f.launch) for f in ref_sys.fault_log] == \
        [(f.kind, f.dpus, f.launch) for f in pt_sys.fault_log]
    assert list(ref_sys.active_mask) == list(pt_sys.active_mask)


def test_remap_with_spares_matches_reference():
    """4 worker shards on a 6-lane system with 2 spares: the dead lane's
    shard lands on a spare (a 4-of-6 subset launch, then a 1-lane one)."""
    cfg4, cfg6 = _small_cfg(T, n_dpus=4), _small_cfg(T, n_dpus=6)
    hd, ref_bin, pt_bin = _hst(cfg4)
    args = np.zeros((6, hd.args.shape[1]), np.int32)
    mram = np.zeros((6, hd.mram.shape[1]), np.int32)
    args[:4], mram[:4] = hd.args, hd.mram
    out = []
    for system, launch, binary in (
            (RefSystem(cfg6, faults=RefPlan(events=(ref_kill(1, 0),))),
             ref_remap, ref_bin),
            (PtSystem(config_from(cfg6), device="cpu",
                      faults=PtPlan(events=(pt_kill(1, 0),))),
             pt_remap, pt_bin)):
        st, rep = launch(system, "HST-S", binary, args, mram, n_threads=T,
                         dpus=[0, 1, 2, 3], spares=[4, 5])
        assert hd.check(np.asarray(st["mram"])[:4])
        out.append((system, st, rep))
    (ref_sys, ref_st, ref_rep), (pt_sys, pt_st, pt_rep) = out
    _assert_report(ref_rep, pt_rep)
    _assert_state({k: np.asarray(v) for k, v in ref_st.items()}, pt_st)
    _same_systems(ref_sys, pt_sys)
    assert not pt_sys.active_mask[1]


def test_remap_checkpoint_roundtrip_matches_reference(tmp_path):
    """ckpt_dir= snapshots the launch inputs and re-executes the lost
    shard from the restored image; both packages write the same files."""
    cfg = _small_cfg(T, n_dpus=4)
    hd, ref_bin, pt_bin = _hst(cfg)
    out = []
    for tag, system, launch, binary in (
            ("ref", RefSystem(cfg, faults=RefPlan(events=(ref_kill(2, 0),))),
             ref_remap, ref_bin),
            ("pt", PtSystem(config_from(cfg), device="cpu",
                            faults=PtPlan(events=(pt_kill(2, 0),))),
             pt_remap, pt_bin)):
        st, rep = launch(system, "HST-S", binary, hd.args, hd.mram,
                         n_threads=T, ckpt_dir=str(tmp_path / tag))
        assert hd.check(np.asarray(st["mram"]))
        out.append((system, st, rep))
    (ref_sys, ref_st, ref_rep), (pt_sys, pt_st, pt_rep) = out
    _assert_report(ref_rep, pt_rep)
    _assert_state({k: np.asarray(v) for k, v in ref_st.items()}, pt_st)
    _same_systems(ref_sys, pt_sys)
    files = {tag: sorted(str(p.relative_to(tmp_path / tag))
                         for p in (tmp_path / tag).rglob("*"))
             for tag in ("ref", "pt")}
    assert files["ref"] == files["pt"] and "LATEST" in files["pt"]
    step = ref_store.latest_step(str(tmp_path / "ref"))
    assert pt_store.latest_step(str(tmp_path / "pt")) == step
    man = [json.loads((tmp_path / tag / f"step_{step}" / "manifest.json")
                      .read_text()) for tag in ("ref", "pt")]
    assert man[0] == man[1]


def _tree(rng):
    return {"args": rng.integers(-9, 9, (4, 3)).astype(np.int32),
            "opt": {"mu": rng.standard_normal((2, 5)).astype(np.float32),
                    "count": np.int32(7)},
            "flags": [rng.integers(0, 2, 6).astype(bool),
                      rng.integers(0, 9, (2,)).astype(np.int64)],
            "step": 3}


def test_flatten_names_leaves_like_reference():
    tree = _tree(np.random.default_rng(0))
    ref_flat, _ = ref_store._flatten(tree)
    assert list(pt_store._flatten(tree)) == list(ref_flat)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_restores_in_the_other_package(tmp_path, writer):
    tree = _tree(np.random.default_rng(1))
    save, restore = ((ref_store.save, pt_store.restore) if writer == "jax"
                     else (pt_store.save, ref_store.restore))
    like = tree
    if writer == "torch":   # the port saves tensors as well as arrays
        tree = dict(tree, args=torch.from_numpy(tree["args"]))
    save(str(tmp_path), 5, tree)
    got, step = restore(str(tmp_path), like)
    assert step == 5 and got["step"] == 3
    want = _tree(np.random.default_rng(1))
    for key in ("args",):
        assert np.array_equal(np.asarray(got[key]), want[key])
    assert np.asarray(got["opt"]["mu"]).tobytes() == \
        want["opt"]["mu"].tobytes()
    assert int(got["opt"]["count"]) == 7
    for a, b in zip(got["flags"], want["flags"]):
        assert np.asarray(a).dtype == b.dtype
        assert np.array_equal(np.asarray(a), b)


def test_restore_places_tensors_where_like_lives(tmp_path):
    tree = _tree(np.random.default_rng(2))
    ref_store.save(str(tmp_path), 1, tree)
    like = dict(tree, args=torch.zeros(4, 3, dtype=torch.int32))
    got, _ = pt_store.restore(str(tmp_path), like)
    assert isinstance(got["args"], torch.Tensor)
    assert got["args"].device.type == "cpu"
    assert got["args"].dtype == torch.int32
    assert torch.equal(got["args"], torch.from_numpy(tree["args"]))
    assert isinstance(got["opt"]["mu"], np.ndarray)
    assert isinstance(got["flags"], list) and got["step"] == 3
    with pytest.raises(ValueError, match="shape"):
        pt_store.restore(str(tmp_path),
                         dict(like, args=torch.zeros(2, 3)))
