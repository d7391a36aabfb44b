"""Port hygiene: repro_torch and chip_smoke.py import neither jax nor the
JAX package, the framework-neutral modules stay copies of their twins,
and every entry point defaults to the CUDA card without falling back."""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"

#: modules carried over from repro with only the import prefix changed
COPIES = [
    "core/isa.py", "core/config.py", "core/asm.py", "core/stats.py",
    "comm/__init__.py", "comm/topology.py", "comm/fabric.py",
    "comm/collectives.py", "faults/__init__.py", "faults/model.py",
    "faults/retry.py", "obs/__init__.py", "obs/tracer.py", "obs/profile.py",
    "sched/__init__.py", "sched/queue.py", "sched/scheduler.py",
    "sched/pipeline.py", "workloads/__init__.py", "workloads/base.py",
    "workloads/streaming.py", "workloads/search.py", "workloads/histo.py",
    "workloads/linalg.py", "workloads/graph.py", "workloads/sort.py",
    "faults/remap.py", "workloads/gemv_stream.py",
    "configs/base.py", "configs/deepseek_v3_671b.py", "configs/granite_3_8b.py",
    "configs/llama3_8b.py", "configs/llava_next_mistral_7b.py",
    "configs/mamba2_130m.py", "configs/nemotron_4_15b.py",
    "configs/qwen3_moe_30b_a3b.py", "configs/recurrentgemma_9b.py",
    "configs/seamless_m4t_large_v2.py", "configs/yi_34b.py",
    "admission/control.py", "admission/breaker.py", "admission/hedge.py",
    "admission/journal.py", "admission/__init__.py", "obs/report.py",
    "trace/__init__.py", "trace/record.py", "trace/replay.py",
    "serve/pim_pool.py", "cluster/__init__.py", "cluster/arrivals.py",
    "cluster/metrics.py", "data/pipeline.py",
]

#: cluster/scheduler.py is a copy but for its device: (the twin's lines,
#: normalised, -> the port's).  ``measure_profile`` takes ``device``
#: (None: the card, raising without one), keys its cache on it and
#: builds its reference rank there; a cluster measures on its own
#: system's device.
SCHEDULER_DEVICE_LINES = [
    ("                    mram_bytes: int = 1 << 21) -> JobProfile:\n",
     "                    mram_bytes: int = 1 << 21, device=None) -> "
     "JobProfile:\n"),
    ('    runs once per kind, every job replays the recording."""\n'
     "    key = (kind, n_dpus, n_threads, scale, seed, mram_bytes)\n",
     "    runs once per kind, every job replays the recording.  ``device`` is\n"
     "    the torch device the reference rank runs on: None means the CUDA "
     "card\n"
     "    and raises without one (as ``PIMSystem`` does); the cache keys on "
     "it,\n"
     '    so a profile measured on one device is never served for another."""\n'
     "    from repro_torch.core.compile_cache import resolve_device\n"
     "    device = resolve_device(device)\n"
     "    key = (kind, n_dpus, n_threads, scale, seed, mram_bytes, "
     "str(device))\n"),
    ("                                 mram_bytes=mram_bytes))\n",
     "                                 mram_bytes=mram_bytes), device=device)\n"),
    ("                    scale=self.profile_scale)\n",
     "                    scale=self.profile_scale, device=self.system.device)"
     "\n"),
]

#: runtime/coordinator.py is a copy but for the default checkpoint of
#: ``run_with_restarts`` and its ranks: (the twin's lines, normalised, ->
#: the port's).  A train state of the port holds a ``Transformer``, so the
#: default save and restore write and read it in the JAX package's layout
#: (``convert.train_state_{to,from}_jax``), which either package restores;
#: sharded, each rank hands the store its blocks and their specs
#: (``convert.train_state_specs``) and restores its own blocks; under
#: several ranks each step's outcome is agreed (a failure on any rank
#: restores every rank) and the monitor reads rank 0's wall clock.
COORDINATOR_CKPT_LINES = [
    ('"""Fault tolerance & straggler mitigation for 1000+ node fleets.\n',
     '"""Fault tolerance & straggler mitigation for 1000+ node fleets.\n'
     '\n'
     'The counterpart of ``repro.runtime.coordinator``: a copy but for the\n'
     'default checkpoint of :func:`run_with_restarts`, which writes a train\n'
     "state of the port in the JAX package's layout (:func:`_tree`), and for\n"
     'its ranks: under a process group of several ranks (a sharded state,\n'
     '``train.loop``) every rank takes the same action, so a failure on any\n'
     'rank restores every rank (:func:`_on_every_rank`) and the monitor reads\n'
     "rank 0's wall clock on each (:func:`_rank0`); each rank hands the store\n"
     'its blocks, which rank 0 gathers and writes, and restores its own blocks\n'
     '(``ckpt.store``).\n'),
    ('import numpy as np\n'
     '\n'
     'from repro_torch.ckpt import store\n',
     'import numpy as np\n'
     'import torch\n'
     'import torch.distributed as dist\n'
     '\n'
     'from repro_torch.ckpt import store\n'
     'from repro_torch.models import convert\n'
     '\n'
     '\n'
     'def _group() -> bool:\n'
     '    return dist.is_initialized() and dist.get_world_size() > 1\n'
     '\n'
     '\n'
     'def _flag(value, dtype) -> torch.Tensor:\n'
     '    """A one-element tensor where the group\'s backend takes it."""\n'
     '    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"\n'
     '    return torch.tensor([value], dtype=dtype, device=dev)\n'
     '\n'
     '\n'
     'def _on_every_rank(step_fn, step):\n'
     '    """``step_fn(step)``, raising :class:`WorkerFailure` on every rank\n'
     '    when it raised on any (one flag summed over the ranks)."""\n'
     '    failed = False\n'
     '    try:\n'
     '        step_fn(step)\n'
     '    except WorkerFailure:\n'
     '        failed = True\n'
     '    if _group():\n'
     '        flag = _flag(int(failed), torch.int64)\n'
     '        dist.all_reduce(flag)\n'
     '        failed = bool(flag.item())\n'
     '    if failed:\n'
     '        raise WorkerFailure(f"a rank failed at step {step}")\n'
     '\n'
     '\n'
     'def _rank0(seconds: float) -> float:\n'
     '    """Rank 0\'s ``seconds`` on every rank (each rank\'s own clock would\n'
     '    flag a straggler on some ranks and not others)."""\n'
     '    if not _group():\n'
     '        return seconds\n'
     '    t = _flag(seconds, torch.float64)\n'
     '    dist.broadcast(t, 0)\n'
     '    return float(t.item())\n'
     '\n'
     '\n'
     'def _tree(state, like: bool = False):\n'
     '    """What a checkpoint holds of ``state`` and the store\'s keywords that\n'
     '    place it: a train state of the port (``{"params": Transformer, "opt",\n'
     '    "step"}``) in the JAX package\'s layout (``convert.train_state_to_jax``),\n'
     "    so either package restores the other's checkpoints; sharded, as this\n"
     "    rank's blocks with their specs, which the store gathers to rank 0 to\n"
     '    write and restores as each rank\'s blocks; any other tree as it is."""\n'
     '    if isinstance(state, dict) and isinstance(state.get("params"),\n'
     '                                              torch.nn.Module):\n'
     '        model = state["params"]\n'
     '        kw = {}\n'
     '        if model.mesh is not None:\n'
     '            kw = {"shardings": {"state": convert.train_state_specs(state)},\n'
     '                  "mesh": model.mesh}\n'
     '            if like:\n'
     '                kw["device"] = model.device\n'
     '        return convert.train_state_to_jax(state, like), kw\n'
     '    return state, {}\n'
     '\n'
     '\n'
     'def _untree(tree, state):\n'
     '    """``state`` holding the restored ``tree`` (:func:`_tree`\'s inverse:\n'
     '    a port train state\'s weights are loaded into its model in place)."""\n'
     '    if isinstance(state, dict) and isinstance(state.get("params"),\n'
     '                                              torch.nn.Module):\n'
     '        return convert.train_state_from_jax(tree, state)\n'
     '    return tree\n'),
    ('        tree = {"state": state_ref["state"], "data": data.state_dict()}\n'
     '        store.save(ckpt_dir, step, tree)\n',
     '        state, kw = _tree(state_ref["state"])\n'
     '        tree = {"state": state, "data": data.state_dict()}\n'
     '        store.save(ckpt_dir, step, tree, **kw)\n'),
    ('        like = {"state": state_ref["state"], "data": data.state_dict()}\n'
     '        tree, step = store.restore(ckpt_dir, like)\n',
     '        state, kw = _tree(state_ref["state"], like=True)\n'
     '        like = {"state": state, "data": data.state_dict()}\n'
     '        tree, step = store.restore(ckpt_dir, like, **kw)\n'),
    ('        state_ref["state"] = tree["state"]\n',
     '        state_ref["state"] = _untree(tree["state"], state_ref["state"])\n'),
    ('            step_fn(step)\n',
     '            _on_every_rank(step_fn, step)\n'),
    ('        monitor.observe(time.perf_counter() - t0)\n',
     '        monitor.observe(_rank0(time.perf_counter() - t0))\n'),
]


#: the port's entry points beside their twins (each a copy with --device)
SCRIPTS = ["benchmarks/torch_cluster_load.py", "benchmarks/torch_overload.py",
           "benchmarks/torch_trace_replay.py", "examples/torch_pim_cluster.py",
           "examples/torch_serve_lm.py",
           "benchmarks/torch_engine_perf.py", "benchmarks/torch_comm_scaling.py",
           "benchmarks/torch_fault_tolerance.py",
           "benchmarks/torch_overlap_scaling.py",
           "benchmarks/torch_rank_overlap.py",
           "benchmarks/torch_pathfind_arch.py", "benchmarks/torch_run.py",
           "examples/torch_pim_characterize.py",
           "examples/torch_pim_comm_pathfind.py",
           "examples/torch_pim_arch_compare.py",
           "examples/torch_pim_async_pipeline.py",
           "examples/torch_pim_sample_sort.py",
           "examples/torch_quickstart.py",
           "examples/torch_pim_design_sweep.py",
           "examples/torch_pim_offload_planner.py",
           "benchmarks/torch_lm_hillclimb.py"]
#: how each study script of SCRIPTS starts with no device named: its
#: main() with its defaults, or (no main) its first bench at a small scale
STUDY_ENTRIES = {
    "benchmarks/torch_comm_scaling.py":
        lambda m: m.comm_strong_scaling(0.01),
    "benchmarks/torch_pathfind_arch.py": lambda m: m.compare(0.01),
}


def _port_files():
    # tools/make_workload_goldens.py imports the JAX package on purpose:
    # it writes the goldens the port is held to
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "benchmarks/torch_pim_figs.py",
                                         ROOT / "tools/torch_step_profile.py",
                                         ROOT / "tools/torch_lm_profile.py",
                                         ROOT / "tools/lm_prefill_ab.py",
                                         ROOT / "tools/torch_cluster_profiles.py",
                                         ROOT / "tools/script_runs.py"] \
        + [ROOT / s for s in SCRIPTS]


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, f"{path}: relative import"
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


#: the scripts the blocked-import test runs as modules (their main()
#: stays behind the __main__ check)
EXECUTED = ["chip_smoke.py", "benchmarks/torch_pim_figs.py",
            "tools/script_runs.py"] + SCRIPTS


def test_port_imports_with_jax_and_repro_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "for m in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[m] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        f"for f in {[str(ROOT / f) for f in EXECUTED]!r}:\n"
        "    spec = importlib.util.spec_from_file_location('m', f)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "assert len(names) > 20, names\n"
        "print('ok', len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _normalise(text: str) -> str:
    text = re.sub(r"\brepro\.", "repro_torch.", text)
    return text.replace("from repro import", "from repro_torch import")


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_matches_twin(rel):
    ref = (SRC / "repro" / rel).read_text()
    assert (PORT / rel).read_text() == _normalise(ref)


def test_scheduler_matches_twin_but_for_its_device_lines():
    ref = _normalise((SRC / "repro/cluster/scheduler.py").read_text())
    for twin, port in SCHEDULER_DEVICE_LINES:
        assert ref.count(twin) == 1, twin
        ref = ref.replace(twin, port)
    assert (PORT / "cluster/scheduler.py").read_text() == ref


def test_coordinator_matches_twin_but_for_its_checkpoint_lines():
    ref = _normalise((SRC / "repro/runtime/coordinator.py").read_text())
    for twin, port in COORDINATOR_CKPT_LINES:
        assert ref.count(twin) == 1, twin
        ref = ref.replace(twin, port)
    assert (PORT / "runtime/coordinator.py").read_text() == ref


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    import repro_torch.workloads as wl
    from repro_torch.cluster import PimCluster, measure_profile
    from repro_torch.core import compile_cache, engine
    from repro_torch.core.config import DPUConfig
    from repro_torch.core.host import PIMSystem
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer
    from repro_torch.optim import get_optimizer, warmup_cosine
    from repro_torch.train import loop as train_loop
    cfg = DPUConfig(n_dpus=1, n_tasklets=1, mram_bytes=1 << 14)
    # a config of every LM family: dense, moe (GQA and MLA), hybrid,
    # encdec, vlm
    lms = [get_smoke_config(a) for a in (
        "llama3-8b", "qwen3-moe-30b-a3b", "deepseek-v3-671b",
        "recurrentgemma-9b", "seamless-m4t-large-v2",
        "llava-next-mistral-7b")]
    binary = wl.get("VA").build(1).binary(cfg.iram_instrs)
    wram = np.zeros((1, 4), np.int32)
    mram = np.zeros((1, cfg.mram_words), np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PIMSystem(cfg).launch("VA", binary, wram, mram)
    for entry in (lambda: engine.make_step_traced(cfg),
                  lambda: engine.run(cfg, binary, wram, mram),
                  lambda: compile_cache.prepare(cfg, binary, wram, mram),
                  lambda: compile_cache.prewarm(cfg, binary),
                  # measured cluster profiles run on the card too
                  lambda: measure_profile("HST-S"),
                  lambda: PimCluster(PIMSystem(cfg), profiles="measured"),
                  # the LM serving path (ServeEngine runs where its model is)
                  *(lambda lm=lm: transformer.Transformer(lm) for lm in lms),
                  *(lambda lm=lm: transformer.init_cache(lm, 1, 8)
                    for lm in lms),
                  # training: a fresh train state lives on the card
                  lambda: train_loop.init_train_state(
                      lms[0], get_optimizer("adamw", warmup_cosine(1e-3))),
                  # the dry-run: its PIM cell runs on the card
                  lambda: dryrun.main(["--arch", "llama3-8b", "--out",
                                       "unused"]),
                  lambda: dryrun.run_pim_cell(n_dpus=4),
                  # its mesh rows (counted on meta) and the sharded engine
                  lambda: dryrun.run_pim_cell(multi_pod=False, n_dpus=512),
                  lambda: dryrun.run_pim_cell(multi_pod=True, n_dpus=512),
                  lambda: compile_cache.run_sharded(cfg, binary, wram, mram,
                                                    group=None)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry()


def test_fake_group_is_reachable_only_from_launch():
    """torch's ``fake`` process group stands in for the production meshes'
    ranks in the dry-run alone: only ``launch/`` names it."""
    pattern = re.compile(r"fake_pg|FakeStore|[\"']fake[\"']")
    users = sorted(str(p.relative_to(PORT)) for p in PORT.rglob("*.py")
                   if pattern.search(p.read_text()))
    assert users and all(u.startswith("launch/") for u in users), users


def test_parallel_entry_points_need_a_process_group():
    """The data-parallel step and the meshes run on the ranks of a
    process group (NCCL on the cards): without one they raise, before
    they compute anything."""
    from repro_torch.launch import mesh
    from repro_torch.optim import adamw
    from repro_torch.parallel.compress import make_dp_compressed_step
    from repro_torch.parallel.pipeline import pipeline_apply
    step = make_dp_compressed_step(lambda p, b: (p["w"] * b).sum(),
                                   adamw(lambda s: torch.tensor(0.1)))
    w = {"w": torch.ones(4)}
    for entry in (lambda: step(w, {}, w, torch.ones(4), 0),
                  lambda: pipeline_apply(lambda p, x: x, None,
                                         torch.ones(2, 3)),
                  lambda: mesh.make_elastic_mesh(),
                  lambda: mesh.make_production_mesh()):
        with pytest.raises((RuntimeError, ValueError),
                           match="process group"):
            entry()
    assert mesh.make_production_mesh.__kwdefaults__["device_type"] == "cuda"


@pytest.mark.parametrize("script", SCRIPTS[5:])
def test_study_scripts_default_to_the_card(script):
    """Each study twin runs on the card unless told otherwise: with no
    ``--device`` it raises without one, before it simulates anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    import importlib.util
    spec = importlib.util.spec_from_file_location(Path(script).stem,
                                                  ROOT / script)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    start = STUDY_ENTRIES.get(script, lambda m: m.main([]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        start(mod)


def test_unported_backends_name_their_roadmap_item():
    """Every backend of the reference is ported: the SIMT engine
    registers with the scalar one, the HBM-PIM targets load on first
    lookup (as in the reference)."""
    from repro_torch.core import backend
    from repro_torch.core.config import DPUConfig
    assert backend.names() == ("hbmpim", "hbmpim_cmd", "scalar", "simt")
    assert backend.resolve_backend(DPUConfig(simt_width=4)) == "simt"
    for name in backend.names():
        assert backend.get(name).name == name
    with pytest.raises(KeyError):
        backend.get("nope")
