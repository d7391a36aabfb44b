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
    "cluster/metrics.py",
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


#: the port's entry points beside their twins (each a copy with --device)
SCRIPTS = ["benchmarks/torch_cluster_load.py", "benchmarks/torch_overload.py",
           "benchmarks/torch_trace_replay.py", "examples/torch_pim_cluster.py",
           "examples/torch_serve_lm.py"]


def _port_files():
    # tools/make_workload_goldens.py imports the JAX package on purpose:
    # it writes the goldens the port is held to
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "benchmarks/torch_pim_figs.py",
                                         ROOT / "tools/torch_step_profile.py",
                                         ROOT / "tools/torch_lm_profile.py"] \
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
EXECUTED = ["chip_smoke.py", "benchmarks/torch_pim_figs.py"] + SCRIPTS


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


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    import repro_torch.workloads as wl
    from repro_torch.cluster import PimCluster, measure_profile
    from repro_torch.core import compile_cache, engine
    from repro_torch.core.config import DPUConfig
    from repro_torch.core.host import PIMSystem
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import transformer
    cfg = DPUConfig(n_dpus=1, n_tasklets=1, mram_bytes=1 << 14)
    lm = get_smoke_config("llama3-8b")
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
                  lambda: transformer.Transformer(lm),
                  lambda: transformer.init_cache(lm, 1, 8)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry()


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


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "deepseek-v3-671b",
                                  "recurrentgemma-9b",
                                  "seamless-m4t-large-v2",
                                  "llava-next-mistral-7b"])
def test_unported_families_name_their_roadmap_item(arch):
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import transformer
    cfg = get_smoke_config(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        transformer.Transformer(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        transformer.init_cache(cfg, 1, 8, device="cpu")


@pytest.mark.parametrize("name", ["cross_attn_project_kv", "cross_attn_decode",
                                  "mla_init", "mla_apply_train",
                                  "mla_apply_decode"])
def test_unported_attention_names_its_roadmap_item(name):
    from repro_torch.models import attention
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        getattr(attention, name)()
