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
    "sched/pipeline.py", "workloads/streaming.py",
]


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "tools/torch_step_profile.py"]


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
        "spec = importlib.util.spec_from_file_location('chip_smoke', "
        f"{str(ROOT / 'chip_smoke.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
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


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    import repro_torch.workloads as wl
    from repro_torch.core import compile_cache, engine
    from repro_torch.core.config import DPUConfig
    from repro_torch.core.host import PIMSystem
    cfg = DPUConfig(n_dpus=1, n_tasklets=1, mram_bytes=1 << 14)
    binary = wl.get("VA").build(1).binary(cfg.iram_instrs)
    wram = np.zeros((1, 4), np.int32)
    mram = np.zeros((1, cfg.mram_words), np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PIMSystem(cfg).launch("VA", binary, wram, mram)
    for entry in (lambda: engine.make_step_traced(cfg),
                  lambda: engine.run(cfg, binary, wram, mram),
                  lambda: compile_cache.prepare(cfg, binary, wram, mram),
                  lambda: compile_cache.prewarm(cfg, binary)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry()


def test_unported_backends_name_their_roadmap_item():
    from repro_torch.core import backend
    from repro_torch.core.config import DPUConfig
    assert backend.get("scalar").name == "scalar"
    assert backend.names() == ("hbmpim", "hbmpim_cmd", "scalar", "simt")
    assert backend.resolve_backend(DPUConfig(simt_width=4)) == "simt"
    for name in ("simt", "hbmpim", "hbmpim_cmd"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            backend.get(name)
    with pytest.raises(KeyError):
        backend.get("nope")
