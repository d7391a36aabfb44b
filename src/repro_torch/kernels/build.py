"""Build a kernel's CUDA sources into a shared library and load it.

Every CUDA kernel of the port has a plain C interface (``extern "C"``
launchers taking raw pointers, sizes and a stream) and no PyTorch
headers, so ``nvcc`` builds it in seconds and :mod:`ctypes` binds it.
The library is built at first use into ``build/repro_torch/`` at the
root of the checkout (override with ``REPRO_TORCH_BUILD_DIR``), under a
name that carries a hash of the sources and flags: an edited source
builds anew, an unchanged one is reused.

Nothing here runs at import time: the CPU tests import every module of
the port on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

#: Hopper, with the ``a`` features (wgmma, setmaxnreg) enabled
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: library name -> seconds its nvcc build took (0.0 when reused)
BUILD_SECONDS: Dict[str, float] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/build.py -> the checkout's root
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels of repro_torch are built from "
            "source at first use")
    return found


def load_library(name: str, sources: Sequence[Path],
                 headers: Sequence[Path] = ()) -> ctypes.CDLL:
    """Build (if needed) and load ``lib<name>-<hash>.so`` from ``sources``.

    ``headers`` only enter the hash.  Raises ``RuntimeError`` when the
    build or the load fails."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for p in list(sources) + list(headers):
            h.update(Path(p).read_bytes())
        out_dir = build_dir()
        out = out_dir / f"lib{name}-{h.hexdigest()[:16]}.so"
        secs = 0.0
        if not out.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                   *[str(s) for s in sources]]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            secs = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {name} (rc {proc.returncode}):\n"
                    f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        try:
            lib = ctypes.CDLL(str(out))
        except OSError as e:
            raise RuntimeError(f"cannot load {out}: {e}") from e
        BUILD_SECONDS[name] = secs
        _LIBS[name] = lib
        return lib
