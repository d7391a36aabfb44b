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
from pathlib import Path
from typing import Dict, Sequence

#: Hopper, with the ``a`` features (wgmma, setmaxnreg) enabled
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
#: one lock per library, so that different libraries build in parallel
_LOCKS: Dict[str, threading.Lock] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


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


def build_library(name: str, sources: Sequence[Path],
                  headers: Sequence[Path] = (),
                  flags: Sequence[str] = ()) -> Path:
    """Build ``lib<name>-<hash>.so`` from ``sources`` unless it is on disk
    already, and return its path (without loading it).

    ``headers`` only enter the hash; ``flags`` are added to
    :data:`NVCC_FLAGS` (and enter the hash).  What nvcc prints (e.g.
    ``-Xptxas -v``'s registers and spills) is kept beside the library in
    :func:`build_log`.  Raises ``RuntimeError`` when the build fails.
    Thread-safe; calls for different names build concurrently."""
    with _LOCK:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        return _build(name, sources, headers, flags)


def _build(name, sources, headers, flags) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(flags)).encode())
    for p in list(sources) + list(headers):
        h.update(Path(p).read_bytes())
    out_dir = build_dir()
    out = out_dir / f"lib{name}-{h.hexdigest()[:16]}.so"
    if not out.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, *flags, "-o", str(tmp),
               *[str(s) for s in sources]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {name} (rc {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    return out


def load_library(name: str, sources: Sequence[Path],
                 headers: Sequence[Path] = (),
                 flags: Sequence[str] = ()) -> ctypes.CDLL:
    """Build (if needed, :func:`build_library`) and load
    ``lib<name>-<hash>.so`` from ``sources``, once a process.  Raises
    ``RuntimeError`` when the build or the load fails.  Thread-safe;
    calls for different names build concurrently."""
    with _LOCK:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        out = _build(name, sources, headers, flags)
        try:
            lib = ctypes.CDLL(str(out))
        except OSError as e:
            raise RuntimeError(f"cannot load {out}: {e}") from e
        _LIBS[name] = lib
        return lib


def build_log(lib: ctypes.CDLL) -> str:
    """What nvcc printed when it built ``lib`` ("" if the library was
    built before logs were kept)."""
    log = Path(lib._name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
