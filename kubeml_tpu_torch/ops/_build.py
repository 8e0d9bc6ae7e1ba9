"""Build the hand-written CUDA kernels (ops/csrc/*.cu) and load them.

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface under ``kubeml_tpu_torch/_build/``
(git-ignored), at first use, and loaded with ``ctypes``. No PyTorch
header is included, so a build takes seconds rather than minutes.

Calling convention of every C entry point: tensor pointers and the CUDA
stream are ``void*`` (``ctypes.c_void_p`` — never a plain int, which
ctypes would cut to 32 bits), sizes are ``int``, and the return value is
``cudaGetLastError()`` right after the launch; the Python wrapper raises
when it is not 0.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_load_seconds = 0.0   # wall time load() spent building and loading


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels build only where the CUDA toolkit is "
                       "installed")


def sources() -> list:
    """Names of every kernel source under csrc/ (file stems)."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named kernel sources (default: all of csrc/), one
    ``nvcc`` per source, all started together. Returns each source's
    compiler log (``-Xptxas -v``: registers, shared memory, spills).
    Raises RuntimeError naming every source that failed."""
    names = sources() if names is None else list(names)
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = CSRC_DIR / f"{name}.cu"
        if not src.is_file():
            raise FileNotFoundError(f"no kernel source {src}")
        # build under a per-process name and rename into place, so two
        # processes building at once never load a half-written library
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    logs, failed = {}, []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel source ``name``, building it first
    when it is missing or older than its source."""
    global _load_seconds
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            t0 = time.perf_counter()
            src, out = CSRC_DIR / f"{name}.cu", library_path(name)
            if not out.exists() or out.stat().st_mtime < src.stat().st_mtime:
                build([name])
            lib = ctypes.CDLL(str(out))
            _libs[name] = lib
            _load_seconds += time.perf_counter() - t0
        return lib


def load_seconds() -> float:
    """Seconds this process has spent in load() building and loading
    kernel libraries at their first use. A training job subtracts what an
    epoch spent here from the time its throughput policy sees."""
    with _lock:
        return _load_seconds
