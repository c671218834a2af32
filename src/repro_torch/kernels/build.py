"""Build the port's CUDA kernels with nvcc at first use, bind them with ctypes.

Each source under ``kernels/<name>/csrc/`` is compiled on its own into a
shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
        -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so <source>

into ``build/`` at the root of the checkout (listed in ``.gitignore``),
keyed by a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. :func:`build_all` starts
one nvcc per source, all together. A failed build raises with nvcc's
output; nothing falls back to a plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

# name -> source, relative to this package
SOURCES: Dict[str, str] = {
    "paged_attention": "paged_attention/csrc/paged_attention.cu",
}

_loaded: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH)")
    return found


def _target(name: str) -> Path:
    src = _PKG / SOURCES[name]
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{h}.so"


def build_all(names: List[str] | None = None) -> Dict[str, float]:
    """Compile every stale library in parallel (one nvcc each); returns the
    seconds each build took (0.0 for a library already built). ptxas's
    register and shared-memory report goes to ``<lib>.log``."""
    names = list(SOURCES) if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    secs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            secs[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path()] + NVCC_FLAGS + ["-o", str(tmp), str(_PKG / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a reader never sees a half-written .so
    if failed:
        raise KernelBuildError("\n".join(failed))
    return secs


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The library for ``name``, built first if needed, with each C
    function's ``(argtypes, restype)`` from ``signatures`` declared (once
    per process)."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _loaded[name] = lib
    return lib
