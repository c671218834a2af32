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
from typing import Callable, Dict, List

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

# name -> source, relative to this package
SOURCES: Dict[str, str] = {
    "flash_attention": "flash_attention/csrc/flash_attention.cu",
    "paged_attention": "paged_attention/csrc/paged_attention.cu",
    "rmsnorm": "rmsnorm/csrc/rmsnorm.cu",
    "vecavg": "vecavg/csrc/vecavg.cu",
}

_loaded: Dict[str, ctypes.CDLL] = {}

# libraries compiled by nvcc and loaded by ctypes in this process: what can
# recur after a run's warm-up (``analysis/sanitize.py`` counts them)
events: Dict[str, int] = {"builds": 0, "loads": 0}

# the active sanitizers' checks of a kernel's outputs (a ctypes launch is
# no aten op, so no dispatch mode sees what it writes)
output_checks: List[Callable] = []


def check_outputs(kernel: str, *outs) -> None:
    """Hand ``kernel``'s freshly written outputs to every active check (none
    outside a sanitizer: a loop over an empty list)."""
    for check in output_checks:
        check(kernel, outs)


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


def log_path(name: str) -> Path:
    """ptxas's report (``-Xptxas -v``) of ``name``'s last build."""
    return _target(name).with_suffix(".log")


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
        log_path(name).write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a reader never sees a half-written .so
        events["builds"] += 1
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
        events["loads"] += 1
    return lib
