"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every ``csrc/*.cu`` becomes its own shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/repro_torch/<hash>/lib<name>.so <name>.cu

One ``nvcc`` per source, all started together.  The output directory is
keyed by a hash of every source and header plus the flags, so an edited
source rebuilds and an unchanged one is loaded as it is.  Only the sources
in this package are compiled: no package of finished kernels, no
``torch.compile``.  Nothing is built when a module is imported; a wrapper
asks for its library the first time it launches on a CUDA tensor.
``--use_fast_math`` is deliberately absent (approximate division and
flush-to-zero would break the bit-exact quantizers).
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
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_ROOT = REPO_ROOT / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: float = 0.0          # wall time of the last build (0: cached)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _build_dir() -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every ``csrc/*.cu`` (in parallel) and load the libraries.
    Returns {source stem: CDLL}.  Raises with nvcc's output on failure."""
    global build_seconds
    with _lock:
        if _libs:
            return _libs
        out_dir = _build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = {}
        for src in _sources():
            lib = library_path(src.stem)
            if lib.exists():
                continue
            tmp = out_dir / f"lib{src.stem}.{os.getpid()}.tmp.so"
            log = open(out_dir / f"{src.stem}.log", "w")
            procs[src.stem] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                 str(src)], stdout=log, stderr=subprocess.STDOUT), tmp, lib,
                log)
        failed = []
        for stem, (proc, tmp, lib, log) in procs.items():
            rc = proc.wait()
            log.close()
            if rc != 0:
                failed.append((stem, (out_dir / f"{stem}.log").read_text()))
            else:
                os.replace(tmp, lib)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"--- {s} ---\n{t}" for s, t in failed))
        build_seconds = time.perf_counter() - t0 if procs else 0.0
        for src in _sources():
            _libs[src.stem] = ctypes.CDLL(str(library_path(src.stem)))
        return _libs


def ptxas_report() -> Dict[str, str]:
    """Registers/shared memory/spills per kernel, as ptxas printed them in
    the last build of each source ('' where the library was cached)."""
    out_dir = _build_dir()
    rep = {}
    for src in _sources():
        log = out_dir / f"{src.stem}.log"
        rep[src.stem] = log.read_text() if log.exists() else ""
    return rep


def library_path(stem: str) -> Path:
    """Where the shared library built from ``csrc/<stem>.cu`` lies."""
    return _build_dir() / f"lib{stem}.so"


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu``."""
    return build_all()[stem]
