"""Build the package's CUDA sources into shared libraries and load them.

Each ``csrc/*.cu`` file has a plain C interface.  It is compiled with
``nvcc`` for ``sm_90a`` into ``build/`` inside this package, once per
digest of source and flags, and loaded with ctypes.  ``build_all`` starts
one ``nvcc`` per source at the same time, so a run that needs every kernel
pays for the slowest build only.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
# --fmad=false: no multiply-add pair is contracted into an FMA, so the
# kernels keep the plain versions' float32 rounding step for step
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v")

# nvcc's output per source name (ptxas lists registers and shared memory);
# empty for a library that was already built
build_logs: Dict[str, str] = {}
_libs: Dict[str, ctypes.CDLL] = {}


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}_{digest}.so"


def build_all(sources: Iterable[Path]) -> None:
    """Compile every source whose library is missing, all at once."""
    running = []
    for source in sources:
        so = library_path(source)
        if so.exists():
            build_logs.setdefault(source.stem, "")
            continue
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        running.append((source, so, tmp, proc))
    failed = []
    for source, so, tmp, proc in running:
        log, _ = proc.communicate()
        build_logs[source.stem] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {source.name} ({proc.returncode}):"
                          f"\n{log}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if it is missing."""
    lib = _libs.get(source.stem)
    if lib is None:
        build_all([source])
        lib = _libs[source.stem] = ctypes.CDLL(str(library_path(source)))
    return lib
