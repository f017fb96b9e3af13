"""Build the package's CUDA sources into shared libraries, load them and
launch their entries.

Each ``csrc/*.cu`` file has a plain C interface.  It is compiled with
``nvcc`` for ``sm_90a`` into ``build/`` inside this package, once per
digest of source and flags, and loaded with ctypes.  ``build_all`` starts
one ``nvcc`` per source at the same time, so a run that needs every kernel
pays for the slowest build only.

The launch convention, for every source: each ``extern "C" int sv_*``
entry is declared once, when ``load`` loads its library, from its module's
table ``SIGNATURES``.  An entry that launches work takes ``(..., int
device, void* stream)`` last, makes ``device`` the calling thread's current
device for the launch and restores the one that was current, and returns
``cudaGetLastError()`` after it.  ``launch`` is the one call that makes a
launch: it passes the device's index and its current stream, records the
C call alone as a span while the recorder is on, and raises on an error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from ..core import spans

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
# loaded libraries by source path, each declared and checked
_libs: Dict[Path, ctypes.CDLL] = {}


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


def load(source: Path, signatures: Dict[str, Tuple[type, List[type]]],
         check: Optional[Callable[[ctypes.CDLL], None]] = None) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if it is missing, with
    each entry of ``signatures`` ({name: (restype, [argtypes])}) declared;
    an entry the library lacks raises.  ``check``, given the library, may
    raise to refuse it (a layout the module does not share): a refused
    library is not kept, so every later call raises again."""
    lib = _libs.get(source)
    if lib is None:
        build_all([source])
        lib = ctypes.CDLL(str(library_path(source)))
        for name, (restype, argtypes) in signatures.items():
            entry = getattr(lib, name)
            entry.restype, entry.argtypes = restype, argtypes
        if check is not None:
            check(lib)
        _libs[source] = lib
    return lib


def launch(entry, dev: torch.device, *args, span: Optional[str] = None) -> None:
    """Call the launch entry ``entry`` with ``args``, then the index of the
    card ``dev`` (the current card when ``dev`` has none) and the raw
    handle of its current stream.  While the recorder is on, ``span``
    covers the C call alone.  Raises on a non-zero CUDA error."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = torch._C._cuda_getCurrentRawStream(index)
    rec = span is not None and spans.ON and spans.begin(span)
    err = entry(*args, index, stream)
    if rec:
        spans.end(rec)
    if err != 0:
        raise RuntimeError(f"{entry.__name__} launch failed: CUDA error {err}")
