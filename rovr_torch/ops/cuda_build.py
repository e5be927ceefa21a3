"""Build the port's native sources (rovr_torch/csrc/*.cu, *.cpp) at first use
and load them with ctypes.

Each source is compiled on its own into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds): a CUDA source
(`.cu`) by `nvcc`, a host source (`.cpp`, the frame decoder) by the host's
C++ compiler (`g++`; nvcc needs one, so a card's machine has it). The
library's name carries a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is loaded from `csrc/_build/`, which
is not committed. Nothing is built when this module is imported: a kernel's
wrapper calls `load` the first time it launches, and `build` lets a caller
start several compilations at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()   # prefetcher threads may load a library at once


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of rovr_torch are compiled at "
            "first use; set CUDA_HOME or put nvcc on PATH"
        )
    return found


def _host_cxx() -> str:
    found = shutil.which("g++") or shutil.which("c++")
    if found is None:
        raise RuntimeError("g++ not found: rovr_torch's host sources (csrc/*.cpp) "
                           "are compiled at first use; put g++ on PATH")
    return found


def _source(name: str) -> Path:
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.cpp"


def _flags(src: Path) -> tuple:
    return NVCC_FLAGS if src.suffix == ".cu" else HOST_FLAGS


def library_path(name: str) -> Path:
    """Where csrc/<name>.cu's (or .cpp's) library lives, keyed on source and
    flags."""
    src = _source(name)
    digest = hashlib.sha256(src.read_bytes() + " ".join(_flags(src)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def _command(name: str, out: Path) -> List[str]:
    src = _source(name)
    compiler = _nvcc() if src.suffix == ".cu" else _host_cxx()
    return [compiler, *_flags(src), "-o", str(out), str(src)]


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that has no current library, all compiler
    processes running at once. Returns {name: compiler log} (for a CUDA
    source ptxas's register, shared-memory and spill report) for the sources
    it built."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            _command(n, tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        ))
    logs, failed = {}, []
    for n, (tmp, proc) in procs.items():
        logs[n] = proc.communicate()[0]
        if proc.returncode:
            failed.append(f"{_source(n).name}:\n{logs[n]}")
        else:
            os.replace(tmp, library_path(n))  # atomic: racing builders agree
    if failed:
        raise RuntimeError("compiler failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>'s library, built if needed."""
    with _load_lock:
        if name not in _loaded:
            build([name])
            _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return _loaded[name]
