"""Build the port's CUDA sources (rovr_torch/csrc/*.cu) at first use and
load them with ctypes.

Each source is compiled by `nvcc` on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds). The
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
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


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


def library_path(name: str) -> Path:
    """Where csrc/<name>.cu's library lives, keyed on source and flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that has no current library, all nvcc
    processes running at once. Returns {name: compiler log} (ptxas's
    register, shared-memory and spill report) for the sources it built."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    logs, failed = {}, []
    for n, (tmp, proc) in procs.items():
        logs[n] = proc.communicate()[0]
        if proc.returncode:
            failed.append(f"{n}.cu:\n{logs[n]}")
        else:
            os.replace(tmp, library_path(n))  # atomic: racing builders agree
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu's library, built if needed."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
