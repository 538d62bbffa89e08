"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/*.cu`` file has a plain C interface and becomes its own shared
library, compiled for Hopper (``sm_90a``) at first use.  Libraries land in
``mamba_tts_torch/ops/_build/<hash>/`` (listed in ``.gitignore``); the hash
covers every file under ``csrc/`` and the compiler flags, so an edited source
rebuilds and an unchanged one loads in milliseconds.  :func:`build_all`
starts one ``nvcc`` per source together, so a fresh checkout builds every
kernel in the time of the slowest one.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh", ".h"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _lib_path(stem: str) -> Path:
    return _build_dir() / f"lib{stem}.so"


def _start(stem: str) -> Tuple[subprocess.Popen, Path]:
    """Start nvcc for ``csrc/<stem>.cu``; it writes a temporary file that
    :func:`_finish` moves into place, so a failed build leaves no library."""
    tmp = _lib_path(stem).with_suffix(f".{os.getpid()}.tmp")
    tmp.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp


def _finish(stem: str, proc: subprocess.Popen, tmp: Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{stem}.cu (exit {proc.returncode}):\n{log}")
    out = _lib_path(stem)
    os.replace(tmp, out)
    (out.parent / f"{stem}.ptxas.log").write_text(log)
    return log


def sources() -> List[str]:
    """Stems of every kernel source under ``csrc/``."""
    return sorted(f.stem for f in CSRC.glob("*.cu"))


def build_all(stems: Iterable[str] = ()) -> Dict[str, str]:
    """Compile every (or the named) kernel source that is not built yet, one
    ``nvcc`` process per source, all started together.  Returns each built
    stem's compiler log (``-Xptxas -v``: registers, shared memory, spills)."""
    todo = [s for s in (list(stems) or sources()) if not _lib_path(s).exists()]
    started = {s: _start(s) for s in todo}
    return {s: _finish(s, proc, tmp) for s, (proc, tmp) in started.items()}


def load_library(stem: str) -> ctypes.CDLL:
    """The loaded shared library built from ``csrc/<stem>.cu`` (built first
    if needed)."""
    if stem not in _LOADED:
        if not _lib_path(stem).exists():
            build_all([stem])
        _LOADED[stem] = ctypes.CDLL(str(_lib_path(stem)))
    return _LOADED[stem]
