"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` into a shared
library with a plain ``extern "C"`` interface, loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  :func:`build_all` starts one
``nvcc`` per source at once and waits for all of them.  The libraries
land in ``interpol_tpu_torch/_build/`` under names keyed by a hash of
every file under ``csrc/`` (``*.cu`` and the shared ``*.cuh`` headers)
and of the flags, so an edited source or header is rebuilt and an
unchanged tree is reused.  A failed build raises with nvcc's output;
nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

__all__ = ["NVCC_FLAGS", "BUILD_DIR", "SOURCES", "load_library",
           "build_all"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("warp", "push", "gather", "splat", "lab")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is not None:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "interpol_tpu_torch are built at first use and "
                           "need the CUDA toolkit")
    return path


def _tree_key() -> str:
    """Hash of every file under ``csrc/`` and of the flags."""
    key = hashlib.sha256()
    for f in sorted(p for p in _CSRC.iterdir() if p.suffix in (".cu",
                                                               ".cuh")):
        key.update(f.name.encode())
        key.update(f.read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    return key.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}_{_tree_key()}.so"


def _start(name: str):
    """Start nvcc on ``csrc/<name>.cu`` into a private file (renamed once
    it is whole, so concurrent builds never load a half-written one)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(_CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, cmd, tmp


def _finish(name: str, proc, cmd, tmp) -> None:
    out, err = proc.communicate()
    lib_path = _lib_path(name)
    lib_path.with_suffix(".log").write_text(" ".join(cmd) + "\n" + out
                                            + err)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{err}")
    os.replace(tmp, lib_path)


def build_all() -> None:
    """Build every source that has no library yet, all nvcc at once.
    ``BUILD_DIR / 'lib<name>_<hash>.log'`` keeps nvcc's report
    (``-Xptxas -v``: registers and spills per kernel)."""
    jobs = [(name, *_start(name)) for name in SOURCES
            if not _lib_path(name).exists()]
    errors = []
    for job in jobs:
        try:
            _finish(*job)
        except RuntimeError as e:   # wait for every nvcc, then report
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it."""
    lib_path = _lib_path(name)
    if str(lib_path) in _loaded:
        return _loaded[str(lib_path)]
    if not lib_path.exists():
        _finish(name, *_start(name))
    lib = ctypes.CDLL(str(lib_path))
    _loaded[str(lib_path)] = lib
    return lib
