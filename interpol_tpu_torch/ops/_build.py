"""Build the CUDA sources under ``csrc/`` at first use and load them.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` into one shared library
with a plain ``extern "C"`` interface, which is loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  The library lands in
``interpol_tpu_torch/_build/`` under a name keyed by a hash of the sources
and flags, so an edited source is rebuilt and an unchanged one is reused.
A failed build raises with nvcc's output; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["NVCC_FLAGS", "BUILD_DIR", "load_library"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded = {}


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


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' shared library.

    Returns the ``ctypes.CDLL``; ``BUILD_DIR / 'libinterpol_<hash>.log'`` keeps
    nvcc's report (``-Xptxas -v``: registers and spills per kernel)."""
    sources = sorted(_CSRC.glob("*.cu"))
    key = hashlib.sha256()
    for f in sources:
        key.update(f.name.encode())
        key.update(f.read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    name = f"libinterpol_{key.hexdigest()[:16]}"
    if name in _loaded:
        return _loaded[name]
    out_dir = BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"{name}.so"
    if not lib_path.exists():
        # build to a private name, then rename: concurrent builds
        # (test workers) never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        (out_dir / f"{name}.log").write_text(
            " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    _loaded[name] = lib
    return lib
