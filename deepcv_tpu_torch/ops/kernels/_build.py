"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each kernel is one ``csrc/<name>.cu`` with a plain ``extern "C"`` launcher and
no PyTorch header, so ``nvcc`` compiles it in seconds. The shared library goes
to ``deepcv_tpu_torch/_build/`` (listed in ``.gitignore``) under a name that
hashes the source and the flags: an edited source or flag builds anew, an
unchanged one is loaded from disk. Nothing is built at import time; the first
wrapper call on a CUDA tensor builds.
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
from typing import Dict, Optional, Tuple

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "find_nvcc", "library_path",
           "build", "load"]

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: sm_90a keeps wgmma/setmaxnreg available to later kernels; -Xptxas=-v
#: reports registers, shared memory and spills in the build log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> Optional[str]:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the toolkit's
    default install location; None when there is no compiler."""
    cands = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            cands.append(Path(os.environ[var]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(Path(on_path))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    return None


def _source(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"no CUDA source {src}")
    return src


def library_path(name: str) -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(_source(name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Tuple[Path, str, float]:
    """Compile ``csrc/<name>.cu`` unless its library exists.

    Returns ``(library path, nvcc's log, seconds spent compiling)``; the log is
    empty and the time 0 when the library was already built. Raises
    RuntimeError with nvcc's output when there is no compiler or it fails.
    """
    out = library_path(name)
    if out.is_file():
        return out, "", 0.0
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            f"cannot build CUDA kernel '{name}': nvcc not found (set CUDA_HOME "
            "or put nvcc on PATH)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # unique temporary name + atomic rename: concurrent builds never load
    # a half-written library
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_source(name))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = (proc.stdout + proc.stderr).strip()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for '{name}' (exit {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    return out, log, seconds


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path, _, _ = build(name)
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib
