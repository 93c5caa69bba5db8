"""Build the port's native libraries and load them with ``ctypes``.

Each CUDA kernel is one ``csrc/<name>.cu`` with a plain ``extern "C"``
launcher and no PyTorch header, so ``nvcc`` compiles it in seconds. The host
runtime (the batch loader and the range coder) is one ``runtime/<name>.cpp``
each, compiled by the host's C++ compiler (``$CXX``, else ``g++``) with
:data:`CXX_FLAGS`. Every shared library goes to ``deepcv_tpu_torch/_build/``
(listed in ``.gitignore``) under a name that hashes the source and the flags:
an edited source or flag builds anew, an unchanged one is loaded from disk.
Nothing is built at import time; the first call that needs a library builds
it.
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

__all__ = ["CSRC_DIR", "RUNTIME_DIR", "BUILD_DIR", "NVCC_FLAGS", "CXX_FLAGS", "find_nvcc",
           "find_cxx", "library_path", "host_library_path", "build", "build_host", "load",
           "load_host"]

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
RUNTIME_DIR = _PKG / "runtime"
BUILD_DIR = _PKG / "_build"

#: sm_90a keeps wgmma/setmaxnreg available to later kernels; -Xptxas=-v
#: reports registers, shared memory and spills in the build log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: the host runtime's flags (those of the JAX package's runtime Makefile, less
#: its warnings)
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

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


def find_cxx() -> Optional[str]:
    """``$CXX``, else ``g++``, else ``c++`` on ``PATH``; None when there is no
    host compiler."""
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        path = shutil.which(cand) if cand else None
        if path:
            return path
    return None


def _source(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"no CUDA source {src}")
    return src


def _host_source(name: str) -> Path:
    src = RUNTIME_DIR / f"{name}.cpp"
    if not src.is_file():
        raise FileNotFoundError(f"no C++ source {src}")
    return src


def _hashed(src: Path, flags, stem: str) -> Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{stem}-{h.hexdigest()[:16]}.so"


def library_path(name: str) -> Path:
    """Where the CUDA library for the current source and flags lives."""
    return _hashed(_source(name), NVCC_FLAGS, name)


def host_library_path(name: str) -> Path:
    """Where the host library for the current source and flags lives."""
    return _hashed(_host_source(name), CXX_FLAGS, name)


def _compile(out: Path, compiler: str, flags, src: Path, what: str) -> Tuple[Path, str, float]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # unique temporary name + atomic rename: concurrent builds never load
    # a half-written library
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [compiler, *flags, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = (proc.stdout + proc.stderr).strip()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{Path(compiler).name} failed for '{what}' (exit "
                           f"{proc.returncode}):\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    return out, log, seconds


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
    return _compile(out, nvcc, NVCC_FLAGS, _source(name), name)


def build_host(name: str) -> Tuple[Path, str, float]:
    """Compile ``runtime/<name>.cpp`` with the host's C++ compiler unless its
    library exists; returns and raises as :func:`build` does."""
    out = host_library_path(name)
    if out.is_file():
        return out, "", 0.0
    cxx = find_cxx()
    if cxx is None:
        raise RuntimeError(f"cannot build host library '{name}': no C++ compiler (set CXX "
                           "or put g++ on PATH)")
    return _compile(out, cxx, CXX_FLAGS, _host_source(name), name)


def _load(name: str, build_fn) -> ctypes.CDLL:
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path, _, _ = build_fn(name)
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    return _load(name, build)


def load_host(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the host library, once per process."""
    return _load(name, build_host)
