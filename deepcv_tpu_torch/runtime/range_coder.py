"""The range coder of the learned lossless codec: native
(``runtime/deepcv_rc.cpp``) with a pure-Python mirror, bit for bit.

Counterpart of ``deepcv_tpu/runtime/range_coder.py`` (``TOTAL``,
``rc_encode``, ``rc_decode``, ``rc_native_available``). ``rc_encode`` and
``rc_decode`` take per-symbol cumulative-frequency rows: ``cdf[i]`` is the
uint32 CDF of symbol ``i`` with ``cdf[i][0] == 0`` and ``cdf[i][-1] ==
TOTAL (1 << 16)``, what :func:`deepcv_tpu_torch.codec.quantize_cdf` gives.

Both realize the same carry-less 32-bit range coder (Subbotin's public-domain
scheme), so their streams are interchangeable and equal to the JAX
package's. The native library is built at first use by the host's C++
compiler into ``deepcv_tpu_torch/_build/``; without a compiler the Python
mirror codes.
"""
from __future__ import annotations

import ctypes
import logging
import threading

import numpy as np

from deepcv_tpu_torch.ops.kernels import _build

__all__ = ["TOTAL", "rc_encode", "rc_decode", "rc_native_available"]

_logger = logging.getLogger(__name__)

TOTAL = 1 << 16
_TOP = 1 << 24
_BOT = 1 << 16
_M32 = 0xFFFFFFFF

_LIB = "deepcv_rc"
_state = {"lib": None, "tried": False}
_lock = threading.Lock()


def _load():
    """The bound library, built on first use; None (once, then remembered)
    where it cannot be built."""
    with _lock:
        if _state["tried"]:
            return _state["lib"]
        _state["tried"] = True
        try:
            lib = _build.load_host(_LIB)
        except (RuntimeError, OSError) as e:
            _logger.warning("native range coder unavailable: %s", e)
            return None
        lib.deepcv_rc_encode.restype = ctypes.c_int64
        lib.deepcv_rc_encode.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                         ctypes.c_void_p, ctypes.c_int64,
                                         ctypes.c_void_p, ctypes.c_int64]
        lib.deepcv_rc_decode.restype = ctypes.c_int64
        lib.deepcv_rc_decode.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                         ctypes.c_int64, ctypes.c_void_p,
                                         ctypes.c_int64, ctypes.c_void_p]
        _state["lib"] = lib
        return lib


def rc_native_available() -> bool:
    return _load() is not None


def _check(syms: np.ndarray, cdf: np.ndarray):
    syms = np.ascontiguousarray(syms, dtype=np.uint16)
    cdf = np.ascontiguousarray(cdf, dtype=np.uint32)
    if cdf.ndim != 2 or cdf.shape[1] < 2:
        raise ValueError(f"cdf must be (n, K+1), got {cdf.shape}")
    return syms, cdf


# ---------------------------------------------------------------------------
# Pure-Python mirror (masked uint32 arithmetic — identical streams)
# ---------------------------------------------------------------------------

def _py_encode(syms: np.ndarray, cdf: np.ndarray) -> bytes:
    low, rng = 0, _M32
    out = bytearray()
    for i in range(len(syms)):
        row = cdf[i]
        s = int(syms[i])
        cum, freq = int(row[s]), int(row[s + 1] - row[s])
        rng >>= 16
        low = (low + cum * rng) & _M32
        rng = (rng * freq) & _M32
        while True:
            if (low ^ ((low + rng) & _M32)) < _TOP:
                pass
            elif rng < _BOT:
                rng = (0 - low) & (_BOT - 1)
            else:
                break
            out.append((low >> 24) & 0xFF)
            low = (low << 8) & _M32
            rng = (rng << 8) & _M32
    for _ in range(4):
        out.append((low >> 24) & 0xFF)
        low = (low << 8) & _M32
    return bytes(out)


def _py_decode(data: bytes, n: int, cdf: np.ndarray) -> np.ndarray:
    low, rng, code, pos = 0, _M32, 0, 0

    def get():
        nonlocal pos
        b = data[pos] if pos < len(data) else 0
        pos += 1
        return b

    for _ in range(4):
        code = ((code << 8) | get()) & _M32
    out = np.empty(n, dtype=np.uint16)
    for i in range(n):
        row = cdf[i]
        rng >>= 16
        v = min(((code - low) & _M32) // rng, _BOT - 1)
        s = int(np.searchsorted(row, v, side="right")) - 1
        out[i] = s
        cum, freq = int(row[s]), int(row[s + 1] - row[s])
        low = (low + cum * rng) & _M32
        rng = (rng * freq) & _M32
        while True:
            if (low ^ ((low + rng) & _M32)) < _TOP:
                pass
            elif rng < _BOT:
                rng = (0 - low) & (_BOT - 1)
            else:
                break
            code = ((code << 8) | get()) & _M32
            low = (low << 8) & _M32
            rng = (rng << 8) & _M32
    return out


# ---------------------------------------------------------------------------
# Public API (native when available)
# ---------------------------------------------------------------------------

def rc_encode(syms: np.ndarray, cdf: np.ndarray,
              force_python: bool = False) -> bytes:
    """Encode ``syms`` (n,) against per-symbol CDF rows (n, K+1)."""
    syms, cdf = _check(syms, cdf)
    lib = None if force_python else _load()
    if lib is None:
        return _py_encode(syms, cdf)
    cap = len(syms) * 3 + 64   # worst case ~2B/symbol at freq>=1; headroom
    out = np.empty(cap, dtype=np.uint8)
    ln = lib.deepcv_rc_encode(
        syms.ctypes.data_as(ctypes.c_void_p), len(syms),
        cdf.ctypes.data_as(ctypes.c_void_p), cdf.shape[1],
        out.ctypes.data_as(ctypes.c_void_p), cap)
    if ln < 0:  # pragma: no cover — cap is provably sufficient
        return _py_encode(syms, cdf)
    return out[:ln].tobytes()


def rc_decode(data: bytes, n: int, cdf: np.ndarray,
              force_python: bool = False) -> np.ndarray:
    """Decode ``n`` symbols from ``data`` against the SAME CDF rows."""
    _, cdf = _check(np.empty(0, np.uint16), cdf)
    if n == 0:
        return np.empty(0, dtype=np.uint16)
    lib = None if force_python else _load()
    if lib is None:
        return _py_decode(data, n, cdf)
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(n, dtype=np.uint16)
    lib.deepcv_rc_decode(
        buf.ctypes.data_as(ctypes.c_void_p), len(buf), n,
        cdf.ctypes.data_as(ctypes.c_void_p), cdf.shape[1],
        out.ctypes.data_as(ctypes.c_void_p))
    return out
