"""ctypes bindings of the native host-IO runtime (``runtime/deepcv_io.cpp``).

Counterpart of ``deepcv_tpu/runtime/native.py`` (``native_available``,
``gather_batch``, ``NativeBatchLoader``). The library
is the same C++ source, built at first use by the host's C++ compiler into
``deepcv_tpu_torch/_build/`` (:func:`~deepcv_tpu_torch.ops.kernels._build.build_host`),
so for the same seed the loader yields the JAX package's batches, in its
order: epoch ``e`` is a Fisher-Yates shuffle by ``std::mt19937_64(seed + e)``.

Where there is no compiler, :func:`native_available` is false and
:func:`gather_batch` gathers with numpy; :class:`NativeBatchLoader` raises.
"""
from __future__ import annotations

import ctypes
import logging
import threading
from typing import Optional, Tuple

import numpy as np

from deepcv_tpu_torch.ops.kernels import _build

__all__ = ["native_available", "gather_batch", "NativeBatchLoader"]

_logger = logging.getLogger(__name__)

_LIB = "deepcv_io"
_state = {"lib": None, "tried": False}
_lock = threading.Lock()


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.deepcv_gather_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int32]
    lib.deepcv_loader_create.restype = ctypes.c_void_p
    lib.deepcv_loader_create.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_uint64,
        ctypes.c_int32]
    lib.deepcv_loader_next.restype = ctypes.c_int64
    lib.deepcv_loader_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.deepcv_loader_steps_per_epoch.restype = ctypes.c_int64
    lib.deepcv_loader_steps_per_epoch.argtypes = [ctypes.c_void_p]
    lib.deepcv_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.deepcv_io_version.restype = ctypes.c_int32
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The bound library, built on first use; None (once, then remembered)
    where it cannot be built."""
    with _lock:
        if not _state["tried"]:
            _state["tried"] = True
            try:
                _state["lib"] = _bind(_build.load_host(_LIB))
            except (RuntimeError, OSError) as e:
                _logger.warning("native IO library unavailable: %s", e)
        return _state["lib"]


def native_available() -> bool:
    """Whether the library is built (building it on first use) and loaded."""
    return _load() is not None


def gather_batch(data: np.ndarray, indices: np.ndarray, out: Optional[np.ndarray] = None,
                 n_threads: int = 0) -> np.ndarray:
    """Threaded gather: ``out[i] = data[indices[i]]`` (row-major samples);
    numpy's ``take`` where the library is unavailable."""
    lib = _load()
    data = np.ascontiguousarray(data)
    idx = np.ascontiguousarray(indices, dtype=np.int64)
    sample_bytes = int(data.dtype.itemsize * np.prod(data.shape[1:]))
    if out is None:
        out = np.empty((len(idx), *data.shape[1:]), dtype=data.dtype)
    if lib is None:
        np.take(data, idx, axis=0, out=out)
        return out
    lib.deepcv_gather_batch(
        data.ctypes.data_as(ctypes.c_void_p), sample_bytes,
        idx.ctypes.data_as(ctypes.c_void_p), len(idx),
        out.ctypes.data_as(ctypes.c_void_p), int(n_threads))
    return out


class NativeBatchLoader:
    """Background-producer batch loader on the C++ ring buffer: a native
    thread keeps ``depth`` shuffled batches gathered ahead; ``next()``
    returns ``(images, targets)`` numpy arrays. The loader holds pointers
    into ``images`` and ``targets``; a C-contiguous array (a memmap of the
    whole file, or a contiguous slice of one) is passed as it is, without a
    copy (:attr:`images` shares its memory)."""

    def __init__(self, images: np.ndarray, targets: np.ndarray, batch_size: int,
                 depth: int = 3, seed: int = 0, shuffle: bool = True):
        lib = _load()
        if lib is None:
            raise RuntimeError("native IO library unavailable (no C++ compiler); use "
                               "BatchIterator")
        self._lib = lib
        # strong references: the loader reads through raw pointers into these
        self.images = np.ascontiguousarray(images)
        self.targets = np.ascontiguousarray(targets)
        self.batch_size = int(batch_size)
        img_bytes = int(self.images.dtype.itemsize * np.prod(self.images.shape[1:]))
        tgt_bytes = int(self.targets.dtype.itemsize
                        * max(1, int(np.prod(self.targets.shape[1:]))))
        self._handle = lib.deepcv_loader_create(
            self.images.ctypes.data_as(ctypes.c_void_p),
            self.targets.ctypes.data_as(ctypes.c_void_p),
            len(self.images), img_bytes, tgt_bytes, self.batch_size, int(depth), int(seed),
            int(bool(shuffle)))
        if not self._handle:
            raise RuntimeError(f"deepcv_loader_create failed ({len(self.images)} samples, "
                               f"batch {self.batch_size})")
        self.steps_per_epoch = int(lib.deepcv_loader_steps_per_epoch(self._handle))

    def __iter__(self):
        return self

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        if not self._handle:
            raise StopIteration
        imgs = np.empty((self.batch_size, *self.images.shape[1:]), dtype=self.images.dtype)
        tgts = np.empty((self.batch_size, *self.targets.shape[1:]), dtype=self.targets.dtype)
        step = self._lib.deepcv_loader_next(self._handle, imgs.ctypes.data_as(ctypes.c_void_p),
                                            tgts.ctypes.data_as(ctypes.c_void_p))
        if step < 0:
            raise StopIteration
        return imgs, tgts

    def close(self) -> None:
        """Stop the producer thread and free the ring buffer."""
        if getattr(self, "_handle", None):
            self._lib.deepcv_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter teardown
            pass
