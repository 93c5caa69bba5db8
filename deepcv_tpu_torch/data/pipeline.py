"""The input pipeline: host batches, their copy to the device, and the
device-resident dataset.

Counterpart of ``deepcv_tpu/data/pipeline.py`` (``BatchIterator``,
``prefetch_to_device``, ``DeviceDataset``):

* :class:`BatchIterator` draws the same batches as the JAX package's, index
  for index: the order of epoch ``e`` is ``numpy.random.default_rng(seed +
  e)``'s permutation (chunk-wise for a memmap: a permutation of the chunks,
  then one within each chunk), a process takes its block of each global
  batch, and a short last batch wraps around;
* :func:`prefetch_to_device` keeps ``size`` batches in flight. On a card
  each batch is copied into pinned host memory and from there by a
  ``non_blocking`` copy on a side CUDA stream; the consumer's stream waits
  on that copy's event, and a pinned buffer is written again only after the
  copy out of it has finished. With ``wire_codec`` the image leaf (the
  first, when it is a uint8 NHWC batch) is coded on the host
  (:mod:`~deepcv_tpu_torch.data.wirecodec`), its payload copied and decoded
  on the side stream; a batch the codec cannot shrink goes raw. Unlike the
  JAX package, which tries the codec on every uint8 leaf of two or more
  dimensions, no other leaf (a uint8 mask, say) is coded;
* :class:`DeviceDataset` holds the whole dataset on the device and gathers
  each batch there (an epoch's permutation, or uniform draws with
  replacement from a ``torch.Generator``).
"""
from __future__ import annotations

import collections
import time
from typing import Any, Iterator, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from deepcv_tpu_torch.data.datasets import ArrayDataset
from deepcv_tpu_torch.data.wirecodec import decode_u8, encode_u8, wire_bytes
from deepcv_tpu_torch.utils import resolve_device

__all__ = ["BatchIterator", "prefetch_to_device", "DeviceDataset", "unwrap_dataset",
           "wire_stats"]

#: the wire codec's record, summed over :func:`prefetch_to_device` calls
#: since the caller last cleared it: image batches shipped ``coded`` and
#: ``raw`` (the codec could not shrink them), the image leaf's ``image_bytes``
#: and the ``wire_bytes`` that went in its place, and the host's ``encode_s``
wire_stats: collections.Counter = collections.Counter()


def unwrap_dataset(ds) -> ArrayDataset:
    """The :class:`ArrayDataset` under a ``PreprocessedDataset``."""
    return getattr(ds, "dataset", ds)


class BatchIterator:
    """Epoch-aware shuffled batches ``(images, targets)`` of numpy arrays
    from an :class:`ArrayDataset` (or a ``PreprocessedDataset`` over one);
    the remainder is dropped when ``drop_last``, else wrapped around."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True, process_index: int = 0, process_count: int = 1,
                 shuffle_chunk: Optional[int] = None):
        self.data = unwrap_dataset(dataset)
        self.batch_size = int(batch_size)   # the batch of one process
        self.shuffle = shuffle
        self.seed = int(seed)
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = process_count
        if shuffle_chunk is None and isinstance(self.data.images, np.memmap):
            shuffle_chunk = max(self.batch_size, 8192)
        self.shuffle_chunk = shuffle_chunk
        gbs = self.batch_size * process_count
        n = len(self.data)
        self.num_batches = n // gbs if drop_last else -(-n // gbs)
        if self.num_batches == 0:
            raise ValueError(f"Dataset ({n} items over {process_count} "
                             f"processes) smaller than one global batch ({gbs})")

    def epoch(self, epoch: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n_total = len(self.data)
        if self.shuffle and self.shuffle_chunk:
            rng = np.random.default_rng(self.seed + epoch)
            c = int(self.shuffle_chunk)
            starts = np.arange(0, n_total, c)
            order = np.concatenate([s + rng.permutation(min(c, n_total - s))
                                    for s in starts[rng.permutation(len(starts))]])
        elif self.shuffle:
            order = np.random.default_rng(self.seed + epoch).permutation(n_total)
        else:
            order = np.arange(n_total)
        bs = self.batch_size
        gbs = bs * self.process_count
        for b in range(self.num_batches):
            start = b * gbs + self.process_index * bs
            idx = order[start:start + bs]
            if len(idx) < bs:   # wrap the remainder (tiled when short of one batch)
                reps = -(-(bs - len(idx)) // len(order))
                idx = np.concatenate([idx] + [order] * reps)[:bs]
            yield self.data.images[idx], self.data.targets[idx]

    def __iter__(self):
        return self.epoch(0)

    def __len__(self):
        return self.num_batches


class _PinnedSlot:
    """Pinned host buffers of one batch in flight, and the event of the
    copy out of them."""

    def __init__(self):
        self.buffers = None
        self.event = None

    def fill(self, arrays):
        if self.event is not None:
            self.event.synchronize()   # the copy out of these buffers is done
        if self.buffers is None or any(tuple(b.shape) != a.shape or b.numpy().dtype != a.dtype
                                       for b, a in zip(self.buffers, arrays)):
            self.buffers = [torch.empty(a.shape, pin_memory=True,
                                        dtype=torch.from_numpy(np.empty(0, a.dtype)).dtype)
                            for a in arrays]
        for buf, a in zip(self.buffers, arrays):
            buf.numpy()[...] = a
        return self.buffers


def _wire_payload(arrays, wire_codec):
    """The wire codec's payload of the image leaf, or None (raw)."""
    images = arrays[0]
    if wire_codec is None or images.dtype != np.uint8 or images.ndim != 4:
        return None
    t0 = time.perf_counter()
    payload = encode_u8(images, **wire_codec)
    wire_stats["encode_s"] += time.perf_counter() - t0
    wire_stats["coded" if payload is not None else "raw"] += 1
    wire_stats["image_bytes"] += images.nbytes
    wire_stats["wire_bytes"] += wire_bytes(payload) if payload is not None else images.nbytes
    return payload


def _decoded(tensors, payload):
    if payload is None:
        return tuple(tensors)
    images = decode_u8(tensors[0], tensors[1], payload["shape"], payload["bits"],
                       payload["axis"])
    return (images, *tensors[2:])


def prefetch_to_device(iterator: Iterator, size: int = 2,
                       device: Union[None, str, torch.device] = None,
                       wire_codec: Optional[Mapping[str, Any]] = None) -> Iterator:
    """Batches of ``iterator`` (tuples of numpy arrays) as tensors on
    ``device`` (CUDA unless given), ``size`` of them in flight. On a card
    each copy runs from pinned memory on a side stream and the consumer's
    current stream waits on it; on the CPU the arrays are wrapped as they
    are. ``wire_codec`` (``{"bits": 3, "axis": -2}``, the arguments of
    :func:`~deepcv_tpu_torch.data.wirecodec.encode_u8`) ships a uint8 NHWC
    image leaf coded and decodes it on ``device`` (:data:`wire_stats` counts
    the batches)."""
    wire_codec = dict(wire_codec) if wire_codec is not None else None
    device = resolve_device(device)
    size = max(1, int(size))
    if device.type != "cuda":
        for batch in iterator:
            arrays = [np.asarray(a) for a in batch]
            payload = _wire_payload(arrays, wire_codec)
            host = [payload["packed"], payload["overflow"], *arrays[1:]] if payload else arrays
            yield _decoded([torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in host],
                           payload)
        return
    stream = torch.cuda.Stream(device)
    slots = [_PinnedSlot() for _ in range(size + 1)]
    queue = collections.deque()

    def take():
        tensors, event = queue.popleft()
        current = torch.cuda.current_stream(device)
        current.wait_event(event)
        for t in tensors:
            t.record_stream(current)
        return tensors

    for i, batch in enumerate(iterator):
        slot = slots[i % len(slots)]
        arrays = [np.asarray(a) for a in batch]
        payload = _wire_payload(arrays, wire_codec)
        pinned = slot.fill([payload["packed"], payload["overflow"], *arrays[1:]]
                           if payload else arrays)
        with torch.cuda.stream(stream):
            tensors = _decoded([p.to(device, non_blocking=True) for p in pinned], payload)
            slot.event = torch.cuda.Event()
            slot.event.record(stream)
        queue.append((tensors, slot.event))
        if len(queue) >= size:
            yield take()
    while queue:
        yield take()


class DeviceDataset:
    """The whole dataset on ``device``; batches are gathered there. Targets
    keep their kind: float ones as float32, integer ones as int64."""

    def __init__(self, dataset, batch_size: int,
                 device: Union[None, str, torch.device] = None):
        data = unwrap_dataset(dataset)
        self.batch_size = int(batch_size)
        self.n = len(data)
        self.device = resolve_device(device)
        self.images = torch.from_numpy(np.ascontiguousarray(data.images)).to(self.device)
        t = torch.from_numpy(np.ascontiguousarray(data.targets))
        self.targets = (t.float() if t.is_floating_point() else t.long()).to(self.device)
        self.steps_per_epoch = self.n // self.batch_size

    def batch_for_step(self, generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
        """A batch of uniform draws with replacement (``sampling:
        with_replacement``): indices from ``generator`` (on the device)."""
        idx = torch.randint(0, self.n, (self.batch_size,), generator=generator,
                            device=self.device)
        return self.images[idx], self.targets[idx]

    def batch_at(self, perm: torch.Tensor, step: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batch ``step`` of the epoch whose order is ``perm``."""
        start = (int(step) % self.steps_per_epoch) * self.batch_size
        idx = perm[start:start + self.batch_size]
        return self.images[idx], self.targets[idx]
