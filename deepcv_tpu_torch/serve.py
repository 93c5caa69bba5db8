"""Inference path: bundle -> model on the card -> fixed-batch predictor.

Counterpart of ``deepcv_tpu/serve.py`` (``save_model_bundle``,
``load_model_bundle``, ``Predictor`` with ``__call__``, ``benchmark`` and
``tta='flip'``).

A bundle is a directory with ``model.yaml`` in the JAX package's own format
(input shape, hp, NAS options) and ``weights.npz``, the model's
``state_dict`` as numpy arrays. The JAX package writes its weights with
orbax, which the port cannot read; carry such weights across with
:mod:`deepcv_tpu_torch.interop`.

Usage::

    model = load_model_bundle("bundle/")                 # on the card
    predictor = Predictor(model, batch_size=64, preprocess=pre)
    probs = predictor(images_uint8_nhwc)                 # any leading batch
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from deepcv_tpu_torch.spec.module import DeepcvModule
from deepcv_tpu_torch.utils import identifier_to_str, resolve_device

__all__ = ["Predictor", "save_model_bundle", "load_model_bundle"]

WEIGHTS_FILE = "weights.npz"


def _yamlable(obj):
    """YAML-safe hp tree: TaggedFactory/callables -> identifier strings."""
    from deepcv_tpu_torch.ops.nn import activation_name

    if hasattr(obj, "identifier"):  # TaggedFactory
        return obj.identifier
    if isinstance(obj, dict):
        return {k: _yamlable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_yamlable(v) for v in obj]
    if callable(obj):
        return activation_name(obj) or identifier_to_str(obj)
    return obj


def save_model_bundle(directory: Union[str, Path], model: DeepcvModule) -> Path:
    """Write ``model.yaml`` and ``weights.npz`` (float32 ``state_dict``)."""
    import yaml

    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    meta = {"input_shape": list(model.input_shape),
            "hp": _yamlable(model.hp.to_dict()),
            "nas_mode": "fixed", "nas_arch": {}}
    (d / "model.yaml").write_text(yaml.safe_dump(meta, sort_keys=False,
                                                 default_flow_style=False))
    arrays = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    with open(d / WEIGHTS_FILE, "wb") as f:
        np.savez(f, **arrays)
    return d


def load_model_bundle(directory: Union[str, Path],
                      device: Union[None, str, torch.device] = None) -> DeepcvModule:
    """The bundle's model with its weights, in eval mode, on ``device``
    (CUDA unless given)."""
    import yaml

    dev = resolve_device(device)
    d = Path(directory)
    meta = yaml.safe_load((d / "model.yaml").read_text())
    if meta.get("nas_mode", "fixed") != "fixed" or meta.get("nas_arch"):
        raise NotImplementedError("NAS bundles are not ported yet")
    model = DeepcvModule(tuple(meta["input_shape"]), meta["hp"], device="meta")
    with np.load(d / WEIGHTS_FILE, allow_pickle=False) as z:
        state = {k: torch.from_numpy(z[k]) for k in z.files}
    model.load_state_dict(state, strict=True, assign=True)
    return model.to(dev).eval()


class Predictor:
    """Batched inference at a fixed batch size on one device.

    Images are NHWC numpy arrays of any leading size; each chunk of
    ``batch_size`` goes to the device, through ``preprocess`` (on the
    device, NHWC tensors), a cast to ``dtype`` and the model, and comes back
    as float32 numpy rows. A ragged last chunk is zero-padded to the batch
    size so the model always sees one shape; the padded rows are dropped.
    ``tta='flip'`` also runs the horizontally mirrored batch and averages.
    ``forwards`` counts the model calls made.
    """

    def __init__(self, model: DeepcvModule, batch_size: int = 256,
                 preprocess: Optional[Callable] = None,
                 dtype: Union[None, str, torch.dtype] = None,
                 tta: Optional[str] = None,
                 device: Union[None, str, torch.device] = None):
        if tta not in (None, "flip"):
            raise ValueError(f"unknown tta mode {tta!r} (known: 'flip')")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.batch_size = int(batch_size)
        self.preprocess = preprocess
        self.dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        self.tta = tta
        self.forwards = 0

    def _forward(self, chunk: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
            if self.preprocess is not None:
                x = self.preprocess(x)
            if self.dtype is not None:
                x = x.to(self.dtype)
            y = self.model(x)
            self.forwards += 1
            if self.tta == "flip":
                y = (y + self.model(torch.flip(x, dims=[2]))) * 0.5
                self.forwards += 1
            return y.float().cpu().numpy()

    def __call__(self, images: np.ndarray) -> np.ndarray:
        """Predict any leading batch size (ragged tails are zero-padded)."""
        images = np.asarray(images)
        n = len(images)
        if n == 0:
            return np.empty((0, *self.model.output_shape[1:]), np.float32)
        bs = self.batch_size
        outs = []
        for start in range(0, n, bs):
            chunk = images[start:start + bs]
            pad = bs - len(chunk)
            if pad:
                chunk = np.concatenate(
                    [chunk, np.zeros((pad, *chunk.shape[1:]), chunk.dtype)])
            outs.append(self._forward(chunk)[:bs - pad])
        return np.concatenate(outs) if len(outs) > 1 else outs[0]

    def benchmark(self, batch: Optional[int] = None, n_iters: int = 20) -> Dict[str, float]:
        """Steady-state throughput of the predictor's forward at ``batch``,
        host clock around work that ends in a device synchronise."""
        bs = int(batch or self.batch_size)
        x = np.random.default_rng(0).integers(
            0, 256, (bs, *self.model.input_shape)).astype(np.uint8)
        y = self._forward(x)                      # warm-up (kernel build, caches)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        for _ in range(n_iters):
            y = self._forward(x)                  # ends in a device->host copy
        dt = time.perf_counter() - t0
        return {"img_per_s": bs * n_iters / dt, "latency_ms": dt / n_iters * 1e3,
                "batch": bs, "checksum": float(y.sum()), "device": str(self.device)}
