"""deepcv_tpu_torch — the PyTorch/CUDA port of deepcv_tpu for NVIDIA Hopper.

The JAX package ``deepcv_tpu`` stays beside it as the reference; this package
imports nothing of it, loads none of its built libraries and never imports
JAX. Entry points run on CUDA unless the caller passes ``device="cpu"``.

What it holds: YAML specs compiled to models (``spec``: the creators, the
zoo, NAS choice points), the task pipelines and their CLI (``pipelines``,
``cli``), the training runtime (``train``), serving and int8 compression
(``serve``, ``server``, ``compression``), search (``search``), the data
side (``data``: datasets, augmentation, the streaming input path and its
wire codec, video I/O and the ``.dvv`` container, SinGAN, wave function
collapse, visualisation), the learned lossless codec (``codec``), and the
host runtime (``runtime``: the C++ batch loader and range coder). Every TPU
kernel of the JAX package is a hand-written CUDA kernel in ``csrc/``
(``ops/kernels`` binds them).

``LosslessCodec``, like the JAX package's, is imported lazily from the
top level.
"""
from deepcv_tpu_torch.hyperparams import Hyperparameters  # noqa: F401
from deepcv_tpu_torch.utils import resolve_device, set_seeds  # noqa: F401

__version__ = "0.1.0"


def __getattr__(name):
    """The lazy top-level API: ``LosslessCodec`` (``deepcv_tpu_torch.codec``)."""
    if name == "LosslessCodec":
        from deepcv_tpu_torch.codec import LosslessCodec
        return LosslessCodec
    raise AttributeError(f"module 'deepcv_tpu_torch' has no attribute '{name}'")
