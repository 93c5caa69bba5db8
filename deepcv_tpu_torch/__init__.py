"""deepcv_tpu_torch — the PyTorch/CUDA port of deepcv_tpu for NVIDIA Hopper.

The JAX package ``deepcv_tpu`` stays beside it as the reference; this package
imports nothing of it and never imports JAX. Entry points run on CUDA unless
the caller passes ``device="cpu"``. Ported so far: the serving path of a
spec-built model (``spec``, ``serve``, ``server``, ``cli serve``), with every
stride-1 'same' odd-kernel conv in the hand-written CUDA kernel
``csrc/fused_conv2d_bias_act.cu``.
"""
from deepcv_tpu_torch.hyperparams import Hyperparameters  # noqa: F401
from deepcv_tpu_torch.utils import resolve_device, set_seeds  # noqa: F401

__version__ = "0.1.0"
