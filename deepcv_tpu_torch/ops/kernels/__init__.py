"""Hand-written CUDA kernels (``csrc/*.cu``), their ctypes wrappers and
their plain PyTorch versions. Nothing is compiled at import time."""
