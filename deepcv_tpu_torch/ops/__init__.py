"""Building blocks and hand-written CUDA kernels of the port."""
