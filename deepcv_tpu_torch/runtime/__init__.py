"""The host runtime: the C++ batch loader and the range coder, each built
from its source in this directory at first use."""
from deepcv_tpu_torch.runtime.native import (  # noqa: F401
    NativeBatchLoader, gather_batch, native_available)
