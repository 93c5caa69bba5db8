from deepcv_tpu_torch.spec.tokens import YamlTokens  # noqa: F401
from deepcv_tpu_torch.spec.creators import (  # noqa: F401
    CreatorContext, ForwardCallback, submodule_creator, get_creator,
    TENSOR_REDUCTION_FNS, get_reduction_fn,
)
from deepcv_tpu_torch.spec.graph import SpecModule, define_nn_architecture, SpecError  # noqa: F401
from deepcv_tpu_torch.spec.module import DeepcvModule, DeepcvModuleDescriptor  # noqa: F401
