"""Reserved YAML architecture-spec tokens.

Counterpart of ``deepcv_tpu/spec/tokens.py`` (copied). The nested-module
token is accepted in both spellings, ``_nested_deepcv_module`` and
``_nested_deepcvmodule``.
"""


class YamlTokens:
    FROM = "_from"
    NAME = "_name"
    NAS_LAYER_CHOICE = "_nas_layer_choice"
    NESTED_DEEPCV_MODULE = "_nested_deepcv_module"
    NESTED_DEEPCV_MODULE_ALT = "_nested_deepcvmodule"
    FROM_NAS_INPUT_CHOICE = "_from_nas_input_choice"
    REDUCTION = "_reduction"
    NEW_BRANCH_FROM_TENSOR = "_new_branch_from_tensor"
    N_CHOSEN = "_n_chosen"
    RETURN_MASK = "_return_mask"
    CANDIDATES = "_candidates"

    ALL = (FROM, NAME, NAS_LAYER_CHOICE, NESTED_DEEPCV_MODULE,
           NESTED_DEEPCV_MODULE_ALT, FROM_NAS_INPUT_CHOICE, REDUCTION,
           NEW_BRANCH_FROM_TENSOR, N_CHOSEN, RETURN_MASK, CANDIDATES)
