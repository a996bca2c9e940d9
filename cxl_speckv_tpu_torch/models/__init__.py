from cxl_speckv_tpu_torch.models.configs import (  # noqa: F401
    PRESETS,
    LlamaConfig,
    RopeScaling,
    gemma2_9b,
    llama_3_2_1b,
    llama_3_8b,
    llama_3_70b,
    mistral_7b,
    tiny_test_config,
)
from cxl_speckv_tpu_torch.models.llama import (  # noqa: F401
    decode_step,
    forward_dense,
    init_params,
    init_params_quantized,
)
