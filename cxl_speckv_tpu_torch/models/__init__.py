from cxl_speckv_tpu_torch.models.configs import (  # noqa: F401
    PRESETS,
    LlamaConfig,
    RopeScaling,
    gemma2_9b,
    gemma3_12b,
    gpt_oss_20b,
    llama_3_2_1b,
    llama_3_8b,
    llama_3_70b,
    mistral_7b,
    mixtral_8x7b,
    phi3_mini,
    qwen2_7b,
    qwen2_moe_57b,
    qwen3_8b,
    qwen3_moe_30b,
    tiny_test_config,
)
from cxl_speckv_tpu_torch.models import moe  # noqa: F401
from cxl_speckv_tpu_torch.models.checkpoint import (  # noqa: F401
    load_params,
    save_params,
)
from cxl_speckv_tpu_torch.models.llama import (  # noqa: F401
    decode_step,
    forward_dense,
    init_params,
    init_params_quantized,
)
