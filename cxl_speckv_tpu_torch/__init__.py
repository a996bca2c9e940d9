"""cxl_speckv_tpu_torch — the PyTorch/CUDA port of `cxl_speckv_tpu`.

The same serving system (a paged, quantized, two-tier KV cache under a
continuous-batching engine for Llama-family models) in PyTorch, with the
JAX package's Pallas TPU kernels rewritten as CUDA kernels for NVIDIA Hopper
(`csrc/`). The module tree mirrors `cxl_speckv_tpu`, so each module's
counterpart has the same path. The port imports nothing of the JAX package:
the JAX-free modules it needs are copied here.

Entry points run on the card unless the caller passes `device="cpu"`, which
runs the kernels' plain PyTorch versions instead.
"""

__version__ = "0.1.0"

from cxl_speckv_tpu_torch.config import (  # noqa: F401
    CacheConfig,
    EngineConfig,
    KVDtype,
    PrefetchConfig,
    SystemConfig,
)
from cxl_speckv_tpu_torch.models.configs import (  # noqa: F401
    PRESETS,
    LlamaConfig,
    gemma2_9b,
    llama_3_2_1b,
    llama_3_8b,
    llama_3_70b,
    mistral_7b,
    tiny_test_config,
)
