from cxl_speckv_tpu_torch.prefetcher.controller import (  # noqa: F401
    PrefetchController,
    PrefetchStatistics,
)
from cxl_speckv_tpu_torch.prefetcher.lstm import LSTMPredictor  # noqa: F401
