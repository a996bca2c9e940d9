"""One device -> host copy for several result tensors.

The engine copies a dispatch's results to the host together: the tokens of
a decode round with their logprob tables, a spec round's verdict with its
tables. Each copy from the card synchronizes with it and costs a fixed
latency, so every 4-byte tensor (int32 or float32) is bit-cast to int32,
flattened and concatenated on the device, copied once, and split again on
the host. The JAX package's counterpart is its per-array `_fetch`.
"""

from __future__ import annotations

import numpy as np
import torch

_HOST = {torch.int32: np.int32, torch.float32: np.float32}


def fetch(*tensors: torch.Tensor) -> list[np.ndarray]:
    """numpy copies of `tensors` (int32 / float32, any shapes) through ONE
    device -> host copy."""
    if not tensors:
        return []
    flat = torch.cat([t.contiguous().view(torch.int32).reshape(-1)
                      for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[at:at + n].view(_HOST[t.dtype]).reshape(t.shape))
        at += n
    return out
