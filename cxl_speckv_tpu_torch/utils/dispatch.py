"""Measured per-dispatch cost -> the automatic decode horizon.

Counterpart of `cxl_speckv_tpu/utils/dispatch.py`. With
`EngineConfig.decode_horizon = 0` (the default) the engine measures the
cost of one trivial program on its device, synchronised by fetching its
value, once per process and device type, and derives how many decode steps
to fuse into one round from it and the model's weight bytes: the next power
of two of 12 * dispatch_ms / step_ms, clamped to [1, cap], where
step_ms = param_bytes / STREAM_BPS * 1e3 + STEP_FLOOR_MS is one fused
step's modelled time.

The two step constants are the port's own, from `chip_smoke.py`'s
`prefetch` phase (`prefetch_default_arm`) on one NVIDIA H100 80GB HBM3 at
a 700.00 W power limit. The rate comes from rounds replayed from their
CUDA graphs (`models/round_graph.py`), so that a step's time is the
device's and not the host's dispatch: a fused decode step of Llama-3-8B
W8A16 at 8 lanes (the median of 8 rounds a depth, a replayed one, / 32)
took 2.816 ms at its first 8 layers (2.798 GB of weights) and 1.551 ms
at its first 4 (1.925 GB). The slope is the rate, 690.3 GB/s (the
reference's TPU constant is 700 GB/s; a second run gave 3.320 / 1.802
ms, 575.4 GB/s); with it the whole 32-layer model (8.03 GB) streams in
11.6 ms a step, where the anatomy's replayed round measures 11.55 device
ms. The floor is not re-fitted from these rounds: their line falls to
-1.237 ms at no weights (the embedding's 1.05 GB is gathered, not
streamed), and the 8-layer step less its 8 layers at the slope's 0.316
ms a layer leaves 0.29 ms, which is the replayed step of a model with no
layers; a small model's step is bound by its launches, not its bytes,
and with 0.29 ms the rule would fuse 4 steps of the tiny test model at a
0.05 ms dispatch cost, where the reference derives 1. So the floor stays
the eager rounds' fit (2.06 ms, the 8-layer step less its 8 layers at
the slope then, when every launch was dispatched from the host; another
run gave 48.7 GB/s and -32.0 ms on a slower host). The constants scale
the horizon only: a factor of 2 in either moves the result by one power
of two. With the dispatch cost measured on the card (0.0419-0.1856 ms)
the rule derives 1 for every model the repository serves, as the
reference's docstring says local runtimes do.

`SPECKV_DISPATCH_MS` pins the dispatch cost without measuring (the
reference's knob: tests pin it so that a loaded machine cannot change
their scheduling).
"""

from __future__ import annotations

import os
import time

import torch

from cxl_speckv_tpu_torch.ops.wquant import QuantizedTensor

# one fused decode step, fitted on an NVIDIA H100 80GB HBM3, 700.00 W power
# limit (chip_smoke.py, phase "prefetch"; the docstring): the rate from
# rounds replayed from their CUDA graphs, the floor from eager rounds
_STREAM_BPS = 690.3e9         # bytes / s
_STEP_FLOOR_MS = 2.06         # ms

_dispatch_ms_cache: dict[str, float] = {}


def measured_dispatch_ms(device=None) -> float:
    """Wall-clock cost of one trivial program on `device` (None: the card),
    synchronised by fetching its value (`.item()`): the first fetch is
    discarded, the next 3 averaged. Cached per device type for the
    process; `SPECKV_DISPATCH_MS` pins it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type in _dispatch_ms_cache:
        return _dispatch_ms_cache[dev.type]
    pinned = os.environ.get("SPECKV_DISPATCH_MS")
    if pinned is not None:
        _dispatch_ms_cache[dev.type] = float(pinned)
        return _dispatch_ms_cache[dev.type]
    a = torch.zeros(128, 128, dtype=torch.float32, device=dev)
    (a * 1.0001).sum().item()      # first launch and fetch, excluded
    t0 = time.monotonic()
    reps = 3
    for _ in range(reps):
        (a * 1.0001).sum().item()
    _dispatch_ms_cache[dev.type] = (time.monotonic() - t0) / reps * 1000.0
    return _dispatch_ms_cache[dev.type]


def derive_decode_horizon(param_bytes: int, cap: int = 32,
                          device=None) -> int:
    """decode_horizon from the measured dispatch cost on `device` and the
    model's weight bytes: the next power of two of 12 * dispatch_ms /
    step_ms, clamped to [1, cap]."""
    step_ms = param_bytes / _STREAM_BPS * 1000.0 + _STEP_FLOOR_MS
    ratio = 12.0 * measured_dispatch_ms(device) / step_ms
    h = 1
    while h < min(ratio, cap):
        h *= 2
    return max(1, min(h, cap))


def params_byte_size(params) -> int:
    """Bytes of a param tree (dicts and lists of tensors); a quantized
    weight counts its stored values (an int4 weight nibble-packed, two a
    byte, as the JAX package counts it) and its scales."""
    if isinstance(params, QuantizedTensor):
        return params_byte_size(params.q) + params_byte_size(params.s)
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    if isinstance(params, dict):
        return sum(params_byte_size(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(params_byte_size(v) for v in params)
    return 0
