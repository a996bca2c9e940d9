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
`prefetch` phase on one NVIDIA H100 80GB HBM3 at a 700.00 W power limit,
with every W8A16 matmul one launch of the fused int8 matmul
(`ops/w8a16_mm.py`, which reads each weight once): a fused decode step of
Llama-3-8B W8A16 at 8 lanes (a 32-step round's time / 32) took 13.089 ms
at its first 8 layers (2.798 GB of weights) and 7.574 ms at its first 4
(1.925 GB). The slope is the rate, 158.3 GB/s. The line through the two
points falls to -4.583 ms at no weights, because the embedding and head
(1.05 GB) do not cost what a layer's bytes cost; a negative floor would
make small models' steps negative, or zero, so the floor is the 8-layer
step less its 8 layers at the slope's 1.379 ms a layer: 2.06 ms (a second
run on a slower host gave 25.393 / 7.474 ms, 48.7 GB/s). Both are
host time more than weight streaming: the eager step launches each
layer's kernels from the host, and the device is busy 28.7% of a full
depth round (PERF.md §5). An earlier fit (with the int8 -> bf16 copy
in every matmul, 32 and 16 layers) gave 269.8 GB/s and 41.0 ms, and a
second run of it 93.7 GB/s and a floor below zero: the constants are
known to a factor of about 3. They scale the horizon only: a factor of 2
in either moves the result by one power of two. With the dispatch cost
measured on the card (0.0493-0.0675 ms) the rule derives 1 for every
model the repository serves, with either fit, as the reference's
docstring says local runtimes do.

`SPECKV_DISPATCH_MS` pins the dispatch cost without measuring (the
reference's knob: tests pin it so that a loaded machine cannot change
their scheduling).
"""

from __future__ import annotations

import os
import time

import torch

from cxl_speckv_tpu_torch.ops.wquant import QuantizedTensor

# one fused decode step, fitted on an NVIDIA H100 80GB HBM3, 700.00 W
# power limit (chip_smoke.py, phase "prefetch"; the docstring)
_STREAM_BPS = 158.3e9         # bytes / s
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
