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
`prefetch` phase on one NVIDIA H100 80GB HBM3 at a 700.00 W power limit:
a fused decode step of Llama-3-8B W8A16 at 8 lanes (a 32-step round's
time / 32) took 70.823 ms at its 32 layers (8.037 GB of weights) and
57.879 ms cut to its first 16 (4.544 GB), fitted as bytes / rate + floor:
269.8 GB/s and 41.0 ms. The rate holds the int8 -> bf16 weight copy of
every matmul call (`ops/wquant.py`); the floor is what does not scale with
the weights, mostly the host launching the step's eager kernels. A second
run of the same fit on the same card gave 75.326 / 38.052 ms, 93.7 GB/s
and a floor below zero: the step is host-bound, and its spread between
runs exceeds the weights' share, so both constants are known to a factor
of about 3. They scale the horizon only: a factor of 2 in either moves the
result by one power of two. With the dispatch cost measured there
(0.0493-0.0675 ms) the rule derives 1 for every model the repository
serves, with either fit, as the reference's docstring says local runtimes
do.

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
# power limit (chip_smoke.py, phase "prefetch")
_STREAM_BPS = 269.8e9         # bytes / s
_STEP_FLOOR_MS = 41.0         # ms

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
