"""Datasheet peaks of the NVIDIA H100 variants (NVIDIA's data sheets, dense
rates without sparsity, at the full power limit) and the least time a
kernel's work could take on them: the bounds that `chip_smoke.py` and the
decode-anatomy probe print; and the single-launch event timing both use."""

from __future__ import annotations


def card_peaks(name: str) -> dict:
    """Peaks of the H100 variant `name` (as `torch.cuda.get_device_name`
    gives it): HBM bytes/s, bf16 tensor-core FLOP/s, int8 tensor-core OP/s
    and float32 (non-tensor) FLOP/s."""
    if "PCIe" in name:
        return {"hbm": 2.0e12, "bf16": 756e12, "int8": 1513e12, "f32": 51e12,
                "part": "PCIe"}
    if "NVL" in name:
        return {"hbm": 3.9e12, "bf16": 835e12, "int8": 1671e12, "f32": 60e12,
                "part": "NVL"}
    return {"hbm": 3.35e12, "bf16": 989e12, "int8": 1979e12, "f32": 67e12,
            "part": "SXM"}


def bound_ms(peaks: dict, nbytes: int, ops: dict) -> tuple[float, str]:
    """Least time in ms on a card with `peaks` (`card_peaks`): the bytes
    over the HBM rate or the operations over the peak rate of their type,
    whichever is larger; and which of the two it is."""
    t_bytes = nbytes / peaks["hbm"]
    t_ops = sum(n / peaks[kind] for kind, n in ops.items())
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def single_launch_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median ms of `iters` CUDA-event windows around one call of `fn`
    each, after `warmup` calls. A window holds the host's dispatch of the
    call as well as the kernel."""
    import statistics

    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)
