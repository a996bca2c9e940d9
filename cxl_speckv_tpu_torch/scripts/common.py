"""What the ported measurement and check scripts share: the `--device`
rule, the card's label on every line that carries a time, rate or size,
the host clock after a synchronize, and the device's busy time from
`torch.profiler`.

Every script here runs on the card by default and raises without CUDA; it
never falls back to the CPU. `--device cpu` runs the kernels' plain
versions, and then every time it prints is the host's, labelled so.
"""

from __future__ import annotations

import functools
import subprocess
import time

import torch

CPU_LABEL = "host CPU (plain versions; times are the host's)"


def add_device_arg(ap) -> None:
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the card (default; raises without CUDA), or cpu "
                         "for the plain versions on the host")


def resolve(device: str, name: str) -> str:
    """`device` if it can run; raises SystemExit for cuda without a card."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"{name}: unsupported device {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{name}: CUDA is not available; --device cpu runs "
                         f"the plain versions on the host")
    return device


@functools.cache
def card_label() -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` gives them (the name alone where
    nvidia-smi cannot be run)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
        return out[torch.cuda.current_device()].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(0)}, power limit not read"


def label(device: str) -> str:
    """The prefix of a line that carries a time, rate or size."""
    return card_label() if device == "cuda" else CPU_LABEL


def sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def wall(fn, device: str):
    """(fn(), seconds on the host clock), the device synchronized at both
    ends."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def timed_calls(fn, device: str, reps: int):
    """A warm call of `fn`, then `reps` timed ones; returns (the last
    call's result, the median host seconds of a call after
    `torch.cuda.synchronize()`, and on the card the median seconds of a
    CUDA-event window around each call, else None)."""
    import statistics

    out = fn()
    host, window = [], []
    for _ in range(reps):
        if device == "cuda":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            ev[0].record()
        out, dt = wall(fn, device)
        host.append(dt)
        if device == "cuda":
            ev[1].record()
            ev[1].synchronize()
            window.append(ev[0].elapsed_time(ev[1]) / 1e3)
    return (out, statistics.median(host),
            statistics.median(window) if window else None)


def device_busy_s(fn):
    """(fn(), seconds of device activity while it ran): the sum of every
    kernel's and copy's device time that `torch.profiler` (CUDA activity
    only) records, so the host's dispatch gaps between launches are not
    in it; None for the seconds when the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return out, (us / 1e6 if us else None)


def all_finished(outs) -> bool:
    """Every request's output is there and ended by length, EOS or a stop
    token (not "oom" or "cancelled")."""
    return all(o is not None and o.finish_reason in ("length", "eos", "stop")
               for o in outs)


def seeded(device: str, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen
