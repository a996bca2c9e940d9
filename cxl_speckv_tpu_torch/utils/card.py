"""Datasheet peaks of the NVIDIA H100 variants (NVIDIA's data sheets, dense
rates without sparsity, at the full power limit) and the least time a
kernel's work could take on them: the bounds that `chip_smoke.py` and the
decode-anatomy probe print; and the timings both use: single-launch
event windows, launches back to back, and launches replayed from a CUDA
graph (device time without the host's dispatch)."""

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


def back_to_back_us(fn, iters: int, device: str = "cuda") -> float:
    """µs a call: `iters` calls back to back between two CUDA events (the
    host clock on the CPU), after two warm-up calls. Unlike a
    single-launch window, the host's dispatch of one call overlaps the
    device's run of the one before."""
    import time

    import torch

    fn()
    fn()
    if device == "cpu":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters * 1e3


def graph_us(fn, iters: int, replays: int = 3) -> float:
    """µs a call on the device alone: `iters` calls captured in one CUDA
    graph (after two warm-up calls on the capturing side stream), replayed
    `replays` times between two CUDA events. No host dispatch between the
    launches, unlike `back_to_back_us` when a call's host work outlasts its
    kernels. Side effects of `fn` on the host (launch counters) happen at
    capture only."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (iters * replays) * 1e3


class StreamHold:
    """A hold on a CUDA stream that the caller releases: `csrc/
    stream_hold.cu`'s kernel, queued on `stream` (default: the current
    one), spins on a word of pinned host memory, so work queued behind it
    waits until `release()` (or leaving the `with` block), however slow
    the host is. The kernel gives up after `max_s` seconds so that a
    forgotten hold cannot stall the card; `timed_out()`, once the stream
    has passed the hold, says whether it did."""

    def __init__(self, stream=None, max_s: float = 30.0):
        import torch

        from cxl_speckv_tpu_torch.ops import cuda_build

        self.flag = torch.zeros(1, dtype=torch.int32, pin_memory=True)
        st = stream if stream is not None else torch.cuda.current_stream()
        err = cuda_build.kernel("stream_hold")(
            self.flag.data_ptr(), int(max_s * 1e9), st.cuda_stream)
        cuda_build.check_launch("stream_hold", err)

    def release(self) -> None:
        if int(self.flag[0]) == 0:
            self.flag[0] = 1

    def timed_out(self) -> bool:
        return int(self.flag[0]) == 2

    def __enter__(self) -> "StreamHold":
        return self

    def __exit__(self, *exc) -> None:
        self.release()
