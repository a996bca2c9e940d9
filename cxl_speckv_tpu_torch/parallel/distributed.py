"""Bringing up a world of ranks: one process a rank.

Counterpart of `cxl_speckv_tpu/parallel/distributed.py`: `initialize` of
its `initialize_multihost`. The JAX package calls
`jax.distributed.initialize` once a host and lays one mesh over every
host's devices ordered host-major (`host_major_devices`); here each rank is
its own process, joined by `torch.distributed.init_process_group`, and a
launcher numbers one host's ranks contiguously, so the mesh's rank-major
layout (`parallel/mesh.py`) keeps its innermost axis, tp, within a host:

- ranks on the CPU use gloo;
- ranks on cards use NCCL when each has a card of its own, and gloo when
  they share one (NCCL refuses two ranks on one device; `chip_smoke.py`'s
  `[parallel]` phase records its error);
- every group has an explicit timeout, so that a rank whose command stream
  diverged from the others fails instead of waiting forever.

`launch` starts the ranks as subprocesses (`python -m module --rank r
--world n --port p ...`), never by fork: CUDA refuses a fork after its
initialization, and a worker starts from a fresh interpreter that runs only
what its module imports. The launcher itself holds the world's rendezvous
store (`host_store`), bound to a port before any rank starts, and the ranks
join it as clients: no port is picked free and bound later, so no other
process can take it in between.
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
import time

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 60.0


def host_store(world_size: int, timeout_s: float = DEFAULT_TIMEOUT_S):
    """The rendezvous store of a world of `world_size` ranks, listening on
    a localhost port the OS picks; returns (store, port). Keep the store
    alive until the ranks have finished."""
    store = dist.TCPStore("127.0.0.1", 0, world_size, is_master=True,
                          timeout=datetime.timedelta(seconds=timeout_s),
                          wait_for_workers=False)
    return store, store.port


def rank_device(device: str | None, local_rank: int,
                local_world: int) -> torch.device:
    """The device a rank serves on: "cpu" when asked; otherwise
    `cuda:{local_rank}`, or `cuda:0` for every rank when the host has fewer
    cards than ranks (they share it)."""
    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the ranks on the CPU")
    if torch.cuda.device_count() >= local_world:
        return torch.device("cuda", local_rank)
    return torch.device("cuda", 0)


def backend_for(device: torch.device, local_world: int) -> str:
    """gloo on the CPU and for ranks that share a card, NCCL when each rank
    has a card of its own."""
    if device.type == "cpu":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= local_world else "gloo"


def initialize(rank: int, world_size: int, port: int, *,
               device: str | None = None, backend: str | None = None,
               local_rank: int | None = None,
               local_world: int | None = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the world whose store (`host_store`) listens at
    localhost:`port` as `rank` of `world_size`; returns this rank's device
    (`rank_device`). `backend` None picks it by `backend_for`. Every rank
    must call it with the same world size and port."""
    local_rank = rank if local_rank is None else local_rank
    local_world = world_size if local_world is None else local_world
    dev = rank_device(device, local_rank, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or backend_for(dev, local_world)
    kw = {"device_id": dev} if backend == "nccl" else {}
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore("127.0.0.1", port, world_size, is_master=False,
                          timeout=timeout)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size, timeout=timeout, **kw)
    return dev


def new_group(ranks: list[int]):
    """A subgroup of the world's `ranks` with an explicit timeout (torch
    gives a group made without one 30 minutes). Collective: every rank of
    the world calls it, in the same order."""
    return dist.new_group(sorted(ranks),
                          timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def launch(module: str, world_size: int, argv: list[str] | None = None, *,
           timeout_s: float = 300.0, env: dict | None = None,
           cwd: str | None = None, log_dir: str | None = None) -> list[int]:
    """Run `python -m module --rank r --world world_size --port P *argv` for
    every rank r at once, P the port of the store this process holds for
    them, and wait for all of them. A rank still running at `timeout_s` is
    killed with the others.
    Returns the return codes in rank order (-9 for a killed rank). With
    `log_dir`, rank r's standard output and errors go to
    `{log_dir}/rank{r}.log`."""
    store, port = host_store(world_size)
    procs, logs = [], []
    try:
        for r in range(world_size):
            out = None
            if log_dir is not None:
                out = open(os.path.join(log_dir, f"rank{r}.log"), "w")
                logs.append(out)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", module, "--rank", str(r), "--world",
                 str(world_size), "--port", str(port), *(argv or [])],
                env=env, cwd=cwd, stdout=out,
                stderr=subprocess.STDOUT if out is not None else None))
        deadline = time.monotonic() + timeout_s
        rcs: list[int | None] = [None] * world_size
        while any(rc is None for rc in rcs):
            if time.monotonic() > deadline:
                break
            for i, p in enumerate(procs):
                if rcs[i] is None:
                    rcs[i] = p.poll()
            if any(rc not in (None, 0) for rc in rcs):
                # one rank failed: the others would wait on it until their
                # collective timeout
                break
            time.sleep(0.05)
        return [rc if rc is not None else -9 for rc in rcs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
        del store


def add_rank_args(ap) -> None:
    """The arguments `launch` passes to every rank."""
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--port", type=int, default=0)
