"""Lockstep serving frontend: N processes, one command stream.

A copy of `cxl_speckv_tpu/parallel/lockstep.py` (that module imports no
JAX, but the port imports nothing of the JAX package), with
`TorchProcessTransport` in place of its `JaxProcessTransport`.

Every rank of a mesh runs the whole engine's bookkeeping, so every rank's
engine must make the same admission and scheduling decisions, even though
clients submit to different processes at different times. The mechanism is
a replicated command log with a deterministic merge:

1. each process buffers its clients' commands locally (`submit`, control
   knobs), tagged (client_id = process, client_seq = monotonic);
2. at a round boundary every process exchanges its buffered entries
   (stage + all-gather) and sorts the union by (client_id, client_seq): a
   pure function, so every process derives the same total order;
3. the merged commands are applied to the engine in that order. Engine
   req_ids are assigned sequentially, hence also identical everywhere.

The transport is injectable: `TorchProcessTransport` rides a gloo
all-gather of `torch.distributed`; tests drive N frontends through the
in-memory `LocalFabric` and hold the lockstep invariant: different
per-process submission orders, identical engine command streams.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass, field
from typing import Sequence


@dataclass(frozen=True, order=True)
class LogEntry:
    """One client command. Ordering = (client_id, client_seq): the merge
    key that every process agrees on without communication."""
    client_id: int
    client_seq: int
    # "request" | "continue" | "cancel" | "depth" | "kv_dtype"
    kind: str = field(compare=False)
    payload: tuple = field(compare=False)


def merge_rounds(gathered: Sequence[Sequence[LogEntry]]) -> list[LogEntry]:
    """Deterministic union of every process's buffered entries. Pure: any
    process given the same gathered lists produces the same order."""
    merged: list[LogEntry] = []
    for entries in gathered:
        merged.extend(entries)
    merged.sort()
    return merged


class LockstepFrontend:
    """Wraps a (mesh-sharded) Engine so N processes apply identical command
    streams. All processes apply ALL requests — batch lanes are dp-sharded
    by the engine's mesh, not by dropping requests per host.

    Round protocol: `stage_round()` publishes this process's buffered
    commands to the transport; `apply_round()` gathers every process's
    commands and applies the deterministic merge to the engine.
    `commit_round()` does both — across processes the gather blocks until all
    processes arrive, which IS the lockstep barrier."""

    def __init__(self, engine, process_id: int, transport):
        self.engine = engine
        self.process_id = int(process_id)
        self.transport = transport
        self._seq = 0
        self._buffer: list[LogEntry] = []
        # client-local handle -> engine req_id (filled at apply_round)
        self._handles: dict[tuple[int, int], int] = {}

    # -- client side (local, buffered) ----------------------------------

    def submit(self, prompt: list[int], max_new_tokens: int = 64,
               temperature: float = 0.0, **kwargs) -> tuple[int, int]:
        """Buffer a generation request; returns a client-local handle.
        The engine req_id exists only after the round commits. Accepts the
        FULL Engine.add_request surface (top_p, session, stop_token_ids,
        stop_sequences, ignore_eos, eos_token_id, logprobs, prompt_logprobs,
        frequency/presence/repetition penalties) — every kwarg replicates
        through the log, so the multi-host frontend serves the same API as
        the single-host engine."""
        return self._push("request",
                          (tuple(prompt),
                           dict(max_new_tokens=max_new_tokens,
                                temperature=temperature, **kwargs)))

    def continue_session(self, session_id: int, new_tokens: list[int],
                         **kwargs) -> tuple[int, int]:
        """Buffer the next turn of a session. `session_id` comes from a
        committed turn's EngineOutput — identical on every process, so it
        replicates directly."""
        return self._push("continue",
                          (int(session_id), tuple(new_tokens), dict(kwargs)))

    def cancel(self, handle: tuple[int, int]) -> tuple[int, int] | None:
        """Cancel by client handle. A handle whose round already committed
        replicates a cancel carrying the engine req_id (identical on every
        process); a still-buffered handle is withdrawn locally — it never
        reached any engine, so nothing needs replicating (returns None)."""
        if handle in self._handles:
            return self._push("cancel", (self._handles[handle],))
        before = len(self._buffer)
        self._buffer = [e for e in self._buffer
                        if (e.client_id, e.client_seq) != handle]
        if len(self._buffer) == before:
            raise KeyError(f"unknown or foreign handle {handle}")
        return None

    def set_prefetch_depth(self, depth: int) -> tuple[int, int]:
        return self._push("depth", (depth,))

    def set_kv_dtype(self, kv_dtype) -> tuple[int, int]:
        return self._push("kv_dtype", (kv_dtype,))

    def _push(self, kind: str, payload: tuple) -> tuple[int, int]:
        handle = (self.process_id, self._seq)
        self._buffer.append(LogEntry(self.process_id, self._seq, kind,
                                     payload))
        self._seq += 1
        return handle

    # -- lockstep side (identical on every process) ---------------------

    def stage_round(self) -> None:
        staged, self._buffer = self._buffer, []
        self.transport.stage(self.process_id, staged)

    def apply_round(self) -> dict[tuple[int, int], int]:
        """Gather every process's staged commands and apply the merged
        order to the engine. Returns handle -> engine req_id for requests
        submitted through THIS process (other hosts' requests are applied
        too — the engine is global — but their handles belong to their
        own frontends)."""
        merged = merge_rounds(self.transport.gather(self.process_id))
        new: dict[tuple[int, int], int] = {}
        for e in merged:
            if e.kind == "request":
                prompt, kwargs = e.payload
                rid = self.engine.add_request(list(prompt), **kwargs)
                if e.client_id == self.process_id:
                    new[(e.client_id, e.client_seq)] = rid
            elif e.kind == "continue":
                sid, toks, kwargs = e.payload
                rid = self.engine.continue_session(sid, list(toks), **kwargs)
                if e.client_id == self.process_id:
                    new[(e.client_id, e.client_seq)] = rid
            elif e.kind == "cancel":
                self.engine.cancel(e.payload[0])
            elif e.kind == "depth":
                self.engine.set_prefetch_depth(*e.payload)
            elif e.kind == "kv_dtype":
                self.engine.set_kv_dtype(*e.payload)
            else:  # pragma: no cover - future kinds are a protocol error
                raise ValueError(f"unknown log entry kind {e.kind!r}")
        self._handles.update(new)
        return new

    def commit_round(self) -> dict[tuple[int, int], int]:
        self.stage_round()
        return self.apply_round()

    def req_id(self, handle: tuple[int, int]) -> int:
        return self._handles[handle]

    def run(self, max_steps: int = 100000):
        return self.engine.run(max_steps)

    def step(self):
        return self.engine.step()


# -- transports ---------------------------------------------------------


class TorchProcessTransport:
    """The transport of real processes: pickle this process's entries,
    all-gather their sizes, then the blobs padded to the largest, over a
    gloo group of every rank made for the control plane, so that the blobs
    never touch a card (the JAX `JaxProcessTransport` gathers them through
    `multihost_utils.process_allgather`). `gather` blocks until every
    process has staged: the lockstep barrier. Build it on every rank at the
    same point (a new group is a collective call); the world must be
    initialized (`parallel/distributed.py`). The blobs are this program's
    own pickles, written by its ranks."""

    def __init__(self, group=None):
        import torch.distributed as dist

        self._group = group if group is not None else dist.new_group(
            backend="gloo")
        self._staged: list[LogEntry] = []

    def stage(self, process_id: int, entries: list[LogEntry]) -> None:
        self._staged = list(entries)

    def gather(self, process_id: int) -> list[list[LogEntry]]:
        import numpy as np
        import torch
        import torch.distributed as dist

        world = dist.get_world_size(self._group)
        blob = torch.from_numpy(np.frombuffer(
            pickle.dumps(self._staged), dtype=np.uint8).copy())
        sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
        dist.all_gather(sizes, torch.tensor([blob.numel()]),
                        group=self._group)
        n = [int(s) for s in sizes]
        width = max(max(n), 1)
        padded = torch.zeros(width, dtype=torch.uint8)
        padded[:blob.numel()] = blob
        blobs = [torch.empty(width, dtype=torch.uint8) for _ in range(world)]
        dist.all_gather(blobs, padded, group=self._group)
        return [pickle.loads(blobs[i][:n[i]].numpy().tobytes())
                for i in range(world)]


class LocalFabric:
    """In-memory N-process transport for tests. Every simulated process
    stages its round, then each gathers; the round resets once all
    processes have gathered. Enforces the lockstep protocol: gathering
    before every process staged raises."""

    def __init__(self, num_processes: int):
        self.num_processes = num_processes
        self._staged: list[list[LogEntry] | None] = [None] * num_processes
        self._gathered: set[int] = set()

    def stage(self, process_id: int, entries: list[LogEntry]) -> None:
        if self._staged[process_id] is not None:
            raise RuntimeError(
                f"process {process_id} staged twice in one round")
        self._staged[process_id] = list(entries)

    def gather(self, process_id: int) -> list[list[LogEntry]]:
        missing = [i for i, s in enumerate(self._staged) if s is None]
        if missing:
            raise RuntimeError(
                f"lockstep violation: gather with processes {missing} "
                "not yet staged")
        gathered = [list(s) for s in self._staged]  # type: ignore
        self._gathered.add(process_id)
        if len(self._gathered) == self.num_processes:
            self._staged = [None] * self.num_processes
            self._gathered = set()
        return gathered
