"""The decode round as one dispatch: `decode_multi_packed` captured in a
CUDA graph and replayed.

Counterpart of the reference's jitted round: `cxl_speckv_tpu/models/
llama.py:781-789` jits `decode_multi_packed` (and `:661-666` the
`decode_multi` inside it), so that one engine round is one program: the
sampling words decoded on the device, the key derived from the packed
counter, every layer of every step, the penalties, the logprobs and the
LSTM leg. Eager PyTorch dispatches the same round as some 2600 launches a
step from the host; a `RoundGraphs` cache captures it once per key and
then replays it, one launch a round.

What a round's program depends on is its key (`round_key`): everything
the reference makes static or that changes the launches (batch and
packed width, horizon, the scheme or per-layer schemes, `sampled`,
`nucleus`, `logprobs_k`, `return_logits`, the pen plane, the LSTM leg and
its EOS class) and the identity of the params, pools and pen plane the
graph reads. A key's first round runs eagerly: it is a real round, and it
builds the kernels and warms the allocator. Its second round captures the
key (capture records kernels and runs none) and replays it; every later
round copies its packed inputs into the key's static buffer (one host ->
device copy, as the eager round's upload) and replays. So no round is
lost or run twice.

- Sampling: one generator per sampling key, registered with the graph and
  reseeded to `(rng_seed << 32) + counter` before each replay; a replay
  draws what the eager round draws at that seed (`seeded_generator`).
- The LSTM leg's weights live in the entry's own copy, refreshed from the
  engine's tree when it publishes a new one.
- Launch counters (`launch_counters`): the wrappers count at capture, when
  nothing runs; `LaunchDelta` takes the capture's counts back out and
  adds them once at every replay.
- Memory: every graph of a cache shares one pool (they replay one at a
  time); a key's outputs are the graph's tensors and are overwritten by
  its next replay (the engine copies them to the host first).
- Invalidation: a call whose params, pools or pen plane are other objects
  than the cache's drops every graph (a scheme switch rebuilds the pools;
  `clear` drops them at once).

The cache is for one device without a mesh: the CPU has no graphs, and a
mesh rank's gloo collectives run on the host. A failed capture or replay
raises; nothing reruns eagerly in its place.
"""

from __future__ import annotations

import gc
import time
from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch


def launch_counters() -> list[tuple[object, str]]:
    """(owner, attribute) of every launch counter a decode round's
    wrappers bump: the kernels' counts and the quantized matmul calls."""
    from cxl_speckv_tpu_torch.ops import wquant
    from cxl_speckv_tpu_torch.ops.chunk_attention_cuda import (
        paged_chunk_attention_cuda,
    )
    from cxl_speckv_tpu_torch.ops.paged_attention import paged_attention
    from cxl_speckv_tpu_torch.ops.w4_unpack import w4_unpack
    from cxl_speckv_tpu_torch.ops.w4a16_mm import w4a16_mm
    from cxl_speckv_tpu_torch.ops.w8a16_mm import w8a16_mm

    return [(paged_attention, "launches"),
            (paged_attention, "sink_launches"),
            (paged_attention, "split_launches"),
            (paged_chunk_attention_cuda, "launches"),
            (paged_chunk_attention_cuda, "sink_launches"),
            (w8a16_mm, "launches"), (w8a16_mm, "tied_launches"),
            (w4a16_mm, "launches"), (w4_unpack, "launches"),
            (wquant, "quantized_calls"), (wquant.operand, "calls")]


def _snapshot(counters) -> list:
    return [Counter(v) if isinstance(v := getattr(o, a), Counter) else v
            for o, a in counters]


class LaunchDelta:
    """What one capture added to `counters` (a `launch_counters()` list):
    taken from a snapshot before the capture. `apply(+1)` adds it (a
    replay), `apply(-1)` takes it back out (the capture ran nothing).
    Counters are read by attribute at every call, since callers may
    replace an integer count."""

    def __init__(self, counters, before: list):
        self.counters = counters
        self.delta = []
        for (o, a), b in zip(counters, before):
            now = getattr(o, a)
            if isinstance(now, Counter):
                d = Counter(now)
                d.subtract(b)
                self.delta.append(Counter({k: n for k, n in d.items() if n}))
            else:
                self.delta.append(now - b)

    def apply(self, sign: int = 1) -> None:
        for (o, a), d in zip(self.counters, self.delta):
            now = getattr(o, a)
            if isinstance(now, Counter):
                for k, n in d.items():
                    now[k] += sign * n
            else:
                setattr(o, a, now + sign * d)


def round_key(packed_shape, kv_dtype, *, pen: bool, lstm: bool,
              horizon: int, sampled: bool, nucleus: bool,
              return_logits: bool, logprobs_k: int, lstm_eos: int,
              lstm_cols: int, bound: tuple) -> tuple:
    """A captured round's key: the packed shape (batch, table + LSTM
    columns; the pen columns follow `pen`), the scheme or per-layer
    schemes, the static flags, and `bound`, the ids of the params, pools
    and pen plane it reads."""
    return (tuple(packed_shape), kv_dtype, pen, lstm, horizon, sampled,
            nucleus, return_logits, logprobs_k,
            lstm_eos if lstm else None, lstm_cols if lstm else 0, bound)


@dataclass
class _Entry:
    graph: torch.cuda.CUDAGraph
    buf: torch.Tensor                       # the packed inputs (+ pen_info)
    out: object                             # what the round returns
    gen: torch.Generator | None
    lstm: dict | None                       # the leg's weights, its own copy
    lstm_src: dict | None                   # the tree they were copied from
    delta: LaunchDelta


class RoundGraphs:
    """Captured decode rounds of one engine (or one draft model) on one
    CUDA device, by `round_key`. `replay` is `decode_multi_packed`'s graph
    route; `statistics` what `Engine.get_statistics()` reports."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"RoundGraphs: CUDA graphs need a CUDA device, "
                             f"not {self.device}")
        self.counters = launch_counters()
        self._pool = None
        self._seen: set = set()             # keys whose first round ran
        self._graphs: dict[tuple, _Entry] = {}
        self._bound = None                  # (params, pools, pen plane)
        self.graph_rounds = 0
        self.eager_rounds = 0
        self.graph_captures = 0
        self.graph_capture_ms = 0.0
        self.graph_drops = 0
        self.graph_pool_bytes = 0
        # when a list: a (start, end) CUDA-event pair around each replay,
        # the replayed round's device time (chip_smoke.py, round_anatomy)
        self.replay_events: list | None = None

    def clear(self) -> None:
        """Drop every graph and forget every key (the next round of each
        runs eagerly again)."""
        self.graph_drops += len(self._graphs)
        self._graphs.clear()
        self._seen.clear()
        self._bound = None

    def _bind(self, params, pools, pen_counts) -> tuple:
        """Drop what was captured against other params, pools or pen
        plane; returns the ids the key carries."""
        b = self._bound
        if b is not None and (b[0] is not params
                              or any(x is not y for x, y in zip(b[1], pools))
                              or (pen_counts is not None and b[2] is not None
                                  and b[2] is not pen_counts)):
            self.clear()
            b = None
        if b is None:
            b = (params, tuple(pools), pen_counts)
        elif b[2] is None and pen_counts is not None:
            b = (b[0], b[1], pen_counts)
        self._bound = b
        return (id(params), tuple(id(t) for t in pools),
                None if pen_counts is None else id(pen_counts))

    def replay(self, params, config, kv_dtype, packed: np.ndarray, pools,
               pen_info, pen_counts, lstm_params, *, rng_seed: int, **kw):
        """One decode round's outputs from its key's graph (captured at the
        key's second round), or None for a key's first round, which the
        caller runs eagerly. Arguments as `decode_multi_packed` gets them;
        `kw` are `round_from_buffer`'s, the flags already read from the
        packed words."""
        from cxl_speckv_tpu_torch.prefetcher.lstm import _leaves

        lstm = lstm_params is not None
        key = round_key(packed.shape, kv_dtype, pen=pen_counts is not None,
                        lstm=lstm, **{k: kw[k] for k in (
                            "horizon", "sampled", "nucleus", "return_logits",
                            "logprobs_k", "lstm_eos", "lstm_cols")},
                        bound=self._bind(params, pools, pen_counts))
        if key not in self._seen:
            self._seen.add(key)
            self.eager_rounds += 1
            return None
        host = packed if pen_info is None else np.concatenate(
            [packed, np.asarray(pen_info, np.int32)], 1)
        e = self._graphs.get(key)
        if e is None:
            e = self._graphs[key] = self._capture(
                params, config, kv_dtype, host.shape, pools, pen_counts,
                lstm_params, kw)
        e.buf.copy_(torch.from_numpy(host))
        if e.gen is not None:
            # the seed `llama.seeded_generator` gives the eager round
            e.gen.manual_seed((rng_seed << 32) + int(packed[0, 3]))
        if lstm and lstm_params is not e.lstm_src:
            for dst, src in zip(_leaves(e.lstm), _leaves(lstm_params)):
                dst.copy_(src)
            e.lstm_src = lstm_params
        if self.replay_events is None:
            e.graph.replay()
        else:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            e.graph.replay()
            ev[1].record()
            self.replay_events.append(ev)
        e.delta.apply(+1)
        self.graph_rounds += 1
        return e.out

    def _capture(self, params, config, kv_dtype, shape, pools, pen_counts,
                 lstm_params, kw) -> _Entry:
        from cxl_speckv_tpu_torch.models.llama import round_from_buffer
        from cxl_speckv_tpu_torch.prefetcher.lstm import _tree_map

        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        buf = torch.zeros(shape, dtype=torch.int32, device=self.device)
        gen = (torch.Generator(device=self.device) if kw["sampled"]
               else None)
        lstm = (_tree_map(lambda x: x.detach().clone(), lstm_params)
                if lstm_params is not None else None)
        graph = torch.cuda.CUDAGraph()
        if gen is not None:
            graph.register_generator_state(gen)
        before = _snapshot(self.counters)
        t0 = time.monotonic()
        # no cyclic collection during the capture: freeing a CUDA graph
        # held in a cycle (an engine dropped earlier) ends the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            # thread_local: the stager, the LSTM trainer and the HTTP loop
            # may issue CUDA calls from their own threads meanwhile
            with torch.cuda.graph(graph, pool=self._pool,
                                  capture_error_mode="thread_local"):
                out = round_from_buffer(params, config, kv_dtype, buf,
                                        pools, pen_counts, lstm, gen, **kw)
        finally:
            if collecting:
                gc.enable()
        self.graph_capture_ms += (time.monotonic() - t0) * 1e3
        self.graph_captures += 1
        delta = LaunchDelta(self.counters, before)
        delta.apply(-1)
        self.graph_pool_bytes = self._pool_bytes()
        return _Entry(graph, buf, out, gen, lstm, lstm_params, delta)

    def _pool_bytes(self) -> int:
        """Bytes the caching allocator holds in this cache's graph pool."""
        pool = tuple(self._pool)
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == pool)

    @property
    def graphs_held(self) -> int:
        return len(self._graphs)

    def statistics(self) -> dict:
        return {"round_route": "graph", "graph_rounds": self.graph_rounds,
                "eager_rounds": self.eager_rounds,
                "graph_captures": self.graph_captures,
                "graph_capture_ms": self.graph_capture_ms,
                "graphs_held": self.graphs_held,
                "graph_drops": self.graph_drops,
                "graph_pool_bytes": self.graph_pool_bytes}

    def reset_statistics(self) -> None:
        self.graph_rounds = self.eager_rounds = 0
        self.graph_captures = self.graph_drops = 0
        self.graph_capture_ms = 0.0
