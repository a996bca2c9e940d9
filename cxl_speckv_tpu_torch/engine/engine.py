"""The serving engine: continuous batching over the tiered, quantized KV
cache, in PyTorch.

Counterpart of `cxl_speckv_tpu/engine/engine.py`, main path: `add_request`,
`generate`, `run`, `step` (batched chunked prefill, then single-step or
fused multi-step decode), stop / finish / OOM / preemption, and
`get_statistics`. Each `step()` is one engine iteration:

1. admit queued requests; prefill one chunk for up to max_batch_size of
   them in one pass (`models.llama.prefill_batch_packed`);
2. pick the decode group (round-robin over the oversubscribed running set),
   demand-fetch non-resident blocks, decode `decode_horizon` tokens
   (`models.llama.decode_multi_packed`);
3. retire finished requests, and the KV blocks that every running
   sequence's sliding window has left (Mistral-style uniform windows);
4. prefetch plan for upcoming groups, eviction, migration.

Every request keeps the KV scheme it was submitted under: `set_kv_dtype`
(the `speckv_set_compression_scheme` analog) changes it for new requests,
live between INT8 and FP8, which share the pool's bytes, and on an idle
engine across storage widths (INT4, BF16; `TieredKVCache.rebuild_storage`).
`CacheConfig.layer_kv_dtypes` instead fixes a scheme per layer for every
request. Prefill and decode dispatches each hold one scheme.

The engine runs on the card (`device=None` means "cuda" and raises when
CUDA is absent); pass `device="cpu"` to run the plain attention versions on
the CPU. Host-streamed requests, sessions, speculative decoding, sampling
penalties, logprobs, fused rounds, mesh serving, the prefetch LSTM and the
automatic decode horizon are not ported yet: asking for one raises.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from cxl_speckv_tpu_torch.config import KVDtype, SystemConfig
from cxl_speckv_tpu_torch.core.directory import BlockState
from cxl_speckv_tpu_torch.core.stats import Statistics, ratio
from cxl_speckv_tpu_torch.engine.request import Request, RequestState
from cxl_speckv_tpu_torch.engine.sampling import encode_sampling
from cxl_speckv_tpu_torch.engine.scheduler import Scheduler
from cxl_speckv_tpu_torch.models.configs import LlamaConfig
from cxl_speckv_tpu_torch.models.llama import (
    check_supported,
    decode_multi_packed,
    init_params,
    init_params_quantized,
    prefill_batch_packed,
)
from cxl_speckv_tpu_torch.ops.quant import storage_width_class
from cxl_speckv_tpu_torch.ops.wquant import is_quantized, quantize_weights
from cxl_speckv_tpu_torch.prefetcher.controller import PrefetchController
from cxl_speckv_tpu_torch.runtime.kv_cache import TieredKVCache
from cxl_speckv_tpu_torch.utils.tracing import PhaseTimer


@dataclass
class EngineOutput:
    req_id: int
    tokens: list[int]
    finish_reason: str
    ttft_ms: float
    tpot_ms: float
    session_id: int = -1


@dataclass
class EngineStatistics(Statistics):
    steps: int = 0
    requests_finished: int = 0
    tokens_generated: int = 0
    decode_time_s: float = 0.0
    prefill_time_s: float = 0.0
    prefill_dispatches: int = 0  # prefill passes launched
    overhead_time_s: float = 0.0

    def as_dict(self) -> dict:
        d = super().as_dict()
        d["decode_tokens_per_s"] = ratio(self.tokens_generated,
                                         self.decode_time_s)
        return d


def resolve_device(device) -> torch.device:
    """None -> the card. Raises rather than run anywhere else silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _validate_stops(stop_token_ids, stop_sequences):
    ids = [int(t) for t in (stop_token_ids or [])]
    seqs = []
    for s in (stop_sequences or []):
        s = [int(t) for t in s]
        if not s:
            raise ValueError("empty stop sequence")
        seqs.append(s)
    return ids, seqs


def _result_tokens(req: Request) -> list[int]:
    """The request's returned tokens: output minus a matched stop suffix."""
    if req.stop_trim:
        return list(req.output[: len(req.output) - req.stop_trim])
    return list(req.output)


class Engine:
    def __init__(self, model_config: LlamaConfig, system_config: SystemConfig,
                 params=None, *, device=None, seed: int = 0,
                 enable_lstm: bool = False):
        system_config.validate()
        check_supported(model_config)
        ec = system_config.engine
        cc = system_config.cache
        unported = {
            "mesh serving (parallel)": system_config.parallel.num_devices > 1,
            "fused_rounds": ec.fused_rounds,
            "weight_dtype int4": ec.weight_dtype == "int4",
            "the prefetch LSTM (enable_lstm)": enable_lstm,
        }
        bad = [k for k, v in unported.items() if v]
        if bad:
            raise NotImplementedError("not ported yet: " + ", ".join(bad))
        if ec.decode_horizon <= 0:
            raise ValueError(
                "decode_horizon must be >= 1: the automatic horizon is not "
                "ported (it needs a measured dispatch cost on this runtime)")
        lkd = cc.layer_kv_dtypes
        if lkd is not None and len(lkd) != model_config.num_layers:
            raise ValueError(
                f"layer_kv_dtypes has {len(lkd)} entries for a "
                f"{model_config.num_layers}-layer model")
        self.device = resolve_device(device)
        self.model_config = model_config
        self.config = system_config
        # the scheme new requests quantize with (set_kv_dtype), and the
        # per-layer table that replaces it for every request when set
        self._kv_scheme = cc.kv_dtype
        self._layer_schemes = tuple(lkd) if lkd is not None else None
        max_blocks_per_seq = -(-ec.max_seq_len // cc.block_size)
        self.kvc = TieredKVCache(cc, model_config,
                                 max_seqs=ec.max_batch_size * 64,
                                 max_blocks_per_seq=max_blocks_per_seq,
                                 device=self.device)
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            params = (init_params_quantized(model_config, gen, self.device)
                      if ec.weight_dtype == "int8"
                      else init_params(model_config, gen, self.device))
        elif ec.weight_dtype == "int8" and not is_quantized(params):
            params = quantize_weights(params)
        self.params = params
        self.eos_token_id = (ec.eos_token_id if ec.eos_token_id is not None
                             else model_config.eos_token_id)
        self.prefetcher = PrefetchController(
            system_config.prefetch, self.kvc)
        self.scheduler = Scheduler(ec, self.kvc)
        # retirement needs EVERY layer windowed (Gemma-2 global layers
        # keep full KV); Mistral-style uniform windows retire normally
        self.scheduler.window_tokens = model_config.retirement_window
        self.stats = EngineStatistics()
        self.timers = PhaseTimer()
        self._next_req_id = 0
        self._rng_seed = seed + 1
        self._rng_counter = 0
        self._tpots: list[float] = []
        self._ttfts: list[float] = []
        # the JAX engine sends requests that overflow the HBM pool (or
        # max_seq_len) to its host-streamed path when it can; the port
        # refuses exactly those requests
        if ec.stream_enabled and cc.num_host_blocks > 2:
            msl = ec.max_stream_seq_len or (cc.num_host_blocks - 2) * cc.block_size
            self._stream_max_blocks = min(-(-msl // cc.block_size),
                                          cc.num_host_blocks - 2)
        else:
            self._stream_max_blocks = 0

    # -- public API -------------------------------------------------------------

    def add_request(self, prompt: list[int], max_new_tokens: int = 64,
                    temperature: float = 0.0, top_p: float = 1.0,
                    eos_token_id: int | None = None,
                    stop_token_ids: list[int] | None = None,
                    stop_sequences: list[list[int]] | None = None,
                    ignore_eos: bool = False, *, session: bool = False,
                    logprobs: int = 0, prompt_logprobs: bool = False,
                    frequency_penalty: float = 0.0,
                    presence_penalty: float = 0.0,
                    repetition_penalty: float = 0.0) -> int:
        """Submit a request; returns its id. stop_token_ids end generation
        like EOS (reason "stop", token kept); stop_sequences use OpenAI
        stop-string semantics (the matched suffix is excluded from the
        returned tokens)."""
        if not prompt:
            raise ValueError("empty prompt")
        if (session or logprobs or prompt_logprobs or frequency_penalty
                or presence_penalty
                or (repetition_penalty and repetition_penalty != 1.0)):
            raise NotImplementedError(
                "sessions, logprobs and sampling penalties are not ported")
        stop_token_ids, stop_sequences = _validate_stops(
            stop_token_ids, stop_sequences)
        total = len(prompt) + max_new_tokens
        bs = self.config.cache.block_size
        hbm_budget = (self.config.cache.num_hbm_blocks - 2) * bs
        needs_stream = (total > self.config.engine.max_seq_len
                        or total > hbm_budget)
        can_stream = (self._stream_max_blocks > 0
                      and -(-total // bs) <= self._stream_max_blocks)
        if needs_stream and can_stream:
            raise ValueError(
                "request needs the host-streamed path (prompt + "
                "max_new_tokens exceeds max_seq_len or the HBM pool), which "
                "is not ported")
        if total > self.config.engine.max_seq_len:
            raise ValueError("prompt + max_new_tokens exceeds max_seq_len")
        req = Request(req_id=self._next_req_id, prompt=list(prompt),
                      max_new_tokens=max_new_tokens, temperature=temperature,
                      top_p=top_p, eos_token_id=eos_token_id,
                      stop_token_ids=stop_token_ids,
                      stop_sequences=stop_sequences, ignore_eos=ignore_eos,
                      kv_dtype=self._kv_scheme)
        self._next_req_id += 1
        self.scheduler.submit(req)
        return req.req_id

    def generate(self, prompts: list[list[int]], max_new_tokens: int = 64,
                 temperature: float = 0.0, **kw) -> list[list[int]]:
        """Submit, serve to completion, return each prompt's generated
        tokens in submission order."""
        ids = [self.add_request(p, max_new_tokens=max_new_tokens,
                                temperature=temperature, **kw)
               for p in prompts]
        outs = {o.req_id: o.tokens for o in self.run()}
        return [outs.get(i, []) for i in ids]

    def set_prefetch_depth(self, depth: int) -> None:
        """Runtime knob (`speckv_set_prefetch_depth`): the groups ahead that
        the prefetcher plans for, clamped to [min_depth, max_depth]."""
        pf = self.config.prefetch
        self.prefetcher.depth = max(pf.min_depth, min(pf.max_depth, depth))

    def set_kv_dtype(self, kv_dtype) -> None:
        """Runtime compression-scheme knob (`speckv_set_compression_scheme`):
        requests submitted after the call quantize their KV with the new
        scheme; blocks already written keep theirs and decode with their
        own sequence's scheme. Schemes of one storage width switch live
        (INT8 <-> FP8); another width (INT4, BF16) needs an idle engine and
        rebuilds the pools. Refused under a per-layer scheme table."""
        if self._layer_schemes is not None:
            raise ValueError(
                "engine uses a per-layer scheme table (layer_kv_dtypes); "
                "the runtime scheme knob applies to uniform-scheme engines")
        kv_dtype = KVDtype(kv_dtype)
        base = self.config.cache.kv_dtype
        if storage_width_class(kv_dtype) != storage_width_class(base):
            busy = self.scheduler.num_waiting + self.scheduler.num_running
            if busy:
                raise ValueError(
                    f"cross-width scheme switch {base.value} -> "
                    f"{kv_dtype.value} requires an idle engine (live: "
                    f"{busy} requests)")
            self.kvc.rebuild_storage(kv_dtype)
        self._kv_scheme = kv_dtype

    def _req_scheme(self, req: Request):
        """The scheme a request's KV is written and read with: the per-layer
        table, else the scheme it was submitted under."""
        if self._layer_schemes is not None:
            return self._layer_schemes
        return req.kv_dtype

    @property
    def has_work(self) -> bool:
        return self.scheduler.num_waiting > 0 or self.scheduler.num_running > 0

    def run(self, max_steps: int = 100000) -> list[EngineOutput]:
        outs = []
        for _ in range(max_steps):
            if not self.has_work:
                break
            outs.extend(self.step())
        return outs

    def _make_capacity(self) -> bool:
        """Free capacity under pressure: preempt the youngest request."""
        return self.scheduler.preempt_youngest() is not None

    # -- one engine iteration -----------------------------------------------------

    def step(self) -> list[EngineOutput]:
        self.scheduler.tick()
        self.stats.steps += 1
        finished: list[EngineOutput] = []
        ec = self.config.engine
        self.scheduler.admit(max_new=max(ec.max_batch_size, ec.prefill_lanes))
        # requests that can never fit fail cleanly at admission
        for req in self.scheduler.rejected:
            finished.append(self._finish_request(req, "oom"))
        self.scheduler.rejected.clear()
        t0 = time.monotonic()
        with self.timers.phase("prefill"):
            self._prefill_tick_batched(finished)
        t1 = time.monotonic()
        with self.timers.phase("decode"):
            batch = self._decode_tick(finished)
        t2 = time.monotonic()
        self._retire_window_blocks()
        with self.timers.phase("maintain"):
            # protect the current batch's and upcoming groups' blocks from
            # proactive eviction; plan prefetches for the upcoming groups
            exclude = {r.req_id for r in batch}
            upcoming = self.scheduler.upcoming_groups(
                self.config.prefetch.max_depth, exclude)
            live = set(self.kvc.pool.live_seqs())
            protected: set[int] = set()
            for r in batch:
                if r.seq_slot in live:
                    protected.update(self.kvc.pool.seq(r.seq_slot).live_blocks)
            for g in upcoming[: self.prefetcher.depth]:
                for s in g:
                    if s in live:
                        protected.update(self.kvc.pool.seq(s).live_blocks)
            self.kvc.protected = protected
            with self.timers.phase("maintain.plan"):
                self.prefetcher.plan(upcoming)
                self.prefetcher.update_depth()
            with self.timers.phase("maintain.kvc"):
                self.kvc.maintain()
        t3 = time.monotonic()
        self.stats.prefill_time_s += t1 - t0
        self.stats.decode_time_s += t2 - t1
        self.stats.overhead_time_s += t3 - t2
        return finished

    # -- prefill ------------------------------------------------------------------

    def _prefill_tick_batched(self, finished: list[EngineOutput]) -> None:
        """One pass prefills a chunk for up to max_batch_size requests
        (causal within each chunk + that lane's quantized pool context),
        with each lane's next token sampled on the device."""
        chunk = self.config.engine.prefill_chunk
        B = (self.config.engine.prefill_lanes
             or self.config.engine.max_batch_size)
        bs = self.config.cache.block_size
        # the held decode group's blocks are a protected residency class:
        # the prefill wave sizes itself to the HBM they do not occupy
        live = set(self.kvc.pool.live_seqs())
        hot: set[int] = set()
        for s in self.scheduler.held_batch_slots():
            if s in live:
                hot.update(self.kvc.pool.seq(s).live_blocks)
        self.kvc.decode_hot = hot
        hot_resident = sum(
            1 for b in hot
            if self.kvc.directory.entry(b).state != BlockState.HOST)
        budget = self.config.cache.num_hbm_blocks - 2 - hot_resident
        ready: list[tuple] = []  # (req, n, start)
        for req in self.scheduler.prefill_candidates():
            if len(ready) >= B:
                break
            if req.seq_slot < 0 or req.state != RequestState.PREFILLING:
                continue
            # prefix-cache claim on first touch: reuse cached full prompt
            # blocks and start prefill past them
            if req.prefill_pos == 0 and req.context_len == 0:
                matched, bids = self.kvc.match_prefix(
                    req.prompt, self._req_scheme(req))
                if matched:
                    self.kvc.claim_prefix(req.seq_slot, bids)
                    req.prefill_pos = matched
            pos0 = req.prefill_pos
            n = min(chunk, len(req.prompt) - pos0)
            start = req.context_len + pos0
            if -(-(start + n) // bs) > self.config.cache.num_hbm_blocks - 2:
                finished.append(self._finish_request(req, "oom"))
                req.state = RequestState.FAILED
                continue
            # the wave's combined working set must fit beside the decode
            # class (the first lane is exempt so prefill always progresses)
            need = -(-(start + n) // bs)
            ws = sum(-(-(s0 + n0) // bs) for _, n0, s0 in ready)
            if ready and ws + need > budget:
                continue
            if not self.kvc.extend_seq(req.seq_slot, start + n):
                if not self._make_capacity():
                    finished.append(self._finish_request(req, "oom"))
                    req.state = RequestState.FAILED
                continue
            self.kvc.pin_seq(req.seq_slot, True)
            ready.append((req, n, start))
        if not ready:
            return
        self.kvc.ensure_resident([r.seq_slot for r, _, _ in ready])
        # one dispatch per KV scheme (normally one)
        groups: dict = {}
        for item in ready:
            groups.setdefault(self._req_scheme(item[0]), []).append(item)
        for scheme, group in groups.items():
            self._prefill_dispatch(scheme, group, finished)

    def _prefill_dispatch(self, scheme, ready: list[tuple],
                          finished: list[EngineOutput]) -> None:
        """One prefill pass over `ready` [(req, n, start)], all of `scheme`."""
        chunk = self.config.engine.prefill_chunk
        B = (self.config.engine.prefill_lanes
             or self.config.engine.max_batch_size)
        bs = self.config.cache.block_size
        mb = self.kvc.pool.table.max_blocks_per_seq
        self.stats.prefill_dispatches += 1
        self._rng_counter += 1
        packed = np.zeros((B, 4 + mb + chunk), np.int32)
        packed[:, 4:4 + mb] = self.kvc.guard_slot
        packed[:, 3] = self._rng_counter
        for i, (req, n, start) in enumerate(ready):
            pos0 = start - req.context_len
            packed[i, 0] = start
            packed[i, 1] = n
            packed[i, 2] = encode_sampling(req.temperature, req.top_p)
            row = self.kvc.pool.table.row(req.seq_slot)
            packed[i, 4:4 + mb] = np.where(row >= 0, row, self.kvc.guard_slot)
            packed[i, 4 + mb:4 + mb + n] = req.prompt[pos0:pos0 + n]
        toks = prefill_batch_packed(
            self.params, self.model_config, scheme, packed, self.kvc.pools,
            max_blocks=mb, rng_seed=self._rng_seed).cpu().numpy()

        for i, (req, n, start) in enumerate(ready):
            blocks = self.kvc.pool.seq(req.seq_slot).blocks
            for bi in range(start // bs, (start + n - 1) // bs + 1):
                if blocks[bi] is not None:
                    self.kvc.directory.mark_dirty(blocks[bi])
            self.kvc.pin_seq(req.seq_slot, False)
            req.prefill_pos = start - req.context_len + n
            if req.context_len == 0:
                self.kvc.register_prefix(req.seq_slot, req.prompt,
                                         req.prefill_pos, scheme)
            self.scheduler.stats.prefill_chunks += 1
            if req.done_prefill:
                self._record_token(req, int(toks[i]), first=True)
                req.state = RequestState.RUNNING
                out = self._maybe_finish(req)
                if out is not None:
                    finished.append(out)

    # -- decode -------------------------------------------------------------------

    def _decode_tick(self, finished: list[EngineOutput]) -> list[Request]:
        """Decode the scheduled group: `decode_horizon` tokens per lane in
        one fused pass (horizon 1 is the single-step case of the same
        pass: `decode_multi` of one step is `decode_step` then sampling)."""
        batch = self.scheduler.decode_batch()
        if not batch:
            return batch
        return self._multi_decode_tick(batch, finished)

    def _multi_decode_tick(self, batch: list[Request],
                           finished: list[EngineOutput]) -> list[Request]:
        """Fused multi-token decode: `decode_horizon` tokens in one pass per
        KV scheme of the batch (normally one)."""
        h = self.config.engine.decode_horizon
        B = self.config.engine.max_batch_size
        bs = self.config.cache.block_size
        max_tokens = self.kvc.pool.table.max_blocks_per_seq * bs
        # decode.host = residency / extend / pack / bookkeeping on the host;
        # decode.program = the model pass through the token fetch
        t_host0 = time.monotonic()
        slots = [r.seq_slot for r in batch]
        for s in slots:
            self.kvc.pin_seq(s, True)
        for s in slots:
            self.kvc.touch_seq(s)
        self.kvc.ensure_resident(slots)
        for r in batch:
            want = min(r.num_tokens + h - 1, max_tokens)
            while r.seq_slot >= 0 and not self.kvc.extend_seq(r.seq_slot, want):
                if not self._make_capacity():
                    raise RuntimeError(
                        "KV capacity exhausted with nothing to preempt")
            if r.seq_slot >= 0:
                # blocks born in this extend must not be evictable while the
                # NEXT member's extend makes room
                self.kvc.pin_seq(r.seq_slot, True)
        batch = [r for r in batch if r.seq_slot >= 0]
        if not batch:
            return batch
        t_host = time.monotonic() - t_host0

        guard = self.kvc.guard_slot
        mb = self.kvc.pool.table.max_blocks_per_seq
        t_prog = 0.0
        groups: dict = {}
        for r in batch:
            groups.setdefault(self._req_scheme(r), []).append(r)
        for scheme, group in groups.items():
            t0 = time.monotonic()
            packed = np.full((B, mb + 4), guard, np.int32)
            packed[:, :4] = 0
            self._rng_counter += 1
            packed[:, 3] = self._rng_counter
            for i, r in enumerate(group):
                packed[i, 0] = r.output[-1]
                packed[i, 1] = r.num_tokens - 1
                packed[i, 2] = encode_sampling(r.temperature, r.top_p)
                row = self.kvc.pool.table.row(r.seq_slot)
                packed[i, 4:4 + mb] = np.where(row >= 0, row, guard)
            t_host += time.monotonic() - t0
            t0 = time.monotonic()
            toks = decode_multi_packed(
                self.params, self.model_config, scheme, packed,
                self.kvc.pools, horizon=h,
                rng_seed=self._rng_seed).cpu().numpy()
            t_prog += time.monotonic() - t0
            t0 = time.monotonic()
            for i, r in enumerate(group):
                blocks = self.kvc.pool.seq(r.seq_slot).blocks
                pos0 = int(packed[i, 1])
                lo, hi = pos0 // bs, min((pos0 + h - 1) // bs, len(blocks) - 1)
                for bi in range(lo, hi + 1):
                    if blocks[bi] is not None:
                        self.kvc.directory.mark_dirty(blocks[bi])
                for j in range(h):
                    if r.state != RequestState.RUNNING:
                        break
                    self._record_token(r, int(toks[i, j]))
                    out = self._maybe_finish(r)
                    if out is not None:
                        finished.append(out)
            self.scheduler.stats.decode_batches += 1
            t_host += time.monotonic() - t0
        for r in batch:
            if r.state == RequestState.RUNNING:
                self.kvc.pin_seq(r.seq_slot, False)
        self.timers.record("decode.host", t_host)
        self.timers.record("decode.program", t_prog)
        self.scheduler.stats.decode_tokens += sum(
            min(h, len(r.output)) for r in batch)
        return batch

    def _retire_window_blocks(self) -> None:
        """Sliding-window KV retirement (Mistral family): free the blocks
        every running sequence's window has moved past. The attention
        kernels never read blocks below (seq_len - window) // block_size, so
        live KV per sequence stays about one window, however long the
        generation runs."""
        window = self.model_config.retirement_window
        if window is None:
            return
        bs = self.config.cache.block_size
        live = set(self.kvc.pool.live_seqs())
        for r in self.scheduler.running.values():
            if r.seq_slot in live and r.num_tokens > window:
                first = (r.num_tokens - window) // bs
                if first > 0:
                    self.kvc.retire_out_of_window(r.seq_slot, first)

    # -- bookkeeping ----------------------------------------------------------------

    def _record_token(self, req: Request, tok: int, first: bool = False) -> None:
        now = time.monotonic()
        if first or not req.first_token_time:
            req.first_token_time = now
        req.token_times.append(now)
        req.output.append(tok)
        self.stats.tokens_generated += 1

    def _check_stop(self, req: Request) -> str:
        """Finish reason for the request's current output ('' = go on).
        A matched stop sequence sets req.stop_trim."""
        if not req.output:
            return ""
        eos = req.eos_token_id if req.eos_token_id is not None else self.eos_token_id
        last = req.output[-1]
        if last == eos and not req.ignore_eos:
            return "eos"
        if req.stop_token_ids and last in req.stop_token_ids:
            return "stop"
        for s in req.stop_sequences:
            if len(s) <= len(req.output) and req.output[-len(s):] == list(s):
                req.stop_trim = len(s)
                return "stop"
        if len(req.output) >= req.max_new_tokens:
            return "length"
        return ""

    def _maybe_finish(self, req: Request) -> EngineOutput | None:
        reason = self._check_stop(req)
        if not reason:
            return None
        return self._finish_request(req, reason)

    def _finish_request(self, req: Request, reason: str) -> EngineOutput:
        req.finish_time = time.monotonic()
        self.scheduler.finish(req, reason)
        self.stats.requests_finished += 1
        if req.tpot_ms > 0:
            self._tpots.append(req.tpot_ms)
        if req.ttft_ms > 0:
            self._ttfts.append(req.ttft_ms)
        return EngineOutput(req.req_id, _result_tokens(req), reason,
                            req.ttft_ms, req.tpot_ms, req.session_id)

    # -- statistics -------------------------------------------------------------------

    def get_statistics(self) -> dict:
        eng = self.stats.as_dict()
        tp = sorted(self._tpots)
        eng["p50_tpot_ms"] = tp[len(tp) // 2] if tp else 0.0
        eng["p95_tpot_ms"] = tp[min(len(tp) - 1, int(len(tp) * 0.95))] if tp else 0.0
        tf = sorted(self._ttfts)
        eng["p50_ttft_ms"] = tf[len(tf) // 2] if tf else 0.0
        eng["p95_ttft_ms"] = tf[min(len(tf) - 1, int(len(tf) * 0.95))] if tf else 0.0
        # tokens live per scheme; a per-layer table counts as "mixed8" (the
        # JAX engine raises on it there)
        scheme_tokens: dict[str, int] = {}
        for r in self.scheduler.running.values():
            scheme = self._req_scheme(r)
            k = (KVDtype.MIXED8 if isinstance(scheme, tuple) else scheme).value
            scheme_tokens[k] = scheme_tokens.get(k, 0) + r.num_tokens
        return {
            "engine": eng,
            "kv_scheme_current": self._kv_scheme.value,
            "kv_scheme_live_tokens": scheme_tokens,
            "phases": self.timers.summary(),
            "scheduler": self.scheduler.get_statistics().as_dict(),
            "prefetch": self.prefetcher.get_statistics().as_dict(),
            "prefetch_depth": self.prefetcher.depth,
            **self.kvc.get_statistics(),
        }

    def reset_statistics(self) -> None:
        self.stats.reset()
        self.scheduler.reset_statistics()
        self.prefetcher.reset_statistics()
        self.kvc.reset_statistics()
