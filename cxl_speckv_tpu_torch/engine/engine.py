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
   (`models.llama.decode_multi_packed`), or with speculative decoding one
   round: propose gamma tokens (`draft_config`: a draft model through K1;
   `spec_ngram`: prompt lookup on the host), then verify all gamma + 1
   positions through K2 and accept on the device (`engine/spec.py`);
3. retire finished requests, and the KV blocks that every running
   sequence's sliding window has left (Mistral-style uniform windows);
4. prefetch plan for upcoming groups (gated and ranked by the prefetch
   LSTM when it is on: `prefetcher/`), its online training, eviction,
   migration.

Multi-turn sessions (`add_request(session=True)`, `continue_session`,
`end_session`) keep a conversation's KV in the pool between turns, where
eviction may demote it to the host tier while it is idle; the next turn
restores it (the tiering machinery promotes it) and prefills only the new
tokens. Under capacity pressure an idle session's KV is reclaimed, and its
next turn re-prefills the stored history. `cancel` withdraws or ends a
request at any point. Requests may ask for per-token logprobs (`logprobs=k`,
also under speculative decoding), prompt logprobs (`prompt_logprobs=True`)
and sampling penalties (frequency / presence / repetition, through the
device plane of `engine/sampling.py`).

A request longer than `max_seq_len` or the HBM pool takes the host-streamed
path (`EngineConfig.stream_enabled`, on by default): its KV lives entirely
in the host tier, allocated at admission, and each step's `stream` phase
advances every streamed lane by a prefill chunk or decode tokens
(`models.llama.stream_step_batched`, or `stream_decode_multi_batched`:
`decode_horizon` steps over a context staged once, when the live lanes'
slabs fit four times `stream_stage_mb`), attending over the host tier wave
by wave (`ops/stream_attention.py`); K1 and K2 never run for such a lane.
A session whose KV is streamed stays stream-resident between turns
(`Session.stream_bids`).

Every request keeps the KV scheme it was submitted under: `set_kv_dtype`
(the `speckv_set_compression_scheme` analog) changes it for new requests,
live between INT8 and FP8, which share the pool's bytes, and on an idle
engine across storage widths (INT4, BF16; `TieredKVCache.rebuild_storage`).
`CacheConfig.layer_kv_dtypes` instead fixes a scheme per layer for every
request. Prefill and decode dispatches each hold one scheme.

The prefetch LSTM (`enable_lstm`, by default `PrefetchConfig.enabled`)
lives on the host CPU, as the reference's does. Each fused decode round
also computes its lanes' continue probabilities on the engine's device
(`PrefetchConfig.ingraph_pcont`), from a copy of the predictor's weights
refreshed at most every 16 rounds, and they come home in the round's one
copy. With `seed_ngram` the LSTM also seeds the n-gram proposer's misses.
`decode_horizon` 0 (the default) derives the horizon from a measured
dispatch cost and the weights' bytes (`utils/dispatch.py`) and writes it
back into the config.

Block migrations run on the card's copy stream (`runtime/kv_cache.py`):
a round waits on the device for the promotes it reads, demotes overlap
it, and the host blocks only when it needs an HBM slot that a demote is
still reading. With `EngineConfig.fused_rounds` (the JAX engine's rule:
no speculative decoding, a host tier) the queued batch instead rides the
next prefill or multi-step decode round on the round's own stream
(`models.llama.prefill_round_fused` / `decode_round_fused`), and a round
without one runs the plain path.

The engine runs on the card (`device=None` means "cuda" and raises when
CUDA is absent); pass `device="cpu"` to run the plain attention versions on
the CPU.

On the card without a mesh, each multi-step decode round is one dispatch:
the engine owns a `models.round_graph.RoundGraphs` (`round_graphs`), which
runs a round key's first round eagerly, captures it in a CUDA graph at its
second and replays it from then on, as the reference jits the round. The
CPU has no graphs and a mesh rank's collectives run on the host: their
rounds stay eager, as do prefill, verify and the streamed path.
`get_statistics()["engine"]` names the route (`round_route`) and counts
`graph_rounds`, `eager_rounds`, `graph_captures`, `graph_capture_ms`,
`graphs_held` and `graph_pool_bytes`.

Mesh serving (`SystemConfig.parallel`, dp x ep x tp > 1): one engine a rank
of an initialized `torch.distributed` world (`parallel/distributed.py`),
every rank fed the same commands (`parallel/lockstep.py`). Every rank runs
the whole engine's bookkeeping over all lanes (scheduler, tables,
directory, prefetcher, requests), so its decisions and req_ids are those of
every other rank, and the ranks share the model's work
(`parallel/sharding.py`): tp splits the weights, the KV heads of the pools
and host store and the vocabulary; ep splits MoE experts; dp splits the
lanes of every batch whose width it divides. Each pass returns the whole
batch's results on every rank (`models/llama.py`), and the dp replicas of
the pools stay bitwise equal (`parallel/shard_kernels.exchange_rows`). K1
and K2 run on each rank's shard. A draft model shards with the target when
its axes divide tp, else every rank serves it whole. Polls and flushes of
the migrations wait under a mesh (`TieredKVCache(lockstep=True)`), the
prefetch predictor keeps its host path (no in-round leg, as the JAX engine)
and trains synchronously, and the derived `decode_horizon` is rank 0's.

`EngineConfig.weight_dtype` "int8" serves W8A16 and "int4" W4A16 weights
(`ops/wquant.py`; each quantized matmul is one launch of the fused int8
matmul of `ops/w8a16_mm.py` or the fused int4 one of `ops/w4a16_mm.py`,
which read the stored weight once); a tree passed
already quantized serves as it is. `CacheConfig.host_store_backend=
"numpy"` keeps the host tier in pageable host memory
(`runtime/transfer.py:TransferEngine`), and
`TieredKVCache(native=True)` or `SPECKV_NATIVE=1` runs the C++ residency
directory (`cxl_speckv_tpu_torch/native`).
`score_prompts` scores whole prompts offline (`engine/scoring.py`).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from cxl_speckv_tpu_torch.config import KVDtype, SystemConfig
from cxl_speckv_tpu_torch.core.directory import BlockState
from cxl_speckv_tpu_torch.core.stats import Statistics, ratio
from cxl_speckv_tpu_torch.engine.request import Request, RequestState
from cxl_speckv_tpu_torch.engine import scoring
from cxl_speckv_tpu_torch.engine.sampling import encode_pen_info, encode_sampling
from cxl_speckv_tpu_torch.engine.scheduler import Scheduler
from cxl_speckv_tpu_torch.engine.spec import NgramProposer, SpecDecoder
from cxl_speckv_tpu_torch.models.configs import LlamaConfig
from cxl_speckv_tpu_torch.models.llama import (
    check_supported,
    decode_multi_packed,
    decode_round_fused,
    init_params,
    init_params_quantized,
    prefill_batch_packed,
    prefill_round_fused,
    seeded_generator,
    stream_decode_multi_batched,
    stream_decode_nblk,
    stream_step_batched,
)
from cxl_speckv_tpu_torch.models.round_graph import RoundGraphs
from cxl_speckv_tpu_torch.ops.quant import storage_width_class
from cxl_speckv_tpu_torch.ops.wquant import is_quantized, quantize_weights
from cxl_speckv_tpu_torch.parallel.mesh import Mesh
from cxl_speckv_tpu_torch.parallel.sharding import (
    shard_params,
    tp_compatible,
    validate_tp,
)
from cxl_speckv_tpu_torch.prefetcher.controller import PrefetchController
from cxl_speckv_tpu_torch.prefetcher.lstm import LSTMPredictor, tree_to
from cxl_speckv_tpu_torch.runtime.kv_cache import TieredKVCache
from cxl_speckv_tpu_torch.utils.dispatch import (
    derive_decode_horizon,
    params_byte_size,
)
from cxl_speckv_tpu_torch.utils.host import fetch
from cxl_speckv_tpu_torch.utils.tracing import PhaseTimer


@dataclass
class EngineOutput:
    req_id: int
    tokens: list[int]
    finish_reason: str
    ttft_ms: float
    tpot_ms: float
    session_id: int = -1
    # per-token logprob records (aligned with `tokens`) when the request
    # asked for them (`logprobs=k`); None otherwise
    logprobs: list[dict] | None = None
    # echo scoring (`prompt_logprobs=True`): log p(prompt[i] | prompt[:i])
    # per prompt token, entry 0 is None (OpenAI echo); None when off
    prompt_logprobs: list | None = None


@dataclass
class Session:
    """A multi-turn conversation whose KV persists between requests: it
    stays in the pool between turns (demotable to the host tier) and is
    restored, not recomputed, when the conversation returns. `live=False`
    means the KV was reclaimed under capacity pressure, and the next turn
    re-prefills the stored history. Counterpart of the JAX engine's
    `Session`."""

    session_id: int
    seq_slot: int
    tokens: list[int] = field(default_factory=list)  # the whole conversation
    live: bool = True
    busy: bool = False
    last_use: float = field(default_factory=time.monotonic)
    restores: int = 0
    reprefills: int = 0
    kv_dtype: object = None   # the scheme the live KV is encoded with
    # a host-STREAMED session: its KV is these host-tier stream blocks, in
    # sequence order (seq_slot stays -1); the next turn re-enters the
    # streamed path appending to them
    stream_bids: list | None = None


@dataclass
class StreamState:
    """A host-streamed request: its KV lives entirely in the host tier and
    every step streams the context through the device."""

    req: Request
    bids: list[int]          # host-tier blocks, in sequence order
    host_slots: np.ndarray   # their store slots


@dataclass
class EngineStatistics(Statistics):
    steps: int = 0
    requests_finished: int = 0
    tokens_generated: int = 0
    decode_time_s: float = 0.0
    prefill_time_s: float = 0.0
    prefill_dispatches: int = 0  # prefill passes launched
    overhead_time_s: float = 0.0
    stream_time_s: float = 0.0
    stream_chunks: int = 0       # streamed prefill chunks dispatched
    stream_tokens: int = 0       # tokens generated by streamed sequences

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


def _result_logprobs(req: Request) -> list[dict] | None:
    """Per-token logprob records aligned with `_result_tokens`."""
    if not req.logprobs:
        return None
    return list(req.logprobs_data[:len(req.output) - req.stop_trim])


def _result_prompt_logprobs(req: Request) -> list | None:
    """Echo scores: [None] + log p(prompt[i] | prefix) for i >= 1."""
    if not req.prompt_logprobs:
        return None
    return [None] + list(req.prompt_logprobs_data)


def _logprob_record(ch, ids, vals, k: int) -> dict:
    """One token's logprob record: its raw logprob and the top k."""
    return {"logprob": float(ch), "top_ids": ids[:k].tolist(),
            "top_logprobs": vals[:k].tolist()}


class Engine:
    # one top-k width for every dispatch that carries logprobs (the API
    # maximum, as the JAX engine compiles one program for it); each request
    # slices its own k on the host
    LOGPROBS_COMPILE_K = 20

    def __init__(self, model_config: LlamaConfig, system_config: SystemConfig,
                 params=None, *, device=None, seed: int = 0,
                 enable_lstm: bool | None = None,
                 draft_config: LlamaConfig | None = None, draft_params=None,
                 spec_gamma: int = 4, spec_ngram: bool = False,
                 spec_ngram_max_match: int = 3, spec_draft_kv: str = "bf16"):
        """`draft_config` (+ `draft_params`, the port's tree; None draws a
        seeded draft) or `spec_ngram` turn on speculative decoding with
        `spec_gamma` proposals a round; the draft's KV cache uses
        `spec_draft_kv`. `enable_lstm` None follows
        `PrefetchConfig.enabled`."""
        system_config.validate()
        check_supported(model_config)
        ec = system_config.engine
        cc = system_config.cache
        self.mesh = self._build_mesh(model_config, system_config)
        lkd = cc.layer_kv_dtypes
        if lkd is not None and len(lkd) != model_config.num_layers:
            raise ValueError(
                f"layer_kv_dtypes has {len(lkd)} entries for a "
                f"{model_config.num_layers}-layer model")
        self.device = resolve_device(device)
        # the decode rounds' CUDA graphs (None: eager rounds, on the CPU and
        # on a mesh rank, whose gloo collectives run on the host)
        on_card = self.device.type == "cuda" and self.mesh is None
        self.round_graphs = RoundGraphs(self.device) if on_card else None
        self._eager_rounds = 0
        self.model_config = model_config
        self.config = system_config
        # the scheme new requests quantize with (set_kv_dtype), and the
        # per-layer table that replaces it for every request when set
        self._kv_scheme = cc.kv_dtype
        self._layer_schemes = tuple(lkd) if lkd is not None else None
        max_blocks_per_seq = -(-ec.max_seq_len // cc.block_size)
        tp = system_config.parallel.tp
        self.kvc = TieredKVCache(cc, model_config,
                                 max_seqs=ec.max_batch_size * 64,
                                 max_blocks_per_seq=max_blocks_per_seq,
                                 device=self.device,
                                 kv_heads=model_config.num_kv_heads // tp,
                                 lockstep=self.mesh is not None)
        # W8A16 / W4A16: a tree that is not quantized yet quantizes at the
        # width `weight_dtype` asks for; a quantized one serves as it is
        # (the JAX engine's rule)
        wq_bits = {"int8": 8, "int4": 4}.get(ec.weight_dtype)
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            params = (init_params_quantized(model_config, gen, self.device,
                                            bits=wq_bits)
                      if wq_bits else
                      init_params(model_config, gen, self.device))
        elif wq_bits and not is_quantized(params):
            params = quantize_weights(params, bits=wq_bits)
        self.params = (shard_params(params, model_config, self.mesh)
                       if self.mesh is not None else params)
        if ec.decode_horizon <= 0:
            # written back, so that every reader of the config sees one
            # number (utils/dispatch.py); from the whole model's bytes, and
            # rank 0's on a mesh, whose ranks must schedule alike
            h = derive_decode_horizon(params_byte_size(params),
                                      device=self.device)
            ec.decode_horizon = (self.mesh.agree(h) if self.mesh is not None
                                 else h)
        del params
        self.eos_token_id = (ec.eos_token_id if ec.eos_token_id is not None
                             else model_config.eos_token_id)
        pf = system_config.prefetch
        if enable_lstm is None:
            enable_lstm = pf.enabled
        predictor = None
        if enable_lstm:
            predictor = LSTMPredictor(
                model_config.vocab_size, embed_dim=pf.embed_dim,
                hidden=pf.lstm_hidden, num_layers=pf.lstm_layers,
                history_len=pf.history_len, seed=seed,
                vocab_buckets=pf.vocab_buckets)
            if pf.predictor_path:
                predictor.load(pf.predictor_path)
        self.prefetcher = PrefetchController(
            pf, self.kvc, predictor=predictor,
            eos_token_id=self.eos_token_id, seed=seed)
        self.prefetcher.warmup()
        # the in-round leg's copy of the predictor's weights on this device,
        # the published tree it was made from, and the step it was made at
        self._lstm_dev = None
        self._lstm_src = None
        self._lstm_refresh_step = 0
        self.scheduler = Scheduler(ec, self.kvc)
        # retirement needs EVERY layer windowed (Gemma-2 global layers
        # keep full KV); Mistral-style uniform windows retire normally
        self.scheduler.window_tokens = model_config.retirement_window
        self.spec = None
        if spec_ngram:
            if draft_config is not None:
                raise ValueError("spec_ngram and draft_config are mutually "
                                 "exclusive proposal sources")
            self.spec = NgramProposer(self.kvc, model_config.vocab_size,
                                      gamma=spec_gamma,
                                      max_match=spec_ngram_max_match)
        elif draft_config is not None:
            check_supported(draft_config)
            if draft_params is None:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(seed + 2)
                draft_params = (
                    init_params_quantized(draft_config, gen, self.device,
                                          bits=wq_bits)
                    if wq_bits else
                    init_params(draft_config, gen, self.device))
            elif wq_bits and not is_quantized(draft_params):
                draft_params = quantize_weights(draft_params, bits=wq_bits)
            draft_heads = draft_config.num_kv_heads
            if self.mesh is not None and tp_compatible(draft_config, tp):
                # sharded with the target; otherwise served whole on every
                # rank (a tiny draft with few heads)
                draft_params = shard_params(draft_params, draft_config,
                                            self.mesh)
                draft_heads //= tp
            self.spec = SpecDecoder(
                draft_config, draft_params, self.kvc, gamma=spec_gamma,
                draft_kv_dtype=KVDtype(spec_draft_kv), kv_heads=draft_heads,
                graphs=(RoundGraphs(self.device)
                        if self.round_graphs is not None else None))
        if self.spec is not None:
            self.scheduler.free_seq_hook = self.spec.on_free_seq
        # fused rounds (EngineConfig.fused_rounds): the queued migration
        # batch rides the next prefill / multi-step decode round; the spec
        # path and single-step decode keep standalone batches, an HBM-only
        # engine has nothing to migrate, and the numpy host-store backend
        # migrates through its own transfer engine (the JAX engine's rule)
        self._fused_rounds = (ec.fused_rounds and self.kvc.device_mode
                              and self.spec is None
                              and cc.num_host_blocks > 0)
        self.kvc.defer_migrations = self._fused_rounds
        self.stats = EngineStatistics()
        self.timers = PhaseTimer()
        self._next_req_id = 0
        self._rng_seed = seed + 1
        self._rng_counter = 0
        self._tpots: list[float] = []
        self._ttfts: list[float] = []
        self._requests: dict[int, Request] = {}
        self._sessions: dict[int, Session] = {}
        self.scheduler.reclaim_hook = self._reclaim_idle_session
        # blocks committed outside the running set: idle session KV and the
        # host-streamed sequences
        self.scheduler.extra_committed = self._extra_committed_blocks
        # a demand fetch that cannot make HBM room reclaims idle sessions
        # too (the JAX engine raises there when the host tier is full of
        # idle session KV; `tests/test_torch_sessions.py`)
        self.kvc.reclaim_hook = self._reclaim_idle_session
        # sampling penalties: one row per penalized request of a device
        # plane int32 [penalty_rows + 1, vocab] (`engine/sampling.py`),
        # allocated at the first penalized request; from then on every
        # decode and prefill dispatch carries it (unpenalized lanes ride the
        # guard row bit-identically)
        self._pen_counts: torch.Tensor | None = None
        self._pen_free = list(range(ec.penalty_rows))
        self._pen_guard = ec.penalty_rows
        # host-streamed requests (KV larger than the HBM pool): queued until
        # their host blocks are allocated, then advanced every step; the
        # streamed path reads the device backend's store, so the numpy
        # backend streams nothing (the JAX engine's rule)
        if (self.kvc.device_mode and ec.stream_enabled
                and cc.num_host_blocks > 2):
            msl = ec.max_stream_seq_len or (cc.num_host_blocks - 2) * cc.block_size
            self._stream_max_blocks = min(-(-msl // cc.block_size),
                                          cc.num_host_blocks - 2)
        else:
            self._stream_max_blocks = 0
        self._stream_queue: deque[Request] = deque()
        self._streams: dict[int, StreamState] = {}

    @staticmethod
    def _build_mesh(model_config: LlamaConfig, system_config: SystemConfig):
        """The mesh of `system_config.parallel` over the initialized world,
        or None for one device. Checks the JAX engine's divisibility rules
        and what lockstep scheduling needs."""
        pc = system_config.parallel
        if pc.num_devices == 1:
            return None
        ec = system_config.engine
        validate_tp(model_config, pc.tp, ep=pc.ep)
        if ec.max_batch_size % pc.dp:
            raise ValueError("max_batch_size must be divisible by dp")
        if ec.prefill_lanes and ec.prefill_lanes % pc.dp:
            raise ValueError("prefill_lanes must be divisible by dp")
        pf = system_config.prefetch
        if pf.train_online and pf.train_async:
            raise ValueError(
                "mesh serving needs PrefetchConfig(train_async=False): every "
                "rank must apply the predictor's updates at the same step")
        if not torch.distributed.is_initialized():
            raise RuntimeError(
                f"a dp*ep*tp = {pc.num_devices} mesh serves one engine a "
                "rank of an initialized torch.distributed world "
                "(cxl_speckv_tpu_torch.parallel.distributed)")
        return Mesh(dp=pc.dp, ep=pc.ep, tp=pc.tp)

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
        """Submit a request; returns its id. With session=True the
        conversation's KV persists after the reply (demotable to the host
        tier): follow it with `continue_session(req_id, ...)`. A request
        past max_seq_len or the HBM pool is host-streamed when the host
        tier can hold it.
        stop_token_ids end generation like EOS (reason "stop", token kept);
        stop_sequences use OpenAI stop-string semantics (the matched suffix
        is excluded from the returned tokens). `logprobs=k` (k <= 20)
        returns each token's raw logprob and the top k; `prompt_logprobs`
        scores every prompt token. frequency / presence penalties use OpenAI
        semantics (output tokens only), repetition_penalty HF / vLLM
        semantics (prompt + output; 1.0 = off)."""
        if not prompt:
            raise ValueError("empty prompt")
        stop_token_ids, stop_sequences = _validate_stops(
            stop_token_ids, stop_sequences)
        self._validate_logprobs(logprobs)
        fp, pp, rp = self._validate_penalties(
            frequency_penalty, presence_penalty, repetition_penalty)
        if prompt_logprobs and self.config.engine.prefill_chunk < 2:
            raise ValueError("prompt_logprobs needs prefill_chunk >= 2 "
                             "(chunks re-feed one boundary token)")
        total = len(prompt) + max_new_tokens
        bs = self.config.cache.block_size
        hbm_budget = (self.config.cache.num_hbm_blocks - 2) * bs
        needs_stream = (total > self.config.engine.max_seq_len
                        or total > hbm_budget)
        can_stream = (self._stream_max_blocks > 0
                      and -(-total // bs) <= self._stream_max_blocks)
        if total > self.config.engine.max_seq_len and not (
                needs_stream and can_stream):
            raise ValueError(
                "prompt + max_new_tokens exceeds max_seq_len"
                + (" and the host-streamed capacity" if self._stream_max_blocks
                   else " (host streaming is off: stream_enabled, or "
                   "num_host_blocks <= 2)"))
        req = Request(req_id=self._next_req_id, prompt=list(prompt),
                      max_new_tokens=max_new_tokens, temperature=temperature,
                      top_p=top_p, eos_token_id=eos_token_id,
                      session=session, stop_token_ids=stop_token_ids,
                      stop_sequences=stop_sequences, ignore_eos=ignore_eos,
                      logprobs=logprobs, prompt_logprobs=prompt_logprobs,
                      kv_dtype=self._kv_scheme)
        if session:
            req.session_id = req.req_id
        # penalties ride the streamed programs as they ride the pooled ones
        return self._submit(req, fp, pp, rp,
                            stream=needs_stream and can_stream)

    def _submit(self, req: Request, fp: float, pp: float, rp: float,
                stream: bool = False) -> int:
        self._attach_pen_row(req, fp, pp, rp)
        self._next_req_id += 1
        self._requests[req.req_id] = req
        if stream:
            self._stream_queue.append(req)
        else:
            self.scheduler.submit(req)
        return req.req_id

    def continue_session(self, session_id: int, new_tokens: list[int],
                         max_new_tokens: int = 64,
                         temperature: float = 0.0, top_p: float = 1.0,
                         stop_token_ids: list[int] | None = None,
                         stop_sequences: list[list[int]] | None = None,
                         logprobs: int = 0,
                         frequency_penalty: float = 0.0,
                         presence_penalty: float = 0.0,
                         repetition_penalty: float = 0.0) -> int:
        """The next turn of a session. If its KV is still allocated (in HBM
        or the host tier, or as host-streamed blocks), only the last reply
        token and the new tokens prefill, over the restored context; if it
        was reclaimed, the stored history re-prefills (host-streamed when
        it is too long for the pooled path).

        Penalty state is per TURN (OpenAI semantics): counts reset at the
        turn's first prefill chunk, and the repetition penalty's prompt span
        is what this turn feeds (the new tokens, or the whole history when
        it re-prefills): a restored turn does not re-scan its context."""
        stop_token_ids, stop_sequences = _validate_stops(
            stop_token_ids, stop_sequences)
        self._validate_logprobs(logprobs)
        fp, pp, rp = self._validate_penalties(
            frequency_penalty, presence_penalty, repetition_penalty)
        sess = self._sessions.get(session_id)
        if sess is None:
            raise ValueError(f"unknown session {session_id}")
        if sess.busy:
            raise ValueError(f"session {session_id} already has a turn in flight")
        if not new_tokens:
            raise ValueError("empty continuation")
        stream_kw = dict(max_new_tokens=max_new_tokens,
                         temperature=temperature, top_p=top_p,
                         stop_token_ids=stop_token_ids,
                         stop_sequences=stop_sequences, logprobs=logprobs,
                         pens=(fp, pp, rp))
        if sess.live and sess.stream_bids is not None:
            # its KV is host-tier stream blocks: the turn re-enters the
            # streamed path, appending to them
            return self._continue_stream_session(sess, new_tokens,
                                                 **stream_kw)
        if sess.live:
            # the KV covers tokens[:-1]: feed the last reply token + new ones
            prompt = [sess.tokens[-1]] + list(new_tokens)
            context_len = len(sess.tokens) - 1
        else:
            prompt = sess.tokens + list(new_tokens)
            context_len = 0
        total = context_len + len(prompt) + max_new_tokens
        bs = self.config.cache.block_size
        hbm_budget = (self.config.cache.num_hbm_blocks - 2) * bs
        if not sess.live and (total > self.config.engine.max_seq_len
                              or total > hbm_budget):
            if (self._stream_max_blocks > 0
                    and -(-total // bs) <= self._stream_max_blocks):
                # the reclaimed history re-prefills host-streamed, and the
                # session becomes stream-resident
                sess.reprefills += 1
                return self._continue_stream_session(
                    sess, new_tokens, reprefill=True, **stream_kw)
            raise ValueError("session history exceeds the pooled capacity"
                             " and the host-streamed capacity")
        if total > self.config.engine.max_seq_len:
            raise ValueError("session exceeds max_seq_len")
        if sess.live:
            sess.restores += 1
        else:
            sess.reprefills += 1
        sess.busy = True
        sess.last_use = time.monotonic()
        req = Request(req_id=self._next_req_id, prompt=prompt,
                      max_new_tokens=max_new_tokens, temperature=temperature,
                      top_p=top_p, session=True, session_id=session_id,
                      context_len=context_len,
                      stop_token_ids=stop_token_ids,
                      stop_sequences=stop_sequences, logprobs=logprobs,
                      kv_dtype=(sess.kv_dtype if sess.live and
                                sess.kv_dtype is not None
                                else self._kv_scheme))
        req.seq_slot = sess.seq_slot if sess.live else -1
        return self._submit(req, fp, pp, rp)

    def _continue_stream_session(self, sess: Session, new_tokens,
                                 max_new_tokens, temperature, top_p,
                                 stop_token_ids, stop_sequences, logprobs,
                                 pens, reprefill: bool = False) -> int:
        """The next turn of a host-streamed session (or the streamed
        re-prefill of a reclaimed one). It joins the stream queue; admission
        reuses the session's stream blocks and allocates only the growth.
        Penalty state is per turn, as for a pooled turn."""
        if reprefill:
            prompt = sess.tokens + list(new_tokens)
            context_len = 0
        else:
            prompt = [sess.tokens[-1]] + list(new_tokens)
            context_len = len(sess.tokens) - 1
        total = context_len + len(prompt) + max_new_tokens
        if -(-total // self.config.cache.block_size) > self._stream_max_blocks:
            raise ValueError("session exceeds the host-streamed capacity")
        if not reprefill:
            sess.restores += 1
        sess.busy = True
        sess.last_use = time.monotonic()
        req = Request(req_id=self._next_req_id, prompt=prompt,
                      max_new_tokens=max_new_tokens, temperature=temperature,
                      top_p=top_p, session=True,
                      session_id=sess.session_id, context_len=context_len,
                      stop_token_ids=stop_token_ids,
                      stop_sequences=stop_sequences, logprobs=logprobs,
                      kv_dtype=(sess.kv_dtype if not reprefill and
                                sess.kv_dtype is not None
                                else self._kv_scheme))
        return self._submit(req, *pens, stream=True)

    def get_session(self, session_id: int) -> Session:
        return self._sessions[session_id]

    def end_session(self, session_id: int) -> None:
        """Free a session's KV for good."""
        sess = self._sessions.pop(session_id)
        if sess.live:
            self._free_session_seq(sess)

    # -- session capacity -----------------------------------------------------

    def _free_session_seq(self, sess: Session) -> None:
        if sess.stream_bids is not None:
            for bid in sess.stream_bids:
                self.kvc.directory.free(bid)
            sess.stream_bids = None
            sess.live = False
            sess.seq_slot = -1
            return
        bids = self.kvc.pool.seq(sess.seq_slot).live_blocks
        self.kvc.free_seq(sess.seq_slot)
        if self.scheduler.free_seq_hook:
            # after the pool free, as the scheduler calls it (a spec
            # engine's draft pool frees the same blocks)
            self.scheduler.free_seq_hook(sess.seq_slot, bids)
        sess.live = False
        sess.seq_slot = -1

    def _idle_session_blocks(self) -> int:
        return sum(
            (len(s.stream_bids) if s.stream_bids is not None
             else len(self.kvc.pool.seq(s.seq_slot).live_blocks))
            for s in self._sessions.values() if s.live and not s.busy)

    def _extra_committed_blocks(self) -> int:
        """Blocks committed outside the scheduler's running set: idle
        session KV and the live host-streamed sequences (they hold host
        slots that the pooled requests' worst case would otherwise count
        on)."""
        return self._idle_session_blocks() + sum(
            len(st.bids) for st in self._streams.values())

    def _make_capacity(self) -> bool:
        """Free capacity under pressure: idle session KV first (a later
        re-prefill), then preempt the youngest non-session request (its
        in-flight work is lost)."""
        if self._reclaim_idle_session():
            return True
        return self.scheduler.preempt_youngest() is not None

    def _reclaim_idle_session(self) -> bool:
        """Free the least recently used idle session's KV; its next turn
        re-prefills. True if one was reclaimed."""
        idle = [s for s in self._sessions.values() if s.live and not s.busy]
        if not idle:
            return False
        self._free_session_seq(min(idle, key=lambda s: s.last_use))
        return True

    # -- logprobs and sampling penalties ------------------------------------

    def _validate_logprobs(self, logprobs: int) -> None:
        if logprobs and not 0 < logprobs <= self.LOGPROBS_COMPILE_K:
            raise ValueError("logprobs must be in [0, 20]")

    def _validate_penalties(self, fp: float, pp: float, rp: float):
        """Normalize and check the penalty knobs (OpenAI ranges for
        frequency / presence; repetition 1.0 means off). Returns
        (fp, pp, rp)."""
        fp, pp, rp = float(fp), float(pp), float(rp)
        if abs(rp - 1.0) < 1e-9:
            rp = 0.0
        if not (fp or pp or rp):
            return 0.0, 0.0, 0.0
        if not -2.0 <= fp <= 2.0:
            raise ValueError("frequency_penalty must be in [-2, 2]")
        if not -2.0 <= pp <= 2.0:
            raise ValueError("presence_penalty must be in [-2, 2]")
        if rp and not 0.0 < rp <= 10.0:
            raise ValueError("repetition_penalty must be in (0, 10]")
        if self.spec is not None:
            raise ValueError(
                "sampling penalties are not supported on speculative-"
                "decoding engines (proposals come from the unpenalized "
                "draft law; penalizing verify but not the proposals would "
                "break the acceptance rule)")
        if not self._pen_free:
            raise ValueError(
                "too many concurrent penalized requests (EngineConfig."
                f"penalty_rows={self.config.engine.penalty_rows})")
        return fp, pp, rp

    def _attach_pen_row(self, req: Request, fp: float, pp: float,
                        rp: float) -> None:
        """Give a penalized request its row of the plane; the first one
        allocates the plane on the device."""
        if not (fp or pp or rp):
            return
        req.frequency_penalty = fp
        req.presence_penalty = pp
        req.repetition_penalty = rp
        req.pen_row = self._pen_free.pop()
        if self._pen_counts is None:
            self._pen_counts = torch.zeros(
                (self.config.engine.penalty_rows + 1,
                 self.model_config.vocab_size),
                dtype=torch.int32, device=self.device)

    def _free_pen_row(self, req: Request) -> None:
        if req.pen_row >= 0:
            self._pen_free.append(req.pen_row)
            req.pen_row = -1

    def _pen_dispatch(self, group, B: int, prefill: bool = False) -> dict:
        """The dispatch's penalty arguments ({} while the plane was never
        allocated): pen_info [B, 5] for the lanes of `group` in lane order
        and the plane. Prefill groups hold (req, n, start); their reset and
        count flags follow the chunk's place in the prompt."""
        if self._pen_counts is None:
            return {}
        pi = np.zeros((B, 5), np.int32)
        pi[:, 0] = self._pen_guard
        resets = []
        for i, item in enumerate(group):
            req = item[0] if prefill else item
            if req.pen_row < 0:
                continue
            if prefill:
                _, n, start = item
                reset = req.pen_reset_gen != req.restarts
                count = start - req.context_len + n >= len(req.prompt)
                if reset:
                    resets.append(req)
            else:
                reset, count = False, True
            pi[i] = encode_pen_info(
                req.pen_row, req.frequency_penalty, req.presence_penalty,
                req.repetition_penalty, reset=reset, count_sampled=count)
        for req in resets:
            req.pen_reset_gen = req.restarts
        return {"pen_info": pi, "pen_counts": self._pen_counts}

    def _group_logprobs_k(self, reqs) -> int:
        """The top-k width of a dispatch: 0 when no lane asked."""
        return self.LOGPROBS_COMPILE_K if any(r.logprobs for r in reqs) else 0

    def cancel(self, req_id: int) -> EngineOutput | None:
        """Abort a request that has not finished. Returns the partial result
        (reason "cancelled"), or None for unknown or finished ids. Live KV
        frees as on a normal finish, except that a session turn that is
        decoding keeps its KV (the tokens generated so far are real
        context); a queued request is withdrawn."""
        req = self._requests.get(req_id)
        if req is None or req.state in (RequestState.FINISHED,
                                        RequestState.FAILED):
            return None
        if req.state == RequestState.QUEUED:
            # no KV of its own yet (a queued session turn holds only the
            # session's KV, which stays)
            if req in self._stream_queue:
                self._stream_queue.remove(req)
            else:
                self.scheduler.queue.remove(req)
            req.state = RequestState.FINISHED
            req.finish_reason = "cancelled"
            req.finish_time = time.monotonic()
            self._free_pen_row(req)
            self.stats.requests_finished += 1
            if req.session and req.session_id in self._sessions:
                self._sessions[req.session_id].busy = False
            return EngineOutput(req.req_id, _result_tokens(req), "cancelled",
                                req.ttft_ms, req.tpot_ms, req.session_id,
                                logprobs=_result_logprobs(req),
                                prompt_logprobs=_result_prompt_logprobs(req))
        st = self._streams.pop(req_id, None)
        if st is not None:
            return self._cancel_stream(req, st)
        if req.seq_slot >= 0:
            self.kvc.pin_seq(req.seq_slot, False)
        if req.session and req.state == RequestState.PREFILLING:
            # KV written mid-prefill covers part of the prompt only: kept
            # as a live session it would disagree with the session's tokens.
            # Free it; the next turn re-prefills the stored history (a
            # cancelled first turn leaves no session at all)
            sess = self._sessions.get(req.session_id)
            req.session = False
            out = self._finish_request(req, "cancelled")
            if sess is not None:
                sess.busy = False
                sess.live = False
            return out
        return self._finish_request(req, "cancelled")

    def _cancel_stream(self, req: Request, st: StreamState) -> EngineOutput:
        """Cancel a live host-streamed request: its host blocks free, except
        that a decoding session turn keeps them (the tokens so far are real
        context); a session turn cancelled mid-prefill drops the session's
        liveness, as the pooled path does."""
        was_running = req.state == RequestState.RUNNING
        req.state = RequestState.FINISHED
        req.finish_reason = "cancelled"
        req.finish_time = time.monotonic()
        self._free_pen_row(req)
        if req.session and was_running:
            self._keep_stream_session(req, st)
        else:
            for bid in st.bids:
                self.kvc.directory.free(bid)
            sess = self._sessions.get(req.session_id) if req.session else None
            if sess is not None:
                sess.busy = False
                sess.live = False
                sess.stream_bids = None
        self.stats.requests_finished += 1
        return EngineOutput(req.req_id, _result_tokens(req), "cancelled",
                            req.ttft_ms, req.tpot_ms, req.session_id,
                            logprobs=_result_logprobs(req),
                            prompt_logprobs=_result_prompt_logprobs(req))

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
        if self.spec is not None and kv_dtype != base:
            raise ValueError("speculative decoding engines use a single "
                             "KV scheme (draft and verify share the pool "
                             "encoding)")
        if storage_width_class(kv_dtype) != storage_width_class(base):
            busy = self.scheduler.num_waiting + self.scheduler.num_running
            streams = len(self._streams) + len(self._stream_queue)
            if busy or streams or self._sessions:
                raise ValueError(
                    f"cross-width scheme switch {base.value} -> "
                    f"{kv_dtype.value} requires an idle engine (live: "
                    f"{busy} requests, {streams} streams, "
                    f"{len(self._sessions)} sessions)")
            if self.round_graphs is not None:
                self.round_graphs.clear()    # they read the old pools
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
        return (self.scheduler.num_waiting > 0 or self.scheduler.num_running > 0
                or bool(self._streams) or bool(self._stream_queue))

    def run(self, max_steps: int = 100000) -> list[EngineOutput]:
        outs = []
        for _ in range(max_steps):
            if not self.has_work:
                break
            outs.extend(self.step())
        # land an in-flight training step, so that the statistics hold it
        self.prefetcher.drain_training()
        return outs

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
        if self._streams or self._stream_queue:
            with self.timers.phase("stream"):
                self._stream_tick(finished)
        t2b = time.monotonic()
        self.stats.stream_time_s += t2b - t2
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
            with self.timers.phase("maintain.train"):
                self.prefetcher.maybe_train()
            # preload queued session restores: their sequence is known
            # before admission (the idle-KV warm-up a prefetcher is for)
            for r in list(self.scheduler.queue)[:4]:
                if r.session and r.seq_slot >= 0:
                    self.kvc.prefetch_blocks(
                        self.kvc.seq_nonresident_blocks(r.seq_slot))
            with self.timers.phase("maintain.kvc"):
                self.kvc.maintain()
        t3 = time.monotonic()
        self.stats.prefill_time_s += t1 - t0
        self.stats.decode_time_s += t2 - t1
        self.stats.overhead_time_s += t3 - t2b
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
            # blocks and start prefill past them. Not for prompt-logprob
            # requests (skipped positions would lose their scores) nor for
            # repetition-penalty ones (every prompt token must pass the
            # prefill pass to set its presence bit)
            if (req.prefill_pos == 0 and req.context_len == 0
                    and not req.prompt_logprobs
                    and not (req.pen_row >= 0 and req.repetition_penalty)):
                matched, bids = self.kvc.match_prefix(
                    req.prompt, self._req_scheme(req))
                if matched:
                    self.kvc.claim_prefix(req.seq_slot, bids)
                    req.prefill_pos = matched
            pos0 = req.prefill_pos
            if req.prompt_logprobs and pos0 > 0:
                # re-feed the chunk-boundary token so that its successor is
                # scored inside the chunk (it rewrites the same KV bytes)
                pos0 -= 1
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
        if self._fused_rounds:
            self.kvc.prepare_resident([r.seq_slot for r, _, _ in ready])
        else:
            self.kvc.ensure_resident([r.seq_slot for r, _, _ in ready])
        if self.spec is not None:
            # mirror the wave into the draft cache in one pass
            self.spec.prefill_batch(
                [(req.seq_slot, start, n,
                  req.prompt[start - req.context_len:
                             start - req.context_len + n])
                 for req, n, start in ready], chunk=chunk, batch=B)
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
        lk = self._group_logprobs_k(r for r, _, _ in ready)
        scored = np.zeros(B, bool)
        scored[:len(ready)] = [r.prompt_logprobs for r, _, _ in ready]
        kw = dict(**self._pen_dispatch(ready, B, prefill=True), max_blocks=mb,
                  rng_seed=self._rng_seed, logprobs_k=lk,
                  prompt_scores=scored if scored.any() else None)
        mig, up_bids, down_bids = (self.kvc.take_migration_plan()
                                   if self._fused_rounds else (None, [], []))
        if up_bids or down_bids:
            self.kvc.order_after_migrations()
            out = prefill_round_fused(
                self.params, self.model_config, scheme, packed, mig,
                self.kvc.pools, self.kvc.store, **kw)
            self.kvc.commit_migration(up_bids, down_bids)
        else:
            self.kvc.order_round(packed[:, 4:4 + mb])
            out = prefill_batch_packed(
                self.params, self.model_config, scheme, packed,
                self.kvc.pools, **kw)
        toks, *rest = fetch(*out) if isinstance(out, tuple) else fetch(out)
        lp = rest[:3] if lk else None
        scores = rest[-1] if scored.any() else None

        for i, (req, n, start) in enumerate(ready):
            blocks = self.kvc.pool.seq(req.seq_slot).blocks
            for bi in range(start // bs, (start + n - 1) // bs + 1):
                if blocks[bi] is not None:
                    self.kvc.directory.mark_dirty(blocks[bi])
            self.kvc.pin_seq(req.seq_slot, False)
            old_pos = req.prefill_pos
            req.prefill_pos = start - req.context_len + n
            if req.prompt_logprobs:
                # chunk position j scores prompt token pos0 + j + 1: the
                # first target is the one after the re-fed boundary token
                # (token 1 on the first chunk), so every one is new, in order
                req.prompt_logprobs_data.extend(
                    float(x) for x in scores[i, :n - 1])
            if req.context_len == 0:
                self.kvc.register_prefix(req.seq_slot, req.prompt,
                                         req.prefill_pos, scheme)
            self.prefetcher.observe_tokens(
                req.seq_slot, req.prompt[old_pos:req.prefill_pos])
            self.scheduler.stats.prefill_chunks += 1
            if req.done_prefill:
                self._record_token(req, int(toks[i]), first=True)
                if req.logprobs:
                    req.logprobs_data.append(_logprob_record(
                        lp[0][i], lp[1][i], lp[2][i], req.logprobs))
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
        if self.spec is not None:
            return self._spec_decode_tick(batch, finished)
        return self._multi_decode_tick(batch, finished)

    def _multi_decode_tick(self, batch: list[Request],
                           finished: list[EngineOutput]) -> list[Request]:
        """Fused multi-token decode: `decode_horizon` tokens in one pass per
        KV scheme of the batch (normally one)."""
        h = self.config.engine.decode_horizon
        B = self.config.engine.max_batch_size
        bs = self.config.cache.block_size
        max_tokens = self.kvc.pool.table.max_blocks_per_seq * bs
        # the JAX engine fuses multi-step rounds only (its single-step path
        # keeps standalone migrate programs)
        fused = self._fused_rounds and h > 1
        # decode.host = residency / extend / pack / bookkeeping on the host;
        # decode.program = the model pass through the token fetch
        t_host0 = time.monotonic()
        slots = [r.seq_slot for r in batch]
        for s in slots:
            self.kvc.pin_seq(s, True)
        for s in slots:
            self.kvc.touch_seq(s)
        if fused:
            self.kvc.prepare_resident(slots)
        else:
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
            # the in-round leg rides the plain rounds only (the JAX fused
            # program leaves pcont to the controller's host refresh)
            lstm_kw, lstm_hist = (self._lstm_dispatch(group, B)
                                  if not self._fused_rounds else ({}, None))
            hcols = lstm_hist.shape[1] if lstm_hist is not None else 0
            packed = np.full((B, mb + 4 + hcols), guard, np.int32)
            packed[:, :4] = 0
            self._rng_counter += 1
            packed[:, 3] = self._rng_counter
            for i, r in enumerate(group):
                packed[i, 0] = r.output[-1]
                packed[i, 1] = r.num_tokens - 1
                packed[i, 2] = encode_sampling(r.temperature, r.top_p)
                row = self.kvc.pool.table.row(r.seq_slot)
                packed[i, 4:4 + mb] = np.where(row >= 0, row, guard)
            if hcols:
                packed[:, 4 + mb:] = lstm_hist
            mig, up_bids, down_bids = (self.kvc.take_migration_plan()
                                       if fused else (None, [], []))
            t_host += time.monotonic() - t0
            t0 = time.monotonic()
            lk = self._group_logprobs_k(group)
            kw = dict(**self._pen_dispatch(group, B), horizon=h,
                      rng_seed=self._rng_seed, logprobs_k=lk)
            if self.round_graphs is None:
                self._eager_rounds += 1
            if up_bids or down_bids:
                self.kvc.order_after_migrations()
                out = decode_round_fused(
                    self.params, self.model_config, scheme, packed, mig,
                    self.kvc.pools, self.kvc.store, graphs=self.round_graphs,
                    **kw)
                self.kvc.commit_migration(up_bids, down_bids)
            else:
                self.kvc.order_round(packed[:, 4:4 + mb])
                out = decode_multi_packed(
                    self.params, self.model_config, scheme, packed,
                    self.kvc.pools, graphs=self.round_graphs, **kw,
                    **lstm_kw)
            # the round's tokens, logprob tables and continue probabilities
            # in one host copy
            toks, *rest = fetch(*out) if isinstance(out, tuple) else fetch(out)
            lp = rest[:3]
            pcont = rest[-1] if lstm_kw else None
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
                    if r.logprobs:
                        r.logprobs_data.append(_logprob_record(
                            lp[0][i, j], lp[1][i, j], lp[2][i, j],
                            r.logprobs))
                    out = self._maybe_finish(r)
                    if out is not None:
                        finished.append(out)
            if pcont is not None:
                # after the round's observe_tokens, so that they count as
                # fresh; finished lanes are skipped
                self.prefetcher.install_pcont(
                    [r.seq_slot for r in group], pcont[:len(group)])
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

    def _lstm_dispatch(self, group, B: int):
        """({decode_multi_packed's LSTM arguments}, the bucketed histories
        [B, T] for the packed array's last columns), or ({}, None) when
        the in-round continue-probability leg is off. As in the JAX
        engine, it rides fused rounds only: at horizon 1 (the JAX engine's
        single-step path) `plan` refreshes the lanes on the host."""
        pf = self.prefetcher
        pc = self.config.prefetch
        if (pf.predictor is None or not pc.enabled or not pc.ingraph_pcont
                or self.eos_token_id is None
                or self.config.engine.decode_horizon <= 1
                or self.mesh is not None):
            # a mesh keeps the host path, as the JAX engine does
            return {}, None
        if pf.predictor.params is not self._lstm_src and (
                self._lstm_dev is None
                or self.stats.steps - self._lstm_refresh_step >= 16):
            # online training publishes a new tree every step; values from
            # weights a few steps old serve the prefetch gate as well, so
            # the device copy is refreshed at most every 16 rounds
            self._lstm_src = pf.predictor.params
            self._lstm_refresh_step = self.stats.steps
            self._lstm_dev = tree_to(self._lstm_src, self.device)
        hist = pf.history_matrix_bucketed([r.seq_slot for r in group],
                                          pad_rows=B)
        return ({"lstm_params": self._lstm_dev, "lstm_cols": hist.shape[1],
                 "lstm_eos": int(self.eos_token_id) % pf.predictor.n_classes},
                hist)

    def _lstm_draft_fallback(self, histories: list[list[int]]):
        """The n-gram proposer's miss seeder: the LSTM predicts the next
        token's class, and the lane's own history gives the latest
        concrete token of the highest-ranked predicted class (-1: none)."""
        pf = self.prefetcher

        def fallback(miss: list[int]) -> np.ndarray:
            T = pf.config.history_len
            mat = np.zeros((len(miss), T), np.int32)
            for j, i in enumerate(miss):
                h = histories[i][-T:]
                mat[j, T - len(h):] = h
            ids, _ = pf.predictor.predict_top_k(mat, k=4)
            nc = pf.predictor.n_classes
            out = np.full(len(miss), -1, np.int32)
            for j, i in enumerate(miss):
                by_class = {int(t) % nc: int(t) for t in histories[i]}
                for cls in ids[j]:
                    tok = by_class.get(int(cls))
                    if tok is not None:
                        out[j] = tok
                        break
            return out

        return fallback

    def _spec_decode_tick(self, batch: list[Request],
                          finished: list[EngineOutput]) -> list[Request]:
        """One speculative round for the group: propose, then verify +
        accept in one call (`SpecDecoder` / `NgramProposer.verify_accept`).
        With the prefetch LSTM and `seed_ngram`, the LSTM seeds the n-gram
        proposer's misses (`_lstm_draft_fallback`)."""
        gamma = self.spec.gamma
        B = self.config.engine.max_batch_size
        bs = self.config.cache.block_size
        slots = [r.seq_slot for r in batch]
        for s in slots:
            self.kvc.pin_seq(s, True)
        # record the accesses BEFORE the demand fetch, so that misses count
        # as misses (touching after ensure_resident would count every
        # demand fetch as a hit)
        for s in slots:
            self.kvc.touch_seq(s)
        t0 = time.monotonic()
        self.kvc.ensure_resident(slots)
        self.timers.record("decode.spec_resident", time.monotonic() - t0)
        max_tokens = self.kvc.pool.table.max_blocks_per_seq * bs
        for r in batch:
            # room for the verify appends at n-1 .. n-1+gamma, clamped to the
            # table (a lane within gamma of it writes fewer speculative rows;
            # positions past its final length are never read)
            while r.seq_slot >= 0 and not self.kvc.extend_seq(
                    r.seq_slot, min(r.num_tokens + gamma, max_tokens)):
                if not self._make_capacity():
                    raise RuntimeError(
                        "KV capacity exhausted with nothing to preempt")
            if r.seq_slot >= 0:
                self.kvc.pin_seq(r.seq_slot, True)
                self.spec.sync_seq(r.seq_slot)
        batch = [r for r in batch if r.seq_slot >= 0]
        if not batch:
            return batch

        guard = self.kvc.guard_slot
        mb = self.kvc.pool.table.max_blocks_per_seq
        last = np.zeros(B, np.int32)
        positions = np.zeros(B, np.int32)
        active = np.zeros(B, bool)
        temps = np.zeros(B, np.float32)
        top_ps = np.zeros(B, np.float32)
        ttab = np.full((B, mb), guard, np.int32)
        dtab = np.full((B, mb), self.spec.guard_slot, np.int32)
        for i, r in enumerate(batch):
            last[i] = r.output[-1]
            positions[i] = r.num_tokens - 1
            active[i] = True
            temps[i] = r.temperature
            top_ps[i] = r.top_p if 0.0 < r.top_p < 1.0 else 0.0
            row = self.kvc.pool.table.row(r.seq_slot)
            ttab[i] = np.where(row >= 0, row, guard)
            dtab[i] = self.spec.table[r.seq_slot]

        self._rng_counter += 1
        kw = {}
        if not self.spec.has_draft_model:
            # prompt lookup reads each lane's own history
            kw["histories"] = [list(r.prompt) + r.output for r in batch]
            if (self.prefetcher.predictor is not None
                    and self.config.prefetch.seed_ngram):
                kw["fallback"] = self._lstm_draft_fallback(kw["histories"])
        t0 = time.monotonic()
        drafts = self.spec.propose(last, positions, dtab, active,
                                   temps=temps, top_ps=top_ps,
                                   rng_counter=self._rng_counter, **kw)
        self.timers.record("decode.spec_propose", time.monotonic() - t0)
        gen = (seeded_generator(self.device, self._rng_seed,
                                self._rng_counter)
               if (temps > 0).any() else None)
        t0 = time.monotonic()
        self.kvc.order_round(ttab)
        emitted, n_acc, lp = self.spec.verify_accept(
            self.params, self.model_config, self._req_scheme(batch[0]),
            np.concatenate([last[:, None], drafts], axis=1), positions,
            self.kvc.pools, ttab, active, drafts, temps, gen, top_ps=top_ps,
            logprobs_k=self._group_logprobs_k(batch))
        self.timers.record("decode.spec_verify", time.monotonic() - t0)
        for i, r in enumerate(batch):
            blocks = self.kvc.pool.seq(r.seq_slot).blocks
            # the KV this round made valid: positions n-1 .. n-1+accepted
            for bi in range(int(positions[i]) // bs,
                            (int(positions[i]) + int(n_acc[i])) // bs + 1):
                if bi < len(blocks) and blocks[bi] is not None:
                    self.kvc.directory.mark_dirty(blocks[bi])
            for j, tok in enumerate(emitted[i]):
                if r.state != RequestState.RUNNING:
                    break
                self._record_token(r, tok)
                if r.logprobs:
                    # verify row j scores the token emitted at index j
                    r.logprobs_data.append(_logprob_record(
                        lp[0][i, j], lp[1][i, j], lp[2][i, j], r.logprobs))
                out = self._maybe_finish(r)
                if out is not None:
                    finished.append(out)
        for r in batch:
            if r.state == RequestState.RUNNING:
                self.kvc.pin_seq(r.seq_slot, False)
        self.scheduler.stats.decode_batches += 1
        self.scheduler.stats.decode_tokens += sum(len(e) for e in emitted)
        return batch

    # -- host-streamed serving (KV larger than the HBM pool) -----------------

    def _stream_tick(self, finished: list[EngineOutput]) -> None:
        """Admit queued streamed requests (all their host blocks at once,
        capacity-gated; a session turn reuses the session's stream blocks
        and allocates the growth), then advance every streamed lane: one
        dispatch per (phase, scheme) group. Streamed sequences never touch
        the HBM pool."""
        bs = self.config.cache.block_size
        while self._stream_queue:
            req = self._stream_queue[0]
            total = req.context_len + len(req.prompt) + req.max_new_tokens
            sess = (self._sessions.get(req.session_id)
                    if req.session and req.context_len > 0 else None)
            have = (list(sess.stream_bids) if sess is not None
                    and sess.stream_bids is not None else [])
            blocks = -(-total // bs) - len(have)
            if self.kvc.directory.host_free < blocks:
                # host-tier pressure: idle session KV (pooled or streamed)
                # is reclaimable; a later turn re-prefills
                if not self._reclaim_idle_session():
                    break
                continue
            self._stream_queue.popleft()
            if sess is not None:
                # the turn owns the blocks until it finishes (never two
                # owners); `_keep_stream_session` hands them back grown
                sess.stream_bids = None
            bids = have + [self.kvc.directory.allocate_host()
                           for _ in range(blocks)]
            slots = np.array([self.kvc.directory.entry(b).host_slot
                              for b in bids], np.int32)
            req.state = RequestState.PREFILLING
            self._streams[req.req_id] = StreamState(req, bids, slots)
        if self._streams:
            # the streamed copies run on this stream, migrations on the
            # copy stream: a host slot may be reused while a demote's copy
            # into it is in flight
            self.kvc.order_after_migrations()
        groups: dict = {}
        for rid, st in self._streams.items():
            # streamed KV never shares pool blocks with layered KV: a
            # per-layer table leaves streamed requests the uniform base scheme
            scheme = (self.config.cache.kv_dtype
                      if self._layer_schemes is not None
                      else self._req_scheme(st.req))
            groups.setdefault((st.req.state, scheme), []).append((rid, st))
        for (phase, scheme), members in groups.items():
            self._stream_group_dispatch(members, phase, scheme, finished)

    def _stream_waves(self) -> tuple[int, int]:
        """(wave, waves of the streamed context table)."""
        wave = self.config.engine.stream_wave
        return wave, -(-self._stream_max_blocks // wave)

    def _stream_group_dispatch(self, members, phase, scheme,
                               finished: list[EngineOutput]) -> None:
        """Advance every member lane by a prefill chunk (PREFILLING) or one
        decode token (RUNNING), or, decoding with a horizon above 1, by the
        fused decode when its slabs fit the budget. Unlike the JAX engine,
        the lane count is not padded to a power of two: nothing compiles."""
        ec = self.config.engine
        if (phase == RequestState.RUNNING and ec.decode_horizon > 1
                and ec.stream_stage_mb > 0
                and len(set(self.model_config.layer_windows())) <= 1
                and self._stream_decode_fused(members, scheme, finished)):
            return
        bs = self.config.cache.block_size
        wave, n_waves = self._stream_waves()
        prefill = phase == RequestState.PREFILLING
        chunk_t = ec.prefill_chunk if prefill else 1
        tw = n_waves * wave + stream_decode_nblk(chunk_t, bs)
        B = len(members)
        packed = np.zeros((B, 4 + tw + chunk_t), np.int32)
        packed[:, 4:4 + tw] = self.kvc.store.guard_slot
        skip = np.zeros(B, np.int64)
        lanes, pen_group = [], []
        for i, (rid, st) in enumerate(members):
            req = st.req
            if prefill:
                pos0 = req.prefill_pos
                if req.prompt_logprobs and pos0 > 0:
                    # re-feed the chunk-boundary token so that its successor
                    # is scored inside the chunk; its KV is already stored
                    # and is not written again (byte-identical by
                    # construction)
                    pos0 -= 1
                    skip[i] = 1
                n = min(chunk_t, len(req.prompt) - pos0)
                toks = req.prompt[pos0:pos0 + n]
                start = req.context_len + pos0
                pen_group.append((req, n, start))
            else:
                n, toks, start = 1, [req.output[-1]], req.num_tokens - 1
                pos0 = req.prefill_pos
                pen_group.append(req)
            self._rng_counter += 1
            packed[i, 0] = start
            packed[i, 1] = n
            packed[i, 2] = encode_sampling(req.temperature, req.top_p)
            packed[i, 3] = self._rng_counter
            packed[i, 4:4 + len(st.host_slots)] = st.host_slots
            packed[i, 4 + tw:4 + tw + n] = toks
            lanes.append((rid, st, n, pos0))
        lk = self._group_logprobs_k(st.req for _, st in members)
        ps = prefill and any(st.req.prompt_logprobs for _, st in members)
        # the staged path's context-wave bound: the widest lane's context
        # in waves, rounded up to a power of two (the JAX engine's compile
        # bucket; here it sizes the staging groups as there)
        wave_toks = wave * bs
        used = max((int(p[0]) + wave_toks - 1) // wave_toks
                   for p in packed)
        ctx_waves = min(n_waves, 1 << max(used - 1, 0).bit_length())
        out = stream_step_batched(
            self.params, self.model_config, scheme, packed, self.kvc.store,
            **self._pen_dispatch(pen_group, B, prefill=prefill),
            max_blocks=self._stream_max_blocks, wave=wave,
            rng_seed=self._rng_seed, logprobs_k=lk, prompt_scores=ps,
            stage_mb=ec.stream_stage_mb, ctx_waves=ctx_waves,
            mark_prompt=prefill, skip=skip)
        # after the stash: this host copy waits for the stream, stash too
        toks, *rest = fetch(*out) if isinstance(out, tuple) else fetch(out)
        lp = rest[:3] if lk else None
        scores = rest[-1] if ps else None
        for i, (rid, st, n, pos0) in enumerate(lanes):
            req = st.req
            emitted = False
            if prefill:
                req.prefill_pos = pos0 + n
                if req.prompt_logprobs:
                    # chunk position j scores prompt token pos0 + j + 1
                    req.prompt_logprobs_data.extend(
                        float(x) for x in scores[i, :n - 1])
                self.stats.stream_chunks += 1
                if req.done_prefill:
                    self._record_token(req, int(toks[i]), first=True)
                    req.state = RequestState.RUNNING
                    emitted = True
            else:
                self._record_token(req, int(toks[i]))
                self.stats.stream_tokens += 1
                emitted = True
            if emitted and req.logprobs:
                req.logprobs_data.append(_logprob_record(
                    lp[0][i], lp[1][i], lp[2][i], req.logprobs))
            out = self._maybe_finish_stream(st)
            if out is not None:
                finished.append(out)
                self._streams.pop(rid, None)

    def _stream_decode_fused(self, members, scheme,
                             finished: list[EngineOutput]) -> bool:
        """decode_horizon streamed decode steps a lane in one call
        (`stream_decode_multi_batched`): each lane's context is staged once
        and re-read by every step. Greedy lanes match the per-token path
        token for token. Returns False, and the caller takes the per-token
        path, when the live lanes' all-layer slabs would exceed four times
        stream_stage_mb, computed as the JAX engine computes it (the
        context waves rounded up to a power of two), so that a request
        takes the same decode path in both packages."""
        ec = self.config.engine
        bs = self.config.cache.block_size
        wave, n_waves = self._stream_waves()
        h = ec.decode_horizon
        tw = n_waves * wave + stream_decode_nblk(h, bs)
        B = len(members)
        packed = np.zeros((B, 4 + tw + 1), np.int32)
        packed[:, 4:4 + tw] = self.kvc.store.guard_slot
        for i, (rid, st) in enumerate(members):
            req = st.req
            self._rng_counter += 1
            packed[i, 0] = req.num_tokens - 1        # the seed token's position
            packed[i, 1] = min(h, max(req.max_new_tokens - len(req.output), 1))
            packed[i, 2] = encode_sampling(req.temperature, req.top_p)
            packed[i, 3] = self._rng_counter
            packed[i, 4:4 + len(st.host_slots)] = st.host_slots
            packed[i, -1] = req.output[-1]
        wave_toks = wave * bs
        used = max((int(p[0]) + h + wave_toks - 1) // wave_toks
                   for p in packed)
        ctx_waves = min(n_waves, 1 << max(used - 1, 0).bit_length())
        slab_mb = (ctx_waves * wave * self.model_config.num_layers
                   * self.kvc.store.bytes_per_row * B) >> 20
        if slab_mb > 4 * ec.stream_stage_mb:
            return False
        lk = self._group_logprobs_k(st.req for _, st in members)
        out = stream_decode_multi_batched(
            self.params, self.model_config, scheme, packed, self.kvc.store,
            **self._pen_dispatch([st.req for _, st in members], B),
            max_blocks=self._stream_max_blocks, wave=wave, horizon=h,
            rng_seed=self._rng_seed, logprobs_k=lk)
        toks, *lp = fetch(*out) if lk else fetch(out)
        for i, (rid, st) in enumerate(members):
            req = st.req
            for j in range(int(packed[i, 1])):
                self._record_token(req, int(toks[i, j]))
                self.stats.stream_tokens += 1
                if req.logprobs:
                    req.logprobs_data.append(_logprob_record(
                        lp[0][i, j], lp[1][i, j], lp[2][i, j], req.logprobs))
                if self._check_stop(req):
                    break
            out = self._maybe_finish_stream(st)
            if out is not None:
                finished.append(out)
                self._streams.pop(rid, None)
        return True

    def _keep_stream_session(self, req: Request, st: StreamState) -> None:
        """Persist a finished (or decoding-cancelled) streamed session turn:
        the conversation's KV stays as host-tier stream blocks, which the
        next turn appends to (the pooled analog is `_finish_request`'s
        keep branch)."""
        sid = req.session_id
        sess = self._sessions.get(sid)
        if sess is None:
            sess = Session(session_id=sid, seq_slot=-1)
            self._sessions[sid] = sess
        if req.context_len > 0:
            # prompt[0] was the previous reply's last token
            sess.tokens.extend(req.prompt[1:] + req.output)
        else:
            sess.tokens = list(req.prompt) + req.output
        # keep the blocks covering the written KV (positions 0 ..
        # len(tokens) - 2; the last sampled token's KV is not written yet);
        # unused max_new_tokens headroom frees here
        needed = -(-(len(sess.tokens) - 1) // self.config.cache.block_size)
        for bid in st.bids[needed:]:
            self.kvc.directory.free(bid)
        sess.stream_bids = list(st.bids[:needed])
        sess.seq_slot = -1
        sess.live = True
        sess.busy = False
        sess.kv_dtype = self._req_scheme(req)
        sess.last_use = time.monotonic()

    def _maybe_finish_stream(self, st: StreamState) -> EngineOutput | None:
        req = st.req
        if req.state != RequestState.RUNNING:
            return None
        reason = self._check_stop(req)
        if not reason:
            return None
        req.state = RequestState.FINISHED
        req.finish_reason = reason
        req.finish_time = time.monotonic()
        self._free_pen_row(req)
        if req.session:
            self._keep_stream_session(req, st)
        else:
            for bid in st.bids:
                self.kvc.directory.free(bid)
        self.stats.requests_finished += 1
        if req.tpot_ms > 0:
            self._tpots.append(req.tpot_ms)
        if req.ttft_ms > 0:
            self._ttfts.append(req.ttft_ms)
        return EngineOutput(req.req_id, _result_tokens(req), reason,
                            req.ttft_ms, req.tpot_ms, req.session_id,
                            logprobs=_result_logprobs(req),
                            prompt_logprobs=_result_prompt_logprobs(req))

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
                    freed = self.kvc.retire_out_of_window(r.seq_slot, first)
                    if freed and self.spec is not None:
                        self.spec.retire_blocks(r.seq_slot, freed)

    # -- bookkeeping ----------------------------------------------------------------

    def _record_token(self, req: Request, tok: int, first: bool = False) -> None:
        now = time.monotonic()
        if first or not req.first_token_time:
            req.first_token_time = now
        req.token_times.append(now)
        req.output.append(tok)
        self.stats.tokens_generated += 1
        if req.seq_slot >= 0:  # a streamed request has no pooled history
            self.prefetcher.observe_tokens(req.seq_slot, [tok])

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
        self._free_pen_row(req)
        self.prefetcher.forget_seq(req.seq_slot)
        keep = req.session and reason != "oom" and req.seq_slot >= 0
        if keep:
            # the turn's KV stays allocated (and demotable) for the next one
            sid = req.session_id
            sess = self._sessions.get(sid)
            if sess is None:
                sess = Session(session_id=sid, seq_slot=req.seq_slot)
                self._sessions[sid] = sess
            if req.context_len > 0:
                # prompt[0] was the previous reply's last token, stored
                sess.tokens.extend(req.prompt[1:] + req.output)
            else:
                sess.tokens = list(req.prompt) + req.output
            sess.seq_slot = req.seq_slot
            sess.live = True
            sess.busy = False
            sess.kv_dtype = self._req_scheme(req)
            sess.last_use = time.monotonic()
        elif req.session and req.session_id in self._sessions:
            sess = self._sessions[req.session_id]
            sess.busy = False
            if req.seq_slot >= 0 and sess.live and sess.seq_slot == req.seq_slot:
                # a turn that failed over the session's KV frees it below:
                # the next turn re-prefills the stored history
                sess.live = False
                sess.seq_slot = -1
        self.scheduler.finish(req, reason, free=not keep)
        self.stats.requests_finished += 1
        if req.tpot_ms > 0:
            self._tpots.append(req.tpot_ms)
        if req.ttft_ms > 0:
            self._ttfts.append(req.ttft_ms)
        return EngineOutput(req.req_id, _result_tokens(req), reason,
                            req.ttft_ms, req.tpot_ms, req.session_id,
                            logprobs=_result_logprobs(req),
                            prompt_logprobs=_result_prompt_logprobs(req))

    def score_prompts(self, prompts: list[list[int]], *,
                      mode: str = "dense",
                      parallel_size: int | None = None,
                      num_microbatches: int = 4) -> list[list[float]]:
        """Offline batch scoring (perplexity / reranking): per-token
        log p(prompt[i] | prompt[:i]) from one forward of the engine's
        weights at the model's precision, with no KV pools and no serving
        state (`engine/scoring.py`). Distinct from
        `add_request(prompt_logprobs=True)`, which scores through the
        quantized serving path. Mode "pp" / "sp" run the pipeline / ring
        forward over a line of the world's ranks, every rank calling this
        with the same arguments (`scoring.score_prompts`). On a mesh engine
        "dense" runs the forward with the serving path's collectives, and
        "pp" / "sp" raise ValueError: they would lay a second mesh over the
        ranks the engine's (dp, ep, tp) mesh occupies and need the whole
        tree where each rank holds its shard."""
        if mode in ("pp", "sp") and self.mesh is not None:
            raise ValueError(
                f"score_prompts(mode={mode!r}) is not available on a "
                f"mesh-sharded engine: it would build a second {mode!r} line "
                f"over the ranks the engine's (dp, ep, tp) = "
                f"{(self.mesh.dp, self.mesh.ep, self.mesh.tp)} mesh occupies, "
                f"from the whole tree where each rank holds its shard. Use "
                f"mode='dense' here, or score pp / sp from an engine without "
                f"a mesh")
        return scoring.score_prompts(self.params, self.model_config, prompts,
                                     mode=mode, parallel_size=parallel_size,
                                     num_microbatches=num_microbatches)

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
        live = [*self.scheduler.running.values(),
                *(st.req for st in self._streams.values())]
        for r in live:
            scheme = self._req_scheme(r)
            k = (KVDtype.MIXED8 if isinstance(scheme, tuple) else scheme).value
            scheme_tokens[k] = scheme_tokens.get(k, 0) + r.num_tokens
        eng.update(self._round_statistics())
        return {
            "engine": eng,
            "kv_scheme_current": self._kv_scheme.value,
            "kv_scheme_live_tokens": scheme_tokens,
            **({"spec": self.spec.get_statistics().as_dict()}
               if self.spec is not None else {}),
            "phases": self.timers.summary(),
            "scheduler": self.scheduler.get_statistics().as_dict(),
            "prefetch": self.prefetcher.get_statistics().as_dict(),
            "prefetch_depth": self.prefetcher.depth,
            **self.kvc.get_statistics(),
            **({"mesh": self._mesh_statistics()} if self.mesh is not None
               else {}),
        }

    def _round_statistics(self) -> dict:
        """How the decode rounds were dispatched: replayed CUDA graphs, or
        eager (on the CPU, on a mesh rank)."""
        if self.round_graphs is not None:
            out = self.round_graphs.statistics()
            draft = getattr(self.spec, "graphs", None)
            if draft is not None:
                # the draft model's proposals, its own cache
                out.update({f"draft_{k}": v for k, v in
                            draft.statistics().items() if k != "round_route"})
            return out
        return {"round_route": "eager: " + (
                    "mesh" if self.mesh is not None else self.device.type),
                "graph_rounds": 0, "eager_rounds": self._eager_rounds,
                "graph_captures": 0, "graph_capture_ms": 0.0,
                "graphs_held": 0, "graph_drops": 0, "graph_pool_bytes": 0}

    def _mesh_statistics(self) -> dict:
        """The rank's place, the scope of the cache's byte counts (this
        rank's kv heads) beside the whole mesh's, and the collectives."""
        c = self.model_config
        per_rank = self.kvc.compression_statistics()[
            "bytes_per_token_per_layer"]
        return {"dp": self.mesh.dp, "ep": self.mesh.ep, "tp": self.mesh.tp,
                "rank": self.mesh.rank, "backend": self.mesh.backend,
                "kv_heads_here": self.kvc.kv_heads,
                "kv_heads_model": c.num_kv_heads,
                "cache_bytes_scope": "rank",
                "bytes_per_token_per_layer_rank": per_rank,
                "bytes_per_token_per_layer_mesh": per_rank * self.mesh.tp,
                "collectives": self.mesh.stats()}

    def reset_statistics(self) -> None:
        self.stats.reset()
        self._eager_rounds = 0
        for graphs in (self.round_graphs, getattr(self.spec, "graphs", None)):
            if graphs is not None:
                graphs.reset_statistics()
        self.scheduler.reset_statistics()
        self.prefetcher.reset_statistics()
        self.kvc.reset_statistics()
