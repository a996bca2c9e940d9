"""Speculative decoding: a draft model or prompt lookup proposes `gamma`
tokens a lane, the target scores all gamma + 1 positions in ONE
`verify_step` over the paged quantized cache (K2 at T = gamma + 1), and
acceptance runs on the device where the logits were produced; the host
copies one [2, B] int tensor a round, never the [B, gamma + 1, V] logits.

Counterpart of `cxl_speckv_tpu/engine/spec.py`:

- temperature-0 lanes: greedy token match, so the emitted text is the
  target's greedy decoding;
- sampled lanes: the speculative-sampling rule on nucleus-filtered p and q
  (accept draft t_j with probability min(1, p(t_j) / q(t_j)), on rejection
  resample from the normalized residual max(p - q, 0), a bonus token from
  the target on full acceptance), so the emitted law is plain target
  sampling. Random draws take an explicit `torch.Generator`, not JAX's
  threefry bits: sampled lanes agree with the JAX package in distribution.

Speculative KV needs no rollback: both models append KV for every proposed
position; rows past the accepted prefix are never covered by the sequence
length and the next round overwrites them.

With `logprobs_k`, `verify_accept` also returns the emitted tokens' raw
logprobs and top-k tables: verify row j is the target's distribution for
the token emitted at round index j, so the emitted-token matrix (accepted
drafts, then the correction or bonus at row n_acc) is built on the device
from the verdict and scored there, and the tables cross with the verdict
in one host copy.

The draft's KV lives in its own pool sized for the whole logical block
space (`cache.total_blocks`, + a guard slot), in the port's token-major
layout; it never tiers, only target KV migrates. Draft slots follow the
target's logical blocks: prefix sharing, frees and window retirement.

On a mesh engine a draft whose axes divide tp comes cut for the mesh
(`parallel/sharding.py`) and its pool holds this rank's kv heads
(`kv_heads`); the model functions then issue its collectives as the
target's. Another draft is served whole on every rank. Every pass returns
the whole batch's results on every rank, so the JAX package's `fetch_mesh`
(a replicating fetch of sharded outputs) has no counterpart here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cxl_speckv_tpu_torch.config import KVDtype
from cxl_speckv_tpu_torch.core.stats import Statistics, ratio
from cxl_speckv_tpu_torch.engine.sampling import encode_sampling, nucleus_filter
from cxl_speckv_tpu_torch.models.configs import LlamaConfig
from cxl_speckv_tpu_torch.models.llama import (
    _token_logprobs,
    decode_multi_packed,
    prefill_batch_packed,
    prefill_chunk,
    verify_step,
)
from cxl_speckv_tpu_torch.ops.quant import kv_pack, kv_storage_dtype
from cxl_speckv_tpu_torch.utils.host import fetch


def _gumbel_argmax(logp: torch.Tensor, generator) -> torch.Tensor:
    """A categorical draw per row of log-probabilities (Gumbel-max, as
    `engine.sampling.sample_tokens` draws)."""
    u = torch.rand(logp.shape, generator=generator, device=logp.device)
    return (logp - torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))).argmax(-1)


def accept_core(target_logits: torch.Tensor, draft_logits: torch.Tensor | None,
                drafts: torch.Tensor, temps: torch.Tensor, top_ps: torch.Tensor,
                generator: torch.Generator | None, *, gamma: int,
                sampled: bool = True, nucleus: bool | None = None):
    """Per-lane acceptance on the logits' device. target_logits
    [B, gamma + 1, V] (row j scores drafts[:, j]; the last row is the bonus
    position), draft_logits [B, gamma, V] (the distributions the drafts
    were drawn from), drafts [B, gamma] int, temps [B] float32 (<= 0
    greedy), top_ps [B] (0 or >= 1 off). Returns (n_acc [B], final [B])
    int32: a lane emits drafts[:n_acc] + [final].

    `draft_logits=None` means deterministic proposals (n-gram lookup): q is
    the one-hot at the drafts, so a draft is accepted with probability
    p(t_j) and the residual is p with t_j removed, computed without a
    [B, gamma, V] proposal tensor. `sampled=False` promises that every
    lane is greedy: only the token-match rule runs, with no draw (the
    greedy lanes' result is the same either way). `nucleus` says whether
    some sampled lane uses top-p, as the JAX package's `lax.cond` decides
    on the device; None computes it from the tensors (a host sync on the
    card)."""
    preds = target_logits.argmax(-1)                          # [B, g+1]
    greedy_acc = preds[:, :gamma] == drafts
    run = torch.cumprod(greedy_acc.int(), dim=1)
    n_greedy = run.sum(dim=1)
    greedy_final = torch.gather(preds, 1, n_greedy[:, None].long())[:, 0]
    if not sampled:
        return n_greedy.int(), greedy_final.int()

    eps = 1e-20
    onehot_q = draft_logits is None
    if nucleus is None:
        nucleus = bool(((top_ps > 0) & (top_ps < 1) & (temps > 0)).any())
    t = torch.clamp_min(temps, 1e-6)[:, None, None]
    p = torch.softmax(target_logits[:, :gamma] / t, dim=-1)   # [B, g, V]
    q = None if onehot_q else torch.softmax(draft_logits / t, dim=-1)
    # top-p lanes: the rule runs on the nucleus-filtered p and q (the draft
    # was drawn from filtered q); a one-hot q is a fixed point of the
    # filter, so deterministic proposals filter p alone
    if nucleus:
        p = nucleus_filter(p, top_ps[:, None])
        if q is not None:
            q = nucleus_filter(q, top_ps[:, None])
    d = drafts.long()[..., None]
    pt = torch.gather(p, -1, d)[..., 0]                       # [B, g]
    qt = torch.ones_like(pt) if onehot_q else torch.gather(q, -1, d)[..., 0]
    u = torch.rand(drafts.shape, generator=generator, device=p.device)
    samp_acc = u * qt <= pt          # accept iff u <= p(t) / q(t); q(t) > 0
    acc = torch.where(temps[:, None] <= 0.0, greedy_acc, samp_acc)
    n_acc = torch.cumprod(acc.int(), dim=1).sum(dim=1)        # [B]
    idx = torch.clamp_max(n_acc, gamma - 1).long()
    rows = torch.arange(p.shape[0], device=p.device)
    p_at = p[rows, idx]                                       # [B, V]
    if onehot_q:
        q_at = torch.zeros_like(p_at)
        q_at[rows, drafts.long()[rows, idx]] = 1.0
    else:
        q_at = q[rows, idx]
    resid = torch.clamp_min(p_at - q_at, 0.0)
    rs = resid.sum(-1, keepdim=True)
    # the residual vanishes only where p == q at that position: fall back to p
    resid = torch.where(rs > eps, resid / torch.clamp_min(rs, eps), p_at)
    bonus = torch.softmax(target_logits[:, gamma] / t[:, :, 0], dim=-1)
    if nucleus:
        bonus = nucleus_filter(bonus, top_ps)
    dist = torch.where((n_acc >= gamma)[:, None], bonus, resid)
    sampled_final = _gumbel_argmax(torch.log(dist + eps), generator)
    # a greedy lane's n_acc is its token-match count: its final is the same
    final = torch.where(temps <= 0.0, greedy_final, sampled_final)
    return n_acc.int(), final.int()


def emitted_logprobs(logits: torch.Tensor, drafts: torch.Tensor,
                     n_acc: torch.Tensor, final: torch.Tensor, k: int):
    """The raw logprob tables of a round's emitted tokens, on the device:
    row j of the token matrix holds draft j while j < n_acc, the
    correction or bonus `final` at j == n_acc, then 0 (JAX
    `_verify_accept_program`); `_token_logprobs` scores it against the
    verify logits [B, gamma + 1, V]. Returns (chosen [B, gamma + 1], ids,
    logprobs [B, gamma + 1, k])."""
    B, g = drafts.shape
    j = torch.arange(g + 1, device=logits.device)[None, :]
    drafts_p = torch.cat([drafts.to(torch.int32),
                          torch.zeros(B, 1, dtype=torch.int32,
                                      device=logits.device)], dim=1)
    n = n_acc[:, None].to(torch.int32)
    tok = torch.where(j == n, final[:, None].to(torch.int32), drafts_p)
    tok = torch.where(j > n, torch.zeros_like(tok), tok)
    return _token_logprobs(logits, tok, k)


@dataclass
class SpecStatistics(Statistics):
    rounds: int = 0
    drafted: int = 0
    accepted: int = 0
    bonus: int = 0
    fallback_seeded: int = 0   # lookup misses seeded by a fallback proposer

    @property
    def acceptance_rate(self) -> float:
        return ratio(self.accepted, self.drafted)

    def as_dict(self) -> dict:
        d = super().as_dict()
        d["acceptance_rate"] = self.acceptance_rate
        d["tokens_per_round"] = ratio(self.accepted + self.bonus, self.rounds)
        return d


class _AcceptanceMixin:
    """Verify / accept machinery shared by both proposal sources.
    Subclasses provide `gamma`, `stats`, and set `self._draft_logits`
    ([B, gamma, V] on the device, or None for deterministic proposals)
    in `propose`."""

    def _emit(self, drafts: np.ndarray, n_acc: np.ndarray,
              final: np.ndarray, active) -> list[list[int]]:
        emitted: list[list[int]] = []
        for b in range(drafts.shape[0]):
            if not active[b]:
                emitted.append([])
                continue
            j = int(n_acc[b])
            emitted.append([int(x) for x in drafts[b, :j]] + [int(final[b])])
            self.stats.accepted += j
            self.stats.bonus += 1
        self.stats.rounds += 1
        return emitted

    def _accept_on_device(self, logits: torch.Tensor, drafts_d, drafts,
                          active, temps, top_ps, generator, logprobs_k=0):
        """`accept_core` where the logits are, then ONE host copy of the
        [2, B] verdict (with `logprobs_k`, of the emitted tokens' logprob
        tables beside it: `emitted_logprobs`); the statistics count the
        round. Returns (emitted, n_acc, tables or None)."""
        temps = np.asarray(temps, np.float32)
        top_ps = (np.zeros_like(temps) if top_ps is None
                  else np.asarray(top_ps, np.float32))
        sampled = bool((temps > 0).any())
        nucleus = sampled and bool(
            ((top_ps > 0) & (top_ps < 1) & (temps > 0)).any())
        floats = torch.from_numpy(np.stack([temps, top_ps])).to(logits.device)
        n_acc, final = accept_core(logits, self._draft_logits, drafts_d,
                                   floats[0], floats[1], generator,
                                   gamma=self.gamma, sampled=sampled,
                                   nucleus=nucleus)
        verdict = torch.stack([n_acc, final])
        if logprobs_k:
            (n_acc, final), *tables = fetch(verdict, *emitted_logprobs(
                logits, drafts_d, n_acc, final, logprobs_k))
        else:
            (n_acc, final), tables = verdict.cpu().numpy(), None
        return self._emit(drafts, n_acc, final, active), n_acc, tables

    def accept(self, drafts: np.ndarray, target_logits: torch.Tensor,
               active: np.ndarray, temps: np.ndarray,
               generator: torch.Generator | None = None,
               top_ps: np.ndarray | None = None
               ) -> tuple[list[list[int]], np.ndarray]:
        """Acceptance for target_logits [B, gamma + 1, V] that stay on their
        device: greedy token match for temperature-0 lanes, speculative
        sampling for the rest (`accept_core`). Returns (emitted tokens per
        lane, accepted counts [B])."""
        drafts_d = torch.from_numpy(np.asarray(drafts, np.int32)).to(
            target_logits.device)
        return self._accept_on_device(target_logits, drafts_d, drafts,
                                      active, temps, top_ps, generator)[:2]

    def verify_accept(self, params, config, kv_dtype,
                      verify_tokens: np.ndarray, positions: np.ndarray,
                      pools, block_tables: np.ndarray, active: np.ndarray,
                      drafts: np.ndarray, temps: np.ndarray,
                      generator: torch.Generator | None = None, *,
                      top_ps: np.ndarray | None = None, logprobs_k: int = 0):
        """One spec round's tail: the target's `verify_step` (pools update
        in place; the round's int inputs cross in one int32 array), then
        the acceptance on its logits where they are. Returns (emitted
        tokens per lane, n_acc [B], and with `logprobs_k` the emitted
        tokens' (chosen [B, gamma + 1], top_ids / top_logprobs
        [B, gamma + 1, k]) tables, else None)."""
        T = verify_tokens.shape[1]
        ints = torch.from_numpy(np.concatenate(
            [verify_tokens, np.asarray(positions)[:, None],
             np.asarray(active)[:, None], block_tables],
            axis=1).astype(np.int32)).to(pools[0].device)
        logits = verify_step(params, config, kv_dtype, ints[:, :T],
                             ints[:, T], pools, ints[:, T + 2:],
                             ints[:, T + 1] != 0)
        return self._accept_on_device(logits, ints[:, 1:T], drafts, active,
                                      temps, top_ps, generator, logprobs_k)

    def accept_greedy(self, drafts: np.ndarray, target_logits: np.ndarray,
                      active: np.ndarray) -> tuple[list[list[int]], np.ndarray]:
        """Greedy acceptance on host logits (for tests and tools; the engine
        path is `verify_accept`): the leading drafts that match the
        target's argmax, then its argmax after them (the correction, or the
        bonus on full acceptance)."""
        pred = np.asarray(target_logits).argmax(-1)             # [B, T]
        match = np.cumprod(pred[:, :self.gamma] == drafts, axis=1)
        n_acc = np.where(active, match.sum(axis=1), 0).astype(np.int32)
        final = pred[np.arange(len(n_acc)), n_acc]
        return self._emit(drafts, n_acc, final, active), n_acc

    def get_statistics(self) -> SpecStatistics:
        return self.stats

    def reset_statistics(self) -> None:
        self.stats.reset()


class SpecDecoder(_AcceptanceMixin):
    """Owns the draft model's cache and its propose step."""

    has_draft_model = True

    def __init__(self, draft_config: LlamaConfig, draft_params, target_kvc,
                 gamma: int = 4, draft_kv_dtype: KVDtype = KVDtype.BF16,
                 kv_heads: int | None = None, graphs=None):
        """`graphs`: a `models.round_graph.RoundGraphs` of the draft's own,
        in which `propose` replays its captured rounds (None: eager)."""
        self.config = draft_config
        self.graphs = graphs
        self.params = draft_params
        self.kvc = target_kvc
        self.gamma = gamma
        self.kv_dtype = KVDtype(draft_kv_dtype)
        cache = target_kvc.config
        c = draft_config
        n_slots = cache.total_blocks + 1  # every logical block fits; + guard
        # the port's pool layout (`runtime/kv_cache.py:_alloc_storage`)
        shape = (c.num_layers, n_slots, kv_heads or c.num_kv_heads,
                 cache.block_size,
                 c.head_dim // kv_pack(self.kv_dtype))
        elem, dev = kv_storage_dtype(self.kv_dtype), target_kvc.device
        self.pools = (torch.zeros(shape, dtype=elem, device=dev),
                      torch.zeros(shape, dtype=elem, device=dev),
                      torch.ones(shape[:-1], dtype=torch.float32, device=dev),
                      torch.ones(shape[:-1], dtype=torch.float32, device=dev))
        self.guard_slot = n_slots - 1
        self._free = list(range(n_slots - 2, -1, -1))
        self._slot_of_bid: dict[int, int] = {}
        tab = target_kvc.pool.table
        self.table = np.full((tab.max_seqs, tab.max_blocks_per_seq),
                             self.guard_slot, np.int32)
        self.stats = SpecStatistics()
        self.prefill_dispatches = 0     # draft prefill passes launched
        self._draft_logits = None

    # -- bookkeeping ---------------------------------------------------------

    def sync_seq(self, seq_slot: int) -> None:
        """Assign draft slots for newly allocated logical blocks. A
        prefix-shared bid already has a slot (holding the draft KV the
        original prefill wrote: the same tokens at the same positions), and
        the claimer's table row maps to it."""
        for i, bid in enumerate(self.kvc.pool.seq(seq_slot).blocks):
            if bid is None:
                continue
            slot = self._slot_of_bid.get(bid)
            if slot is None:
                slot = self._free.pop()
                self._slot_of_bid[bid] = slot
            self.table[seq_slot, i] = slot

    def on_free_seq(self, seq_slot: int, bids: list[int]) -> None:
        """Called after the target pool freed the sequence, so
        `pool.is_live(bid)` is true exactly when a prefix-shared block
        survives in another holder: its draft slot stays."""
        for bid in bids:
            if self.kvc.pool.is_live(bid):
                continue
            slot = self._slot_of_bid.pop(bid, None)
            if slot is not None:
                self._free.append(slot)
        self.table[seq_slot, :] = self.guard_slot

    def retire_blocks(self, seq_slot: int, freed: list[tuple[int, int]]) -> None:
        """Release the draft slots of target blocks that a sliding window
        retired (only the named table entries reset; the sequence lives)."""
        for i, bid in freed:
            if not self.kvc.pool.is_live(bid):
                slot = self._slot_of_bid.pop(bid, None)
                if slot is not None:
                    self._free.append(slot)
            self.table[seq_slot, i] = self.guard_slot

    # -- model steps ---------------------------------------------------------

    def prefill(self, seq_slot: int, tokens: torch.Tensor, start_pos: int,
                valid_len: int) -> None:
        """One sequence's (maybe right-padded) chunk into the draft cache."""
        self.sync_seq(seq_slot)
        dev = self.pools[0].device
        prefill_chunk(self.params, self.config, self.kv_dtype, tokens.to(dev),
                      start_pos, self.pools,
                      torch.from_numpy(self.table[seq_slot]).to(dev),
                      valid_len)
        self.prefill_dispatches += 1

    def prefill_batch(self, lanes, *, chunk: int, batch: int) -> None:
        """Mirror a prefill wave into the draft cache in ONE pass (the
        target's batched prefill, `prefill_batch_packed`).
        lanes: [(seq_slot, start, n, tokens)] with len(tokens) == n."""
        if not lanes:
            return
        mb = self.table.shape[1]
        packed = np.zeros((batch, 4 + mb + chunk), np.int32)
        packed[:, 4:4 + mb] = self.guard_slot
        for i, (seq_slot, start, n, tokens) in enumerate(lanes):
            self.sync_seq(seq_slot)
            packed[i, 0] = start
            packed[i, 1] = n
            packed[i, 4:4 + mb] = self.table[seq_slot]
            packed[i, 4 + mb:4 + mb + n] = tokens
        prefill_batch_packed(self.params, self.config, self.kv_dtype, packed,
                             self.pools, max_blocks=mb)
        self.prefill_dispatches += 1

    def propose(self, last_tokens: np.ndarray, positions: np.ndarray,
                tables: np.ndarray, active: np.ndarray,
                temps: np.ndarray | None = None,
                top_ps: np.ndarray | None = None,
                rng_counter: int = 0) -> np.ndarray:
        """Draft gamma tokens a lane in one fused decode of horizon
        gamma + 1 (`decode_multi_packed`): the feed chain (last, d_1, ...,
        d_gamma) is the draft chain (greedy for temperature-0 lanes,
        sampled otherwise), and the extra step appends d_gamma's KV, so the
        draft cache covers position n - 1 + gamma, where the next round
        starts on full acceptance. last_tokens [B] (KV not yet appended),
        positions [B] their positions. Returns drafts [B, gamma]; the
        per-step logits stay on the device (`_draft_logits`) for the
        acceptance rule."""
        B = last_tokens.shape[0]
        mb = tables.shape[1]
        packed = np.zeros((B, mb + 4), np.int32)
        packed[:, 0] = last_tokens
        packed[:, 1] = positions
        if temps is not None:
            tp = np.ones_like(temps) if top_ps is None else np.asarray(top_ps)
            packed[:, 2] = [encode_sampling(float(t), float(pp))
                            for t, pp in zip(temps, tp)]
        packed[:, 3] = rng_counter
        packed[:, 4:] = tables
        toks, logits = decode_multi_packed(
            self.params, self.config, self.kv_dtype, packed, self.pools,
            horizon=self.gamma + 1, return_logits=True, graphs=self.graphs)
        # a replayed round's logits are the graph's tensor, which its next
        # replay overwrites
        logits = logits[:, :self.gamma]                        # [B, g, V]
        self._draft_logits = (logits.clone() if self.graphs is not None
                              else logits)
        drafts = toks[:, :self.gamma].cpu().numpy().astype(np.int32)
        self.stats.drafted += int(np.asarray(active).sum()) * self.gamma
        return drafts


class NgramProposer(_AcceptanceMixin):
    """Draft-model-free speculation: prompt-lookup (n-gram) proposals.

    Searches the lane's own history (prompt + output) for the most recent
    earlier occurrence of its `max_match`-token suffix (then shorter
    suffixes, down to `min_match`) and proposes the `gamma` tokens that
    followed it. Greedy lanes stay token-identical to plain decoding, and
    sampled lanes keep the target law through the one-hot q
    (`accept_core` with draft_logits=None). There is no draft model and no
    draft cache: the bookkeeping hooks do nothing, and `table` is an
    all-zeros placeholder the engine packs without reading.
    """

    has_draft_model = False
    prefill_dispatches = 0      # no draft cache, no draft prefill

    def __init__(self, target_kvc, vocab_size: int, gamma: int = 4,
                 max_match: int = 3, min_match: int = 1):
        if max_match < min_match or min_match < 1:
            raise ValueError("need max_match >= min_match >= 1")
        self.gamma = gamma
        self.vocab = vocab_size
        self.max_match = max_match
        self.min_match = min_match
        self.guard_slot = 0
        tab = target_kvc.pool.table
        self.table = np.zeros((tab.max_seqs, tab.max_blocks_per_seq),
                              np.int32)
        self.stats = SpecStatistics()
        self._draft_logits = None

    # no draft cache: the bookkeeping hooks do nothing
    def sync_seq(self, seq_slot: int) -> None:
        pass

    def on_free_seq(self, seq_slot: int, bids: list[int]) -> None:
        pass

    def retire_blocks(self, seq_slot: int, freed: list[tuple[int, int]]) -> None:
        pass

    def prefill(self, *args, **kwargs) -> None:
        pass

    def prefill_batch(self, *args, **kwargs) -> None:
        pass

    def lookup(self, hist: list[int]) -> list[int]:
        """Longest-suffix prompt lookup: the continuation (<= gamma tokens)
        of the most recent earlier occurrence of the history's suffix, or
        [] when no suffix of length in [min_match, max_match] recurs."""
        n = len(hist)
        if n < self.min_match + 1:
            return []
        arr = np.asarray(hist, np.int32)
        for m in range(min(self.max_match, n - 1), self.min_match - 1, -1):
            suffix = arr[n - m:]
            num = n - m  # candidate windows [0, n-m); the suffix itself excluded
            idx = np.arange(num)[:, None] + np.arange(m)[None, :]
            starts = np.nonzero((arr[idx] == suffix).all(axis=1))[0]
            if starts.size == 0:
                continue
            s = int(starts[-1])  # the most recent occurrence wins
            return arr[s + m: s + m + self.gamma].tolist()
        return []

    def propose(self, last_tokens: np.ndarray, positions: np.ndarray,
                tables: np.ndarray, active: np.ndarray,
                temps: np.ndarray | None = None,
                top_ps: np.ndarray | None = None,
                rng_counter: int = 0,
                histories: list[list[int]] | None = None,
                fallback=None) -> np.ndarray:
        """Host-side proposal (nothing runs on the device). A lane whose
        lookup misses drafts a repeat of its last token: the verify pass
        costs the same, and the correction still emits one true token.

        `fallback(miss_lanes) -> [len(miss)] int` (optional) supplies a
        better miss draft; negative entries keep the repeat. Proposals are
        heuristic, never correctness."""
        B = last_tokens.shape[0]
        drafts = np.tile(np.asarray(last_tokens, np.int32)[:, None],
                         (1, self.gamma))
        miss = []
        for i in range(B):
            if not active[i] or histories is None or i >= len(histories):
                continue
            got = self.lookup(histories[i])
            if got:
                drafts[i, :len(got)] = got
            else:
                miss.append(i)
        if miss and fallback is not None:
            fb = np.asarray(fallback(miss), np.int32)
            for j, i in enumerate(miss):
                if 0 <= fb[j] < self.vocab:
                    drafts[i, :] = fb[j]
                    self.stats.fallback_seeded += 1
        # deterministic proposals: q is the one-hot at the drafts, which
        # `accept_core` computes from `drafts` alone
        self._draft_logits = None
        self.stats.drafted += int(np.asarray(active).sum()) * self.gamma
        return drafts
