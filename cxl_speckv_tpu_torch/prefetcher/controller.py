"""Prefetch controller: schedule lookahead, gated and ranked by the LSTM.

Counterpart of `cxl_speckv_tpu/prefetcher/controller.py`. Each engine step
`plan` preloads the host-resident blocks of the sequences scheduled in the
next `depth` groups of the oversubscribed round-robin (decode reads every
block of a scheduled sequence, so the unit of prediction is a sequence's
next turn), skipping blocks already in HBM. With a predictor
(`prefetcher/lstm.py`) each sequence's 16-token history gives the
probability that it goes on (not EOS): a sequence below 0.5 is about to
finish and is skipped, and within each schedule group the transfer budget
flows to the sequences most likely to go on.

The probabilities come from three places, freshest first: the decode
round's in-round leg (`install_pcont`, after the round's tokens are
observed), a refresh once a sequence has `pcont_refresh` new observations
(on the single worker thread it shares with training when `train_async`,
landing the next tick; synchronous otherwise), and 1.0 for a sequence never
predicted. With `train_online` the predictor trains on replayed (history,
next token) pairs every `train_interval` ticks, at the full `train_batch`
only; the replay indices come from a numpy generator the controller owns,
seeded by its caller.

Mispredicted prefetches are never rolled back: they age out through LRU
eviction and the directory counts them `prefetch_wasted`. Adaptive depth
ports the reference policy: a sliding window of prefetch outcomes, depth + 1
above `raise_threshold` (cap `max_depth`), depth - 1 below
`lower_threshold` (floor `min_depth`).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass

import numpy as np

from cxl_speckv_tpu_torch.config import PrefetchConfig
from cxl_speckv_tpu_torch.core.stats import Statistics, ratio
from cxl_speckv_tpu_torch.prefetcher.lstm import LSTMPredictor
from cxl_speckv_tpu_torch.runtime.kv_cache import TieredKVCache


@dataclass
class PrefetchStatistics(Statistics):
    plans: int = 0
    prefetches_issued: int = 0
    skipped_resident: int = 0       # "already in HBM" skips
    skipped_eos_predicted: int = 0  # the LSTM says the sequence is ending
    depth_raises: int = 0
    depth_lowers: int = 0
    predict_latency_ms: float = 0.0
    train_steps: int = 0
    last_train_loss: float = 0.0
    # continue probabilities computed inside the decode round
    ingraph_pcont: int = 0

    def as_dict(self) -> dict:
        d = super().as_dict()
        d["avg_predict_latency_ms"] = ratio(self.predict_latency_ms, self.plans)
        return d


class PrefetchController:
    def __init__(self, config: PrefetchConfig, kvc: TieredKVCache,
                 predictor: LSTMPredictor | None = None,
                 eos_token_id: int | None = None, seed: int = 0):
        self.config = config
        self.kvc = kvc
        self.predictor = predictor
        self.eos_token_id = eos_token_id
        self.depth = config.depth
        self._histories: dict[int, deque[int]] = {}
        self._window: deque[bool] = deque(maxlen=config.accuracy_window)
        self._last_hits = 0
        self._last_wasted = 0
        # replay buffer of (history window, next token) for online training
        self._replay: deque[tuple[tuple[int, ...], int]] = deque(
            maxlen=config.replay_capacity)
        self._rng = np.random.RandomState(seed)
        self._ticks = 0
        # seq -> observation count, and seq -> (count when predicted, p)
        self._hist_version: dict[int, int] = {}
        self._pcont: dict[int, tuple[int, float]] = {}
        self._last_loss: float | None = None
        self._train_future = None
        self._train_executor = None
        self._pcont_future = None   # (seqs, versions, future) in flight
        self.stats = PrefetchStatistics()

    def warmup(self) -> None:
        """Run the predictor at serving shapes before the first request."""
        if self.predictor is not None:
            self.predictor.warmup(
                train_batch=(self.config.train_batch
                             if self.config.train_online else None))

    # -- history (a sliding window of history_len tokens a sequence) ---------

    def observe_tokens(self, seq_slot: int, tokens) -> None:
        h = self._histories.setdefault(
            seq_slot, deque(maxlen=self.config.history_len))
        collect = self.config.train_online and self.predictor is not None
        for t in np.atleast_1d(np.asarray(tokens)):
            t = int(t)
            if collect and len(h) >= 2:
                self._replay.append((tuple(h), t))
            h.append(t)
        self._hist_version[seq_slot] = self._hist_version.get(seq_slot, 0) + 1

    def forget_seq(self, seq_slot: int) -> None:
        self._histories.pop(seq_slot, None)
        self._hist_version.pop(seq_slot, None)
        self._pcont.pop(seq_slot, None)

    def history_matrix(self, seq_slots: list[int]) -> np.ndarray:
        """[len(seq_slots), history_len] int32, left-padded with 0."""
        T = self.config.history_len
        out = np.zeros((len(seq_slots), T), np.int32)
        for i, s in enumerate(seq_slots):
            h = list(self._histories.get(s, ()))
            if h:
                out[i, T - len(h):] = h[-T:]
        return out

    def history_matrix_bucketed(self, seq_slots: list[int],
                                pad_rows: int = 0) -> np.ndarray:
        """The history matrix in the predictor's classes, zero rows added
        up to `pad_rows`: the decode round's in-round leg reads it."""
        m = self.history_matrix(seq_slots)
        if self.predictor is not None:
            m = self.predictor._bucket(m)
        if pad_rows > len(seq_slots):
            m = np.concatenate(
                [m, np.zeros((pad_rows - len(seq_slots), m.shape[1]),
                             np.int32)])
        return m

    def install_pcont(self, seq_slots: list[int], probs) -> None:
        """Install the decode round's continue probabilities. Called after
        the round's `observe_tokens`, so that they count as fresh and
        `plan` refreshes none of these lanes; finished lanes (their
        histories gone) are skipped."""
        for s, p in zip(seq_slots, np.atleast_1d(np.asarray(probs))):
            if s in self._histories:
                self._pcont[s] = (self._hist_version.get(s, 0), float(p))
                self.stats.ingraph_pcont += 1

    # -- the per-step plan ------------------------------------------------------

    def plan(self, upcoming: list[list[int]]) -> int:
        """Preload host-resident blocks of sequences scheduled in the next
        `depth` groups (`upcoming`: the future schedule, nearest first).
        Returns the number of block prefetches issued."""
        if not self.config.enabled:
            return 0
        self.stats.plans += 1
        groups = upcoming[: self.depth]
        seqs = [s for g in groups for s in g]
        if not seqs:
            return 0

        keep = seqs
        if self.predictor is not None and self.eos_token_id is not None:
            t0 = time.monotonic()
            # a prediction is refreshed after pcont_refresh new observations
            thresh = max(1, self.config.pcont_refresh)
            stale = [s for s in seqs
                     if s not in self._pcont
                     or (self._hist_version.get(s, 0)
                         - self._pcont[s][0]) >= thresh]
            if stale and self.config.train_async:
                # on the worker: this plan uses the last known values, the
                # new ones land at a later tick
                self._harvest_pcont()
                if self._pcont_future is None:
                    versions = {s: self._hist_version.get(s, 0)
                                for s in stale}
                    hist = self.history_matrix(stale)
                    self._pcont_future = (stale, versions, self._worker()
                                          .submit(self._predict_pcont, hist))
            elif stale:
                p_new = self.predictor.continue_probability(
                    self.history_matrix(stale), self.eos_token_id)
                for s, pc in zip(stale, p_new):
                    self._pcont[s] = (self._hist_version.get(s, 0), float(pc))
            self.stats.predict_latency_ms += (time.monotonic() - t0) * 1e3
            keep = []
            for s in seqs:
                if self._pcont.get(s, (0, 1.0))[1] >= 0.5:
                    keep.append(s)
                else:
                    self.stats.skipped_eos_predicted += 1
            # within a group, the budget goes to the likeliest to go on
            group_of = {s: gi for gi, g in enumerate(groups) for s in g}
            keep.sort(key=lambda s: (group_of[s],
                                     -self._pcont.get(s, (0, 1.0))[1]))

        issued = 0
        budget = self.config.max_inflight - self.kvc.transfer.queued
        for s in keep:
            if budget <= 0:
                break
            missing = self.kvc.seq_nonresident_blocks(s)
            total_blocks = len(self.kvc.pool.seq(s).blocks)
            self.stats.skipped_resident += total_blocks - len(missing)
            n = self.kvc.prefetch_blocks(missing[:budget])
            issued += n
            budget -= n
        self.stats.prefetches_issued += issued
        return issued

    # -- adaptive depth -------------------------------------------------------

    def update_depth(self) -> int:
        st = self.kvc.directory.get_statistics()
        new_hits = st.prefetch_hits - self._last_hits
        new_wasted = st.prefetch_wasted - self._last_wasted
        self._last_hits, self._last_wasted = st.prefetch_hits, st.prefetch_wasted
        self._window.extend([True] * new_hits)
        self._window.extend([False] * new_wasted)
        if len(self._window) >= self.config.accuracy_window // 2:
            acc = sum(self._window) / len(self._window)
            if acc > self.config.raise_threshold and self.depth < self.config.max_depth:
                self.depth += 1
                self.stats.depth_raises += 1
            elif acc < self.config.lower_threshold and self.depth > self.config.min_depth:
                self.depth -= 1
                self.stats.depth_lowers += 1
        return self.depth

    # -- online training --------------------------------------------------------

    def maybe_train(self) -> float | None:
        """Every `train_interval` ticks, one training step on `train_batch`
        replayed pairs (none until the buffer holds that many). With
        `train_async` the step runs on the worker and this returns None at
        once (a step still running skips the tick); otherwise it runs here
        and its loss is returned."""
        if not (self.config.train_online and self.predictor is not None):
            return None
        self._ticks += 1
        if self._ticks % self.config.train_interval:
            return None
        if self._train_future is not None:
            if not self._train_future.done():
                return None
            self._harvest_train()
        n = self.config.train_batch
        if len(self._replay) < n:
            return None
        idx = self._rng.randint(0, len(self._replay), n)
        T = self.config.history_len
        H = np.zeros((n, T), np.int32)
        y = np.zeros(n, np.int32)
        for i, j in enumerate(idx):
            hist, t = self._replay[j]
            H[i, T - len(hist):] = hist[-T:]
            y[i] = t
        if self.config.train_async:
            self._train_future = self._worker().submit(
                self.predictor.train_batch, H, y)
            return None
        loss = self.predictor.train_batch(H, y)
        self.stats.train_steps += 1
        self._last_loss = loss
        return loss

    def _predict_pcont(self, hist):
        return self.predictor.continue_probability(hist, self.eos_token_id)

    def _harvest_pcont(self) -> None:
        if self._pcont_future is None:
            return
        seqs, versions, fut = self._pcont_future
        if not fut.done():
            return
        self._pcont_future = None
        for s, pc in zip(seqs, fut.result()):
            if s in versions:
                self._pcont[s] = (versions[s], float(pc))

    def _worker(self):
        """The one worker thread that trains and refreshes predictions."""
        if self._train_executor is None:
            from concurrent.futures import ThreadPoolExecutor
            self._train_executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="lstm-train")
        return self._train_executor

    def _harvest_train(self) -> None:
        self._last_loss = self._train_future.result()
        self.stats.train_steps += 1
        self._train_future = None

    def drain_training(self) -> None:
        """Block until an in-flight training step lands."""
        if self._train_future is not None:
            self._harvest_train()

    def get_statistics(self) -> PrefetchStatistics:
        if self._train_future is not None and self._train_future.done():
            self._harvest_train()
        if self._last_loss is not None:
            self.stats.last_train_loss = float(self._last_loss)
            self._last_loss = None
        return self.stats

    def reset_statistics(self) -> None:
        self.stats.reset()
