"""The prefetcher's LSTM token predictor, in PyTorch.

Counterpart of `cxl_speckv_tpu/prefetcher/lstm.py`: a 2-layer LSTM (128
hidden, 64-d embedding, 16-token history by default) over token ids hashed
into `min(vocab, vocab_buckets)` classes (`ids % C`), predicting the next
token's class. It gates prefetch by the probability that a sequence goes
on (not EOS), ranks sequences within the transfer budget, and seeds n-gram
drafts on a lookup miss.

Parameters, as the reference's tree: `embed` [C, E], `out` [H, C] and per
layer a cell {`wx` [D, 4H], `wh` [H, 4H], `b` [4H]}. A step computes
z = x_t @ wx + h @ wh + b, split into the i, f, g, o gates in that order,
from a zero state; the output is the last layer's final hidden state.
Histories are left-padded with 0. The cell is written out (not
`nn.LSTM`, which has two biases and transposed weights) so that the sums
keep the reference's order.

Where it runs: the predictor lives on the host CPU, as the reference's
does: a prediction sits on the scheduling path every engine step, and online training runs on a
worker thread that must not contend with the accelerator. `lstm_pcont` is
the same forward for the decode round's continue-probability leg, on
whatever device its tensors live on (the engine keeps a copy of the
parameters on its own device for it).

Training is next-token cross-entropy under AdamW with the reference's
optax defaults (betas 0.9 / 0.999, eps 1e-8, weight decay 1e-4 on every
leaf). It updates a private copy of the parameters and publishes a new,
detached tree (`self.params`) when the step ends, as JAX publishes a new
tree: readers on other threads never see a half-updated tree, and the
engine detects a refresh by identity. `save` / `load` use the reference's
file format (`np.savez`, keys p0..pN in its leaf order: each cell's b, wh,
wx, then embed, then out), so a checkpoint written by either package loads
in the other.

Every call runs its CPU ops on one thread (`_one_thread`): the tensors are
small ([B, 512] gates), and fanning each op out over the process's
OpenMP threads makes them wait on each other, and on anything else that
holds the cores; with several processes sharing the cores (parallel test
workers, or the serving thread beside the trainer) a training step then
ran orders of magnitude slower than on one thread.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

Params = dict


def _one_thread(fn):
    """Run `fn` with this thread's intra-op threads set to 1 (an OpenMP
    setting of the calling thread), restored afterwards."""
    @functools.wraps(fn)
    def run(*args, **kw):
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return fn(*args, **kw)
        finally:
            torch.set_num_threads(n)
    return run


class LSTMPredictor:
    def __init__(self, vocab_size: int, *, embed_dim: int = 64,
                 hidden: int = 128, num_layers: int = 2,
                 history_len: int = 16, seed: int = 0,
                 vocab_buckets: int | None = 4096):
        self.vocab_size = vocab_size
        self.n_classes = min(vocab_size, vocab_buckets or vocab_size)
        self.embed_dim = embed_dim
        self.hidden = hidden
        self.num_layers = num_layers
        self.history_len = history_len
        gen = torch.Generator(device="cpu")
        gen.manual_seed(seed)
        self.params = _init(self.n_classes, embed_dim, hidden, num_layers,
                            gen)
        # the training copy and its optimizer, made at the first step
        self._train_params: Params | None = None
        self._opt: torch.optim.Optimizer | None = None

    def _bucket(self, ids) -> np.ndarray:
        ids = np.asarray(ids, np.int32)
        if self.n_classes == self.vocab_size:
            return ids
        return ids % np.int32(self.n_classes)

    def _put(self, x) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x, np.int64))

    # -- inference --------------------------------------------------------------

    @_one_thread
    @torch.no_grad()
    def predict_top_k(self, histories: np.ndarray, k: int):
        """histories [B, history_len] int (left-padded with 0) -> (class ids
        [B, k], probs [B, k]) as numpy; class ids are bucketed token ids."""
        p = self.params
        h = _forward(p, self._put(self._bucket(histories)))
        top_p, top_i = torch.topk(torch.softmax(h @ p["out"], dim=-1), k,
                                  dim=-1)
        return top_i.to(torch.int32).numpy(), top_p.numpy()

    @_one_thread
    @torch.no_grad()
    def continue_probability(self, histories: np.ndarray,
                             eos_token_id: int) -> np.ndarray:
        """P(next token != eos) per sequence: the prefetch gate."""
        p = self.params
        eos = int(eos_token_id) % self.n_classes
        h = _forward(p, self._put(self._bucket(histories)))
        return 1.0 - torch.softmax(h @ p["out"], dim=-1)[:, eos].numpy()

    # -- training ---------------------------------------------------------------

    @_one_thread
    def train_batch(self, histories: np.ndarray, targets: np.ndarray,
                    lr: float = 1e-3) -> float:
        """One next-token cross-entropy step (AdamW) on the training copy,
        then a new published tree. Returns the loss."""
        if self._opt is None:
            self._train_params = _tree_map(
                lambda x: x.detach().clone().requires_grad_(True),
                self.params)
            self._opt = torch.optim.AdamW(
                _leaves(self._train_params), lr=lr, betas=(0.9, 0.999),
                eps=1e-8, weight_decay=1e-4)
        loss = _loss(self._train_params,
                     self._put(self._bucket(histories)),
                     self._put(self._bucket(targets)))
        self._opt.zero_grad(set_to_none=True)
        loss.backward()
        self._opt.step()
        self.params = _tree_map(lambda x: x.detach().clone(),
                                self._train_params)
        return float(loss.detach())

    def warmup(self, batch_sizes=(16, 32), train_batch: int | None = None):
        """Run the prediction (and with `train_batch` one training step) at
        serving shapes, leaving no trace: there is no compile to absorb as
        in the reference, but the first calls still allocate."""
        T = self.history_len
        for b in batch_sizes:
            self.continue_probability(np.zeros((b, T), np.int32), 0)
        if train_batch:
            saved = self.params, self._train_params, self._opt
            self.train_batch(np.zeros((train_batch, T), np.int32),
                             np.zeros(train_batch, np.int32))
            self.params, self._train_params, self._opt = saved

    # -- checkpoint -------------------------------------------------------------

    def save(self, path: str) -> None:
        np.savez(path, **{f"p{i}": x.detach().numpy()
                          for i, x in enumerate(_leaves(self.params))})

    def load(self, path: str) -> None:
        data = np.load(path)
        leaves = [torch.from_numpy(np.array(data[f"p{i}"], np.float32))
                  for i in range(len(data.files))]
        self.params = _unflatten(self.params, leaves)
        if self._train_params is not None:
            # the optimizer's moments stay, as the reference's opt state
            with torch.no_grad():
                for dst, src in zip(_leaves(self._train_params),
                                    _leaves(self.params)):
                    dst.copy_(src)

    def model_size_bytes(self) -> int:
        return sum(x.numel() * x.element_size()
                   for x in _leaves(self.params))


# -- the parameter tree -----------------------------------------------------------

def _init(vocab, embed, hidden, layers, gen) -> Params:
    """The reference's initialisation (normal, its scales), from `gen`."""
    def normal(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float32)

    p: Params = {"embed": normal(vocab, embed) * 0.02,
                 "out": normal(hidden, vocab) * hidden ** -0.5,
                 "cells": []}
    dim = embed
    for _ in range(layers):
        p["cells"].append({
            "wx": normal(dim, 4 * hidden) * dim ** -0.5,
            "wh": normal(hidden, 4 * hidden) * hidden ** -0.5,
            "b": torch.zeros(4 * hidden),
        })
        dim = hidden
    return p


def _leaves(p: Params) -> list[torch.Tensor]:
    """The reference's leaf order (`jax.tree.leaves`: dict keys sorted):
    cells (each b, wh, wx), embed, out."""
    out = []
    for c in p["cells"]:
        out += [c["b"], c["wh"], c["wx"]]
    return out + [p["embed"], p["out"]]


def _unflatten(like: Params, leaves: list) -> Params:
    n = len(like["cells"])
    cells = [{"b": leaves[3 * i], "wh": leaves[3 * i + 1],
              "wx": leaves[3 * i + 2]} for i in range(n)]
    return {"embed": leaves[3 * n], "out": leaves[3 * n + 1], "cells": cells}


def _tree_map(fn, p: Params) -> Params:
    return _unflatten(p, [fn(x) for x in _leaves(p)])


def tree_to(p: Params, device) -> Params:
    """The tree with every leaf on `device` (the same tensors where they
    are already there)."""
    return _tree_map(lambda x: x.to(device), p)


# -- the math -----------------------------------------------------------------

def _forward(p: Params, histories: torch.Tensor) -> torch.Tensor:
    """histories [B, T] class ids -> the last layer's final hidden [B, H]."""
    x = p["embed"][histories]                           # [B, T, E]
    B, T = histories.shape
    for cell in p["cells"]:
        H = cell["wh"].shape[0]
        h = x.new_zeros(B, H)
        c = x.new_zeros(B, H)
        hs = []
        for t in range(T):
            z = x[:, t] @ cell["wx"] + h @ cell["wh"] + cell["b"]
            i, f, g, o = torch.split(z, H, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
        x = torch.stack(hs, dim=1)                      # [B, T, H]
    return x[:, -1]


def _loss(p: Params, histories: torch.Tensor,
          targets: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(_forward(p, histories) @ p["out"], dim=-1)
    return -logp.gather(-1, targets[:, None]).mean()


@_one_thread
@torch.no_grad()
def lstm_pcont(params: Params, hist: torch.Tensor, fresh_toks: torch.Tensor,
               eos_class: int) -> torch.Tensor:
    """The decode round's continue probability [B] float32: each lane's
    pre-round bucketed history [B, T] shifted by the round's fresh tokens
    [B, h] (bucketed here), through the LSTM: what `continue_probability`
    gives on the host after the round's tokens are observed. Runs where
    its tensors are."""
    n_classes = params["embed"].shape[0]
    cat = torch.cat([hist.long(), fresh_toks.long() % n_classes], dim=1)
    h = _forward(params, cat[:, -hist.shape[1]:])
    return 1.0 - torch.softmax(h @ params["out"], dim=-1)[:, eos_class]
