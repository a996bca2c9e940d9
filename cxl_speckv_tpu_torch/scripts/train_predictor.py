"""Train the prefetch LSTM on a token trace and save its checkpoint.

    python -m cxl_speckv_tpu_torch.scripts.train_predictor [--vocab 2048] \\
        [--steps 300] [--batch 256] [--hist 16] [--out lstm_predictor.npz] \\
        [--trace path.npy]

Counterpart of the JAX package's `scripts/train_predictor.py`: next-token
training on windows of the trace, printing the loss and the top-1 / top-4
accuracy on 1024 held windows every 25 steps, then `LSTMPredictor.save`.
The checkpoint is what `PrefetchConfig.predictor_path` loads (in either
package: the format is the reference's). Without `--trace`, a synthetic
trace from a sparse random Markov chain (4 likely successors a token) is
used. The predictor runs on the host CPU, as in serving.
"""

from __future__ import annotations

import argparse

import numpy as np

from cxl_speckv_tpu_torch.prefetcher.lstm import LSTMPredictor


def synthetic_trace(vocab: int, length: int, seed: int = 0) -> np.ndarray:
    """Tokens of a sparse random Markov chain: 4 likely successors a token
    (the top-4 prediction setting), and a random jump one step in 10."""
    rng = np.random.RandomState(seed)
    successors = rng.randint(0, vocab, (vocab, 4))
    probs = np.array([0.55, 0.25, 0.12, 0.08])
    out = np.empty(length, np.int64)
    t = rng.randint(vocab)
    for i in range(length):
        out[i] = t
        if rng.rand() < 0.9:
            t = successors[t, rng.choice(4, p=probs)]
        else:
            t = rng.randint(vocab)
    return out


def windows(trace: np.ndarray, hist: int, n: int,
            rng) -> tuple[np.ndarray, np.ndarray]:
    """n random (history window, next token) pairs of the trace."""
    idx = rng.randint(0, len(trace) - hist - 1, n)
    H = np.stack([trace[i:i + hist] for i in idx]).astype(np.int32)
    return H, trace[idx + hist].astype(np.int32)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--hist", type=int, default=16)
    ap.add_argument("--trace-len", type=int, default=200_000)
    ap.add_argument("--out", default="lstm_predictor.npz")
    ap.add_argument("--trace", default=None, help=".npy int token trace")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    trace = (np.load(args.trace) if args.trace
             else synthetic_trace(args.vocab, args.trace_len))
    pred = LSTMPredictor(int(trace.max()) + 1, history_len=args.hist)
    rng = np.random.RandomState(1)
    Hv, yv = windows(trace, args.hist, 1024, np.random.RandomState(99))
    res = {}
    for step in range(args.steps):
        H, y = windows(trace, args.hist, args.batch, rng)
        loss = pred.train_batch(H, y)
        if step % 25 == 0 or step == args.steps - 1:
            ids, _ = pred.predict_top_k(Hv, 4)
            res = {"step": step, "loss": loss,
                   "top1": float((ids[:, 0] == yv).mean()),
                   "top4": float((ids == yv[:, None]).any(axis=1).mean())}
            print(f"step {step:4d} loss {loss:.3f} top1 {res['top1']:.3f} "
                  f"top4 {res['top4']:.3f}", flush=True)
    pred.save(args.out)
    print(f"saved {args.out} ({pred.model_size_bytes() / 1e6:.1f} MB)")
    return res


if __name__ == "__main__":
    main()
