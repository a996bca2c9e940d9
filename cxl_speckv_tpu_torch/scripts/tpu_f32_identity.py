"""Token-identity assertions at float32 on the card: the host-streamed
path against the pooled one, fused against per-step streamed decode, and
speculative against plain greedy.

    python -m cxl_speckv_tpu_torch.scripts.tpu_f32_identity [--device cpu]

Counterpart of the JAX package's TPU script `scripts/tpu_f32_identity.py`
(`check_native_exact` at `:98`, `_assert_envelope` at `:129`,
`check_int8_envelope` at `:158`, `check_spec_envelope` at `:177`, EPS 0.06
at `:56`), at its config (`_cfg` at `:59`: 4 layers, width 512, vocabulary
2048, float32 weights and attention compute), random weights from seed 0
on the device, 2 prompts of 300 tokens, 24 new ones, greedy:

1. BF16 ("native") KV: streamed (an 8-block pool, max_seq_len 128, so both
   prompts stream) against pooled, and the streamed decode fused
   (horizon 8) against per step, exactly.
2. INT8 KV: the same two pairs within the envelope (`_assert_envelope`):
   on agreeing steps the chosen tokens' logprobs within EPS, and a first
   divergence only at a near-tie, the two picks swapped in each other's
   top 2 with a margin under EPS (the quantizer's round() turns a 1e-7
   difference at a rounding boundary into a whole step, `:11-24`).
3. Speculative (a 2-layer draft, gamma 4, BF16 KV, 6 prompts of 24 + 48)
   against plain greedy within the same envelope.

On the card the pooled path attends through K1 / K2, the streamed one
through the plain float32 wave loop of `ops/stream_attention.py`, and the
two sum in different orders; leg 1's streamed-vs-pooled pair is exact on
the CPU, where both are plain PyTorch, and on the card it is held exact
too. Every leg raises AssertionError on a miss. Seconds are the host
clock.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from cxl_speckv_tpu_torch.scripts import common

EPS = 0.06


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def _cfg():
    from cxl_speckv_tpu_torch.models.configs import LlamaConfig

    return LlamaConfig(
        vocab_size=2048, hidden_size=512, intermediate_size=1024,
        num_layers=4, num_q_heads=8, num_kv_heads=4, head_dim=64,
        rope_theta=10000.0, tie_embeddings=False, max_seq_len=4096,
        eos_token_id=0, dtype="float32", attn_compute_dtype="float32")


def _draft_cfg():
    from cxl_speckv_tpu_torch.models.configs import LlamaConfig

    return LlamaConfig(
        vocab_size=2048, hidden_size=256, intermediate_size=512,
        num_layers=2, num_q_heads=4, num_kv_heads=4, head_dim=32,
        rope_theta=10000.0, tie_embeddings=False, max_seq_len=512,
        eos_token_id=0, dtype="float32", attn_compute_dtype="float32")


def _engine(cfg, params, device, *, hbm, host, max_seq, horizon=1, chunk=64,
            kv="int8", batch=2, **spec):
    from cxl_speckv_tpu_torch.config import (
        CacheConfig,
        EngineConfig,
        KVDtype,
        PrefetchConfig,
        SystemConfig,
    )
    from cxl_speckv_tpu_torch.engine import Engine

    sc = SystemConfig(
        cache=CacheConfig(block_size=32, num_hbm_blocks=hbm,
                          num_host_blocks=host,
                          kv_dtype=KVDtype.INT8 if kv == "int8"
                          else KVDtype.BF16),
        prefetch=PrefetchConfig(enabled=False),
        engine=EngineConfig(max_batch_size=batch, max_seq_len=max_seq,
                            prefill_chunk=chunk, decode_horizon=horizon,
                            stream_wave=8))
    return Engine(cfg, sc, params=params, device=device, enable_lstm=False,
                  seed=0, **spec)


def _serve(engine, prompts, gen, logprobs=0):
    ids = [engine.add_request(p, max_new_tokens=gen, logprobs=logprobs)
           for p in prompts]
    outs = {o.req_id: o for o in engine.run()}
    return [outs[i] for i in ids]


def _prompts(n: int = 2, length: int = 300):
    rng = np.random.RandomState(11)
    return [rng.randint(1, 2048, length).tolist() for _ in range(n)]


def _params(cfg, device, seed=0):
    from cxl_speckv_tpu_torch.models.llama import init_params

    return init_params(cfg, common.seeded(device, seed), device=device)


def _check(cond, *what) -> None:
    if not cond:
        raise AssertionError(what)


def check_native_exact(device, cfg=None, prompts=None, gen=24) -> dict:
    """Leg 1 (`:98-126`): BF16 KV, streamed == pooled and fused (horizon
    8) == per-step streamed, exactly."""
    cfg = cfg or _cfg()
    params = _params(cfg, device)
    prompts = prompts or _prompts()
    prefix = common.label(device)
    t0 = time.monotonic()
    pooled = _serve(_engine(cfg, params, device, hbm=64, host=0, max_seq=512,
                            kv="native"), prompts, gen)
    tight = _engine(cfg, params, device, hbm=8, host=64, max_seq=128,
                    kv="native")
    streamed = _serve(tight, prompts, gen)
    st = tight.get_statistics()["engine"]
    _check(st["stream_tokens"] > 0, "tight engine did not stream")
    ident = [o.tokens for o in pooled] == [o.tokens for o in streamed]
    print(f"{prefix} | native-KV streamed==pooled (f32): {ident} "
          f"({st['stream_tokens']} streamed tokens, "
          f"{time.monotonic() - t0:.0f}s)", flush=True)
    _check(ident, [o.tokens for o in pooled], [o.tokens for o in streamed])
    t0 = time.monotonic()
    fused = _serve(_engine(cfg, params, device, hbm=8, host=64, max_seq=128,
                           horizon=8, kv="native"), prompts, gen)
    ident2 = [o.tokens for o in fused] == [o.tokens for o in streamed]
    print(f"{prefix} | native-KV fused(h=8)==per-step (f32): {ident2} "
          f"({time.monotonic() - t0:.0f}s)", flush=True)
    _check(ident2, [o.tokens for o in fused], [o.tokens for o in streamed])
    return {"streamed_tokens": st["stream_tokens"]}


def _assert_envelope(a_outs, b_outs, label, eps=EPS) -> dict:
    """`:129-155`: the two runs' tokens agree except at a near-tie: on every
    agreeing step the chosen token's logprobs differ by less than `eps`;
    at a lane's first divergence a's top-2 margin is under `eps` and each
    run's pick is the other's #2 (the lane is not compared after it).
    Raises AssertionError otherwise; returns the counts."""
    worst_d, n_agree, n_div = 0.0, 0, 0
    for a, b in zip(a_outs, b_outs):
        for j, (ta, tb) in enumerate(zip(a.tokens, b.tokens)):
            la, lb = a.logprobs[j], b.logprobs[j]
            if ta == tb:
                d = abs(la["logprob"] - lb["logprob"])
                worst_d = max(worst_d, d)
                n_agree += 1
                _check(d < eps, label, j, ta, d)
                continue
            margin = la["top_logprobs"][0] - la["top_logprobs"][1]
            n_div += 1
            _check(margin < eps, label, j, "margin", margin)
            _check(tb == la["top_ids"][1], label, j, la["top_ids"], tb)
            _check(ta == lb["top_ids"][1], label, j, lb["top_ids"], ta)
            break
    print(f"envelope {label}: {n_agree} steps agree (worst cross-path dlp "
          f"{worst_d:.1e}), {n_div} divergences - all sub-{eps} near-ties",
          flush=True)
    return {"agree": n_agree, "divergences": n_div, "worst_dlp": worst_d}


def check_int8_envelope(device, cfg=None, prompts=None, gen=24) -> dict:
    """Leg 2 (`:158-174`)."""
    cfg = cfg or _cfg()
    params = _params(cfg, device)
    prompts = prompts or _prompts()
    t0 = time.monotonic()
    pooled = _serve(_engine(cfg, params, device, hbm=64, host=0, max_seq=512),
                    prompts, gen, logprobs=2)
    streamed = _serve(_engine(cfg, params, device, hbm=8, host=64,
                              max_seq=128), prompts, gen, logprobs=2)
    a = _assert_envelope(pooled, streamed, "streamed-vs-pooled")
    fused = _serve(_engine(cfg, params, device, hbm=8, host=64, max_seq=128,
                           horizon=8), prompts, gen, logprobs=2)
    b = _assert_envelope(streamed, fused, "fused-vs-per-step")
    print(f"{common.label(device)} | int8 envelope checks "
          f"{time.monotonic() - t0:.0f}s", flush=True)
    return {"streamed-vs-pooled": a, "fused-vs-per-step": b}


def check_spec_envelope(device, cfg=None, n_prompts=6, gen=48) -> dict:
    """Leg 3 (`:177-221`): spec (draft) greedy vs plain greedy, BF16 KV."""
    cfg = cfg or _cfg()
    draft = _draft_cfg() if cfg.vocab_size == 2048 else cfg
    params = _params(cfg, device)
    draft_params = _params(draft, device, seed=1)
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, cfg.vocab_size, 24).tolist()
               for _ in range(n_prompts)]
    kw = dict(hbm=64, host=128, max_seq=256, kv="native", batch=4)
    t0 = time.monotonic()
    plain = _serve(_engine(cfg, params, device, **kw), prompts, gen,
                   logprobs=2)
    spec = _serve(_engine(cfg, params, device, draft_config=draft,
                          draft_params=draft_params, spec_gamma=4, **kw),
                  prompts, gen, logprobs=2)
    r = _assert_envelope(plain, spec, "spec-vs-greedy")
    print(f"{common.label(device)} | spec envelope check "
          f"{time.monotonic() - t0:.0f}s", flush=True)
    return r


def run(args: argparse.Namespace) -> dict:
    dev = common.resolve(args.device, "tpu_f32_identity")
    print(f"device: {common.label(dev)}", flush=True)
    out = {"native": check_native_exact(dev), "int8": check_int8_envelope(dev),
           "spec": check_spec_envelope(dev)}
    print("RESULT: f32 identities hold: EXACT at native KV for the streamed "
          "machinery (streamed==pooled, fused==per-step); int8-KV and spec "
          "divergences are sub-EPS near-ties", flush=True)
    return out


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
    sys.exit(0)
