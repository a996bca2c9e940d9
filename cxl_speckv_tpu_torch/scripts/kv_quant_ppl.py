"""Prompt perplexity under each KV scheme, by echo scoring through the
serving engine, on the card.

    python -m cxl_speckv_tpu_torch.scripts.kv_quant_ppl [--seqs 8] \\
        [--len 96] [--chunk 32] [--compute float32] [--device cpu]

Counterpart of the JAX package's script `scripts/kv_quant_ppl.py`
(`mean_nll` at `:44`, `main` at `:65`). Each prompt is scored by the
engine's prompt logprobs (`add_request(..., prompt_logprobs=True)`):
chunked prefill through K2 over the paged pools in the scheme under test,
so the mean negative log-likelihood a token, against BF16 KV's, isolates
the KV quantization's effect. Rows: BF16, INT8, FP8, INT4 KV (with their
compression against BF16), then W8A16 and W4A16 weights over BF16 and
INT8 KV. The model is `tiny_test_config()` with random weights from seed
42 (the JAX script's PRNGKey(42)) drawn on the device; prompts from
`--seed`. `--compute` overrides the attention compute dtype (the config's
bf16 by default; float32 for comparisons across devices). Unlike the JAX
module, which sets `SPECKV_INTERPRET` and the JAX platform when imported
(`:19-25`), importing this one changes nothing; it runs on the card unless
`--device cpu`. No time is printed.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys

import numpy as np

from cxl_speckv_tpu_torch.scripts import common

SCHEMES = ("bf16", "int8", "fp8", "int4")
COMPRESSION = {"bf16": 1.0, "int8": 2.0, "fp8": 2.0, "int4": 4.0}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seqs", type=int, default=8)
    ap.add_argument("--len", type=int, dest="length", default=96)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compute", choices=("bfloat16", "float32"), default=None,
                    help="attention compute dtype (default: the config's)")
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def mean_nll(cfg, params, scheme, prompts, chunk, weight_dtype="native",
             device=None) -> float:
    """Mean NLL a scored token (`:44-62`): every prompt echo-scored by an
    engine with KV scheme `scheme` and weights `weight_dtype`; `device`
    None is the card."""
    from cxl_speckv_tpu_torch.config import (
        CacheConfig,
        EngineConfig,
        KVDtype,
        PrefetchConfig,
        SystemConfig,
    )
    from cxl_speckv_tpu_torch.engine import Engine

    sc = SystemConfig(
        cache=CacheConfig(block_size=8, num_hbm_blocks=512,
                          num_host_blocks=512, kv_dtype=KVDtype(scheme)),
        prefetch=PrefetchConfig(depth=2),
        engine=EngineConfig(max_batch_size=4,
                            max_seq_len=max(len(p) for p in prompts) + 8,
                            prefill_chunk=chunk, weight_dtype=weight_dtype))
    eng = Engine(cfg, sc, params=params, device=device, enable_lstm=False)
    ids = [eng.add_request(p, max_new_tokens=1, prompt_logprobs=True)
           for p in prompts]
    outs = {o.req_id: o for o in eng.run()}
    nll, n = 0.0, 0
    for i in ids:
        scores = outs[i].prompt_logprobs[1:]
        nll -= sum(scores)
        n += len(scores)
    return nll / n


def setup(args, dev: str):
    """(config, params, prompts) of `:73-77`."""
    from cxl_speckv_tpu_torch.models.configs import tiny_test_config
    from cxl_speckv_tpu_torch.models.llama import init_params

    cfg = tiny_test_config()
    if args.compute:
        cfg = dataclasses.replace(cfg, attn_compute_dtype=args.compute)
    params = init_params(cfg, common.seeded(dev, 42), device=dev)
    rng = np.random.RandomState(args.seed)
    prompts = [rng.randint(1, cfg.vocab_size, args.length).tolist()
               for _ in range(args.seqs)]
    return cfg, params, prompts


def run(args: argparse.Namespace) -> dict:
    """Returns {"kv": {scheme: nll}, "weights": {(weight dtype, scheme):
    nll}}."""
    dev = common.resolve(args.device, "kv_quant_ppl")
    cfg, params, prompts = setup(args, dev)
    print(f"{common.label(dev)} | # {args.seqs} seqs x {args.length} tokens, "
          f"chunk {args.chunk}, echo scoring through the paged quantized "
          f"pools, attention compute {cfg.attn_compute_dtype}", flush=True)
    out = {"kv": {}, "weights": {}}
    base = None
    for scheme in SCHEMES:
        nll = mean_nll(cfg, params, scheme, prompts, args.chunk, device=dev)
        out["kv"][scheme] = nll
        ppl = math.exp(nll)
        base = base or ppl
        print(f"{scheme:5s}  nll/token {nll:.5f}  ppl {ppl:.2f}  "
              f"delta vs bf16 {100 * (ppl - base) / base:+.3f}%  "
              f"compression {COMPRESSION[scheme]:.0f}x", flush=True)
    for wq, ratio in (("int8", "2x"), ("int4", "4x")):
        for scheme in ("bf16", "int8"):
            nll = mean_nll(cfg, params, scheme, prompts, args.chunk,
                           weight_dtype=wq, device=dev)
            out["weights"][(wq, scheme)] = nll
            ppl = math.exp(nll)
            print(f"{scheme:5s}+W{wq[3]}A16  nll/token {nll:.5f}  "
                  f"ppl {ppl:.2f}  delta vs bf16 "
                  f"{100 * (ppl - base) / base:+.3f}%  (weights {ratio} "
                  f"smaller)", flush=True)
    return out


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
    sys.exit(0)
