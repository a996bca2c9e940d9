"""KV-quantization accuracy on the card: per KV scheme, the model's
next-token distributions over the quantized pools against the dense
forward's.

    python -m cxl_speckv_tpu_torch.scripts.kv_quant_accuracy \\
        [--preset tiny] [--seqs 8] [--prompt 48] [--decode 16] [--device cpu]

Counterpart of the JAX package's script `scripts/kv_quant_accuracy.py`
(`main` at `:28`, the per-scheme loop inline at `:52-96`, here
`scheme_metrics`). For each scheme (BF16, INT8, FP8, INT4) and each of
`--seqs` random sequences of `--prompt` + `--decode` tokens, the serving
path runs: `models/llama.py` `prefill_chunk` over the prompt (K2), then
`decode_step` token by token (K1), both over pools in the scheme, 16-token
blocks; its logits at positions prompt - 1 .. end are held against
`forward_dense`'s (plain PyTorch, no cache): mean KL(dense || served),
greedy top-1 agreement, the mean logprob drop of the sequence's own next
tokens, and the scheme's compression against BF16. The sequences are drawn
as the JAX script draws them (one RandomState(0) across the schemes, so
each scheme sees its own sequences). Weights are random from seed 0 on the
device. It prints one line a scheme and the same JSON as the JAX script;
no time.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from cxl_speckv_tpu_torch.scripts import common

BS = 16
SCHEMES = ("bf16", "int8", "fp8", "int4")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="tiny")
    ap.add_argument("--seqs", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=48)
    ap.add_argument("--decode", type=int, default=16)
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def served_logits(cfg, params, kv_dtype, tokens, prompt: int,
                  device) -> torch.Tensor:
    """`:57-79`: logits [decode + 1, V] float32 of prefill's last position
    and of each decode step, over fresh pools of one lane (table blocks 1
    ..)."""
    from cxl_speckv_tpu_torch.config import KVDtype
    from cxl_speckv_tpu_torch.models.llama import decode_step, prefill_chunk
    from cxl_speckv_tpu_torch.ops.quant import kv_pack, kv_storage_dtype

    kv = KVDtype(kv_dtype)
    total = len(tokens)
    max_blocks = -(-total // BS) + 1
    slots = max_blocks + 2
    shape = (cfg.num_layers, slots, cfg.num_kv_heads, BS,
             cfg.head_dim // kv_pack(kv))
    elem = kv_storage_dtype(kv)
    pools = (torch.zeros(shape, dtype=elem, device=device),
             torch.zeros(shape, dtype=elem, device=device),
             torch.ones(shape[:-1], device=device),
             torch.ones(shape[:-1], device=device))
    table = torch.arange(1, max_blocks + 1, dtype=torch.int32,
                         device=device)[None]
    toks = torch.as_tensor(np.asarray(tokens), dtype=torch.int32,
                           device=device)
    out = [prefill_chunk(params, cfg, kv, toks[:prompt], 0, pools, table[0])]
    for t in range(prompt, total):
        pos = torch.tensor([t], dtype=torch.int32, device=device)
        out.append(decode_step(params, cfg, kv, toks[t:t + 1], pos, pools,
                               table, pos + 1)[0])
    return torch.stack(out).float()


def scheme_metrics(cfg, params, kv_dtype, seqs, prompt: int,
                   device) -> dict:
    """`:52-96` for one scheme over the given token sequences: mean KL,
    greedy agreement, logprob delta (unrounded) and compression."""
    from cxl_speckv_tpu_torch.config import KVDtype
    from cxl_speckv_tpu_torch.models.llama import forward_dense

    kls, agrees, dlps = [], [], []
    for tokens in seqs:
        toks = torch.as_tensor(np.asarray(tokens), dtype=torch.int32,
                               device=device)
        ref = forward_dense(params, cfg, toks[None])[0].float()[prompt - 1:]
        got = served_logits(cfg, params, kv_dtype, tokens, prompt, device)
        lp_ref = torch.log_softmax(ref, -1)
        lp_got = torch.log_softmax(got, -1)
        kls.append(float((lp_ref.exp() * (lp_ref - lp_got)).sum(-1).mean()))
        agrees.append(float(np.mean(
            (got.argmax(-1) == ref.argmax(-1)).cpu().numpy())))
        nxt = toks[prompt:].long()[:, None]
        dlps.append(float((lp_ref[:-1].gather(1, nxt)
                           - lp_got[:-1].gather(1, nxt)).mean()))
    return {"mean_kl": float(np.mean(kls)),
            "greedy_agreement": float(np.mean(agrees)),
            "logprob_delta": float(np.mean(dlps)),
            "compression": KVDtype(kv_dtype).compression_ratio}


def draw_seqs(rng, n: int, total: int, vocab: int) -> list:
    return [rng.randint(1, vocab, total) for _ in range(n)]


def run(args: argparse.Namespace) -> dict:
    """Returns {scheme: scheme_metrics' dict, unrounded}; prints them
    rounded as the JAX script does."""
    from cxl_speckv_tpu_torch.models.configs import PRESETS, tiny_test_config
    from cxl_speckv_tpu_torch.models.llama import init_params

    dev = common.resolve(args.device, "kv_quant_accuracy")
    cfg = tiny_test_config() if args.preset == "tiny" else PRESETS[args.preset]()
    params = init_params(cfg, common.seeded(dev, 0), device=dev)
    rng = np.random.RandomState(0)
    total = args.prompt + args.decode
    print(f"device: {common.label(dev)} | preset {args.preset}, {args.seqs} "
          f"seqs x {args.prompt} + {args.decode}", flush=True)
    results, shown = {}, {}
    for scheme in SCHEMES:
        seqs = draw_seqs(rng, args.seqs, total, cfg.vocab_size)
        results[scheme] = scheme_metrics(cfg, params, scheme, seqs,
                                         args.prompt, dev)
        r = results[scheme]
        shown[scheme] = {"mean_kl": round(r["mean_kl"], 6),
                         "greedy_agreement": round(r["greedy_agreement"], 4),
                         "logprob_delta": round(r["logprob_delta"], 6),
                         "compression": r["compression"]}
        print(scheme, shown[scheme], flush=True)
    print(json.dumps(shown), flush=True)
    return results


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
    sys.exit(0)
