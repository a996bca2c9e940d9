"""Speculative greedy against plain greedy on the card: agreement under
plain and sharpened random weights, and the cascade-free self-draft
acceptance.

    python -m cxl_speckv_tpu_torch.scripts.tpu_spec_check [--f32] \\
        [--device cpu]

Counterpart of the JAX package's TPU script `scripts/tpu_spec_check.py`
(`run_check` at `:25`, `run_self_draft` at `:99`, `main` at `:141`), at
its configs (`:44-55`, `:114`): a 4-layer target (vocabulary 2048, width
512, 8 / 4 heads of 64) and a 2-layer draft, bf16 weights (`run_check`'s
`wdtype`), INT8 KV in 32-token blocks, 6 prompts of 24 tokens and 48 new
ones each, gamma 4. On the card decode runs K1 and verify runs K2, which
sum in different orders, so a near-tie can flip a greedy pick.

- `run_self_draft`: the target drafts for itself, so the acceptance is
  the per-position decode-vs-verify argmax agreement, free of cascades;
  the draft's KV is the engine's default BF16 against the target's INT8
  (as in the JAX script), so it is also held down by the two KV formats
  (0.93-0.94 on the CPU's plain versions at float32);
- `run_check(sharp)`: a draft model proposes for the target; the fraction
  of emitted tokens equal to a plain serve's (one early flip re-contexts
  every later token, so this sequence metric is chaotic on random
  weights); `sharp` triples lm_head for sharper margins.

`--f32` sets the attention compute dtype to float32 (the activations stay
bf16, as in the JAX script); `--wdtype float32` (the port's flag) makes
the weights and activations float32 too, the configuration the JAX
`run_check` docstring names for an exact assertion (`:31-34`): at bf16
activations the decode (one row) and verify (gamma + 1 rows) matmuls
round differently, and one early flip re-contexts a whole lane. The
script prints its lines and a RESULT line and, like the JAX script,
asserts nothing; its callers hold the numbers (`chip_smoke.py`'s
`[scripts]` phase: the plain and sharp agreement at least 0.95 with
`--f32 --wdtype float32`, the bf16 run recorded). Weights are random
from seed 0 on the device (the JAX script's PRNGKey(0)); the draft
model's, the engine's seeded draw. Seconds are the host clock.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from cxl_speckv_tpu_torch.scripts import common

N_PROMPTS, PROMPT, GEN = 6, 24, 48


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--f32", action="store_true",
                    help="float32 attention compute")
    ap.add_argument("--wdtype", choices=("bfloat16", "float32"),
                    default="bfloat16",
                    help="weight and activation dtype (the JAX script's "
                         "run_check argument; float32 with --f32 is its "
                         "exact configuration)")
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def configs(cdt: str, wdtype: str = "bfloat16"):
    """(target, draft) of `:44-53`."""
    from cxl_speckv_tpu_torch.models.configs import LlamaConfig

    cfg = LlamaConfig(
        vocab_size=2048, hidden_size=512, intermediate_size=1024,
        num_layers=4, num_q_heads=8, num_kv_heads=4, head_dim=64,
        rope_theta=10000.0, tie_embeddings=False, max_seq_len=512,
        eos_token_id=0, dtype=wdtype, attn_compute_dtype=cdt)
    draft = LlamaConfig(
        vocab_size=2048, hidden_size=256, intermediate_size=512,
        num_layers=2, num_q_heads=4, num_kv_heads=4, head_dim=32,
        rope_theta=10000.0, tie_embeddings=False, max_seq_len=512,
        eos_token_id=0, dtype=wdtype, attn_compute_dtype=cdt)
    return cfg, draft


def system(kv: str):
    from cxl_speckv_tpu_torch.config import (
        CacheConfig,
        EngineConfig,
        KVDtype,
        PrefetchConfig,
        SystemConfig,
    )

    return SystemConfig(
        cache=CacheConfig(block_size=32, num_hbm_blocks=64,
                          num_host_blocks=128,
                          kv_dtype=KVDtype.INT8 if kv == "int8"
                          else KVDtype.BF16),
        prefetch=PrefetchConfig(enabled=False),
        engine=EngineConfig(max_batch_size=4, max_seq_len=256,
                            prefill_chunk=64))


def prompts(n: int = N_PROMPTS) -> list:
    rng = np.random.RandomState(7)
    return [rng.randint(1, 2048, PROMPT).tolist() for _ in range(n)]


def target_params(cfg, device: str):
    from cxl_speckv_tpu_torch.models.llama import init_params

    return init_params(cfg, common.seeded(device, 0), device=device)


def serve(eng, ps, gen: int) -> list:
    ids = [eng.add_request(p, max_new_tokens=gen) for p in ps]
    outs = {o.req_id: o.tokens for o in eng.run()}
    return [outs[i] for i in ids]


def run_check(sharp: bool, cdt: str = "bfloat16", wdtype: str = "bfloat16",
              kv: str = "int8", device: str = "cuda",
              n_prompts: int = N_PROMPTS, gen: int = GEN) -> float:
    """Greedy spec-vs-plain sequence agreement (`:25-96`)."""
    from cxl_speckv_tpu_torch.engine import Engine

    cfg, draft = configs(cdt, wdtype)
    params = target_params(cfg, device)
    if sharp:
        params = {**params, "lm_head": params["lm_head"] * 3.0}
    ps = prompts(n_prompts)
    t0 = time.monotonic()
    plain = serve(Engine(cfg, system(kv), params=params, device=device,
                         enable_lstm=False, seed=0), ps, gen)
    spec_eng = Engine(cfg, system(kv), params=params, device=device,
                      enable_lstm=False, seed=0, draft_config=draft,
                      spec_gamma=4)
    spec = serve(spec_eng, ps, gen)
    st = spec_eng.get_statistics()
    pairs = [(x, y) for a, b in zip(plain, spec) for x, y in zip(a, b)]
    same = sum(int(x == y) for x, y in pairs)
    print(f"{common.label(device)} | init={'sharp' if sharp else 'plain'}: "
          f"greedy agreement {same}/{len(pairs)} = {same / len(pairs):.3f} "
          f"identical={plain == spec} "
          f"acceptance={st['spec'].get('acceptance_rate', 'n/a')} "
          f"({time.monotonic() - t0:.0f}s)", flush=True)
    return same / len(pairs)


def run_self_draft(cdt: str = "bfloat16", wdtype: str = "bfloat16",
                   device: str = "cuda",
                   n_prompts: int = N_PROMPTS, gen: int = GEN) -> float:
    """The target drafts for itself (`:99-138`): acceptance = the
    per-position decode-vs-verify greedy agreement."""
    from cxl_speckv_tpu_torch.engine import Engine

    cfg, _ = configs(cdt, wdtype)
    params = target_params(cfg, device)
    eng = Engine(cfg, system("int8"), params=params, device=device,
                 enable_lstm=False, seed=0, draft_config=cfg,
                 draft_params=params, spec_gamma=4)
    t0 = time.monotonic()
    serve(eng, prompts(n_prompts), gen)
    acc = eng.get_statistics()["spec"]["acceptance_rate"]
    print(f"{common.label(device)} | self-draft acceptance (= per-position "
          f"decode/verify argmax agreement, cascade-free): {acc:.4f} "
          f"({time.monotonic() - t0:.0f}s)", flush=True)
    return acc


def run(args: argparse.Namespace, n_prompts: int = N_PROMPTS,
        gen: int = GEN) -> dict:
    dev = common.resolve(args.device, "tpu_spec_check")
    print(f"device: {dev}" + (f" ({common.card_label()})"
                              if dev == "cuda" else ""), flush=True)
    cdt = "float32" if args.f32 else "bfloat16"
    kw = dict(device=dev, n_prompts=n_prompts, gen=gen, wdtype=args.wdtype)
    a0 = run_self_draft(cdt=cdt, **kw)
    a1 = run_check(sharp=False, cdt=cdt, **kw)
    a2 = run_check(sharp=True, cdt=cdt, **kw)
    print(f"RESULT cdt={cdt} wdtype={args.wdtype} selfdraft={a0:.4f} "
          f"plain={a1:.3f} sharp={a2:.3f}", flush=True)
    return {"cdt": cdt, "wdtype": args.wdtype, "selfdraft": a0, "plain": a1,
            "sharp": a2}


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
    sys.exit(0)
