"""The ported serving scripts (`cxl_speckv_tpu_torch/scripts/`) on the CPU
at small sizes, against the JAX package where it has the counterpart:

- verify_gamma_probe: the tables it sizes from --ctx and --batch cover each
  lane's context with slots no other lane holds (at ctx 256 and 1024,
  where the JAX script's fixed 8-block table indexes past its end and
  aliases lanes); at ctx 64 one round's n_acc and emitted tokens equal the
  JAX `_verify_accept_program(use_pallas=False)`
  (`cxl_speckv_tpu/engine/spec.py:138`) exactly, on the same weights,
  pools, tables and drafts (float32 attention compute);
- spec_bench: at the tiny model the n-gram and self arms emit plain
  greedy's tokens exactly, and the printed JSON holds the JAX script's
  keys (`scripts/spec_bench.py:246-265`);
- tpu_spec_check: at its configs, float32 attention compute, spec greedy
  agrees with plain greedy everywhere (plain and sharp inits);
- stream_bench: at its CPU sizes (float32) streamed tokens == pooled;
- tpu_f32_identity: the port's `_assert_envelope` accepts and refuses the
  same synthetic output pairs as the JAX script's (`scripts/
  tpu_f32_identity.py:129`, loaded from its file, which imports no JAX at
  module level), and its leg 1 passes on the CPU at tiny sizes;
- bench_ablate: the lstm, nolstm and noprefetch modes emit identical
  tokens (prefetching never changes an answer).
"""

import contextlib
import dataclasses
import importlib.util
import io
import re
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxl_speckv_tpu.config import KVDtype as JKV
from cxl_speckv_tpu.engine.spec import _verify_accept_program
from cxl_speckv_tpu.models.configs import tiny_test_config as j_tiny
from cxl_speckv_tpu.models.llama import init_params as j_init_params
from cxl_speckv_tpu_torch.models.configs import tiny_test_config
from cxl_speckv_tpu_torch.models.convert import params_from_jax
from cxl_speckv_tpu_torch.scripts import bench_ablate, spec_bench, stream_bench
from cxl_speckv_tpu_torch.scripts import tpu_f32_identity as tfi
from cxl_speckv_tpu_torch.scripts import tpu_spec_check as tsc
from cxl_speckv_tpu_torch.scripts import verify_gamma_probe as vgp

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and these tests' many small ops slow down many times over when each
    process's thread pool contends for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def quiet(fn, *a, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **kw)
    return out, buf.getvalue()


# ---------------------------------------------------------------------------
# verify_gamma_probe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ctx", [256, 1024])
def test_verify_gamma_tables_cover_context_without_aliasing(ctx):
    batch, bs, gamma = 8, vgp.BS, 16
    tables, n_slots = vgp.tables_for(batch, ctx)
    need = (ctx + gamma) // bs + 1          # blocks the verify writes into
    assert tables.shape[1] >= need
    held = [set(tables[b, :need].tolist()) for b in range(batch)]
    for b in range(batch):
        assert len(held[b]) == need                  # no slot twice
        assert max(held[b]) < n_slots - 1            # never the guard
        for o in range(b):
            assert not held[b] & held[o]             # no slot of another lane
    # the JAX script's table (`scripts/verify_gamma_probe.py:60-79`) at
    # this ctx: 8 blocks, 100 slots; it needs more blocks or aliases lanes
    n_blocks = ctx // bs + 1
    jt = [[(b * n_blocks + i) % 99 for i in range(n_blocks)]
          for b in range(batch)]
    assert n_blocks > 8 or len({s for row in jt for s in row}) < batch * n_blocks


@pytest.fixture(scope="module")
def weights():
    jp = j_init_params(j_tiny(), jax.random.PRNGKey(11))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp))


def jax_verify(jp, jcfg, gamma, toks, drafts, start, tables, n_slots):
    c = jcfg
    bs = vgp.BS
    pools = (jnp.zeros((c.num_layers, n_slots, c.head_dim,
                        c.num_kv_heads * bs), jnp.int8),
             jnp.zeros((c.num_layers, n_slots, c.num_kv_heads, bs,
                        c.head_dim), jnp.int8),
             jnp.ones((c.num_layers, n_slots, 1, c.num_kv_heads * bs)),
             jnp.ones((c.num_layers, n_slots, 1, c.num_kv_heads * bs)))
    B = toks.shape[0]
    out = _verify_accept_program(
        jp, jcfg, JKV.INT8, jnp.asarray(toks), jnp.asarray(start), *pools,
        jnp.asarray(tables), jnp.ones(B, bool), None, jnp.asarray(drafts),
        jnp.zeros(B, jnp.float32), jnp.zeros(B, jnp.float32),
        jax.random.PRNGKey(1), gamma=gamma, use_pallas=False)
    n_acc, final = np.asarray(out[0])
    return n_acc, [list(d[:n]) + [f] for d, n, f in zip(drafts, n_acc, final)]


@pytest.mark.parametrize("gamma", [2, 4])
def test_verify_gamma_round_matches_jax(weights, gamma):
    jp, params = weights
    cfg = dataclasses.replace(tiny_test_config(), attn_compute_dtype="float32")
    jcfg = dataclasses.replace(j_tiny(), attn_compute_dtype="float32")
    B, ctx = 4, 64
    tables, n_slots = vgp.tables_for(B, ctx)
    toks, drafts, start, active, temps = vgp.round_inputs(
        cfg, B, gamma, ctx, np.random.RandomState(gamma))
    want_n, want_e = jax_verify(jp, jcfg, gamma, toks, drafts, start, tables,
                                n_slots)
    # then drafts that begin with the target's own picks, so that lanes
    # accept some
    drafts2 = drafts.copy()
    drafts2[:2, 0] = [e[0] for e in want_e[:2]]
    toks2 = np.concatenate([toks[:, :1], drafts2], axis=1)
    want_n2, want_e2 = jax_verify(jp, jcfg, gamma, toks2, drafts2, start,
                                  tables, n_slots)
    assert want_n2[:2].min() >= 1
    for t, d, wn, we in ((toks, drafts, want_n, want_e),
                         (toks2, drafts2, want_n2, want_e2)):
        pools = vgp.fresh_pools(cfg, n_slots, "cpu")
        emitted, n_acc = vgp.verify_call(params, cfg, gamma, t, d, start,
                                         active, temps, pools, tables)
        np.testing.assert_array_equal(n_acc, wn)
        assert emitted == [[int(x) for x in e] for e in we]


# ---------------------------------------------------------------------------
# spec_bench
# ---------------------------------------------------------------------------

def jax_json_keys() -> set:
    """The keys of the JSON `scripts/spec_bench.py:246-265` prints."""
    src = (REPO / "scripts" / "spec_bench.py").read_text()
    body = src[src.index("    out = {\"model\""):src.index("print(json.dumps")]
    return set(re.findall(r'"(\w+)":', body.split("curve = ")[0])) | set(
        re.findall(r'out\["(\w+)"\]', body))


def test_spec_bench_arms_emit_plain_tokens_and_keys():
    res, text = quiet(spec_bench.main, [
        "--device", "cpu", "--model", "tiny", "--arms", "plain,ngram,self",
        "--n", "4", "--prompt", "16", "--gen", "12"])
    t = res["tokens"]
    assert t["plain"] == t["ngram"] == t["self"]
    assert all(len(x) == 12 for x in t["plain"])
    assert all(res["finished"].values())
    keys = jax_json_keys()
    assert {"oversubscription", "arms", "ngram_speedup_vs_plain_at_acceptance",
            "measured"} <= keys
    assert set(res["json"]) == keys
    assert set(res["json"]["measured"]) == {"t_tok_ms", "t_round_ms"}
    for arm in ("ngram", "self"):
        assert {"acceptance", "tokens_per_round", "rounds", "round_ms",
                "phases"} <= set(res["json"]["arms"][arm])
    assert '"ngram_speedup_vs_plain_at_acceptance"' in text


# ---------------------------------------------------------------------------
# tpu_spec_check, stream_bench
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sharp", [False, True])
def test_tpu_spec_check_agreement_at_float32(sharp):
    agree, _ = quiet(tsc.run_check, sharp, cdt="float32", device="cpu",
                     n_prompts=2, gen=16)
    assert agree == 1.0


def test_stream_bench_streamed_equals_pooled():
    res, text = quiet(stream_bench.main, ["--device", "cpu"])
    assert res["same"]
    assert res["stream_tokens"] > 0 and res["staged_gb_step"] > 0
    assert all(res["finished"].values())
    assert "token-identical streamed vs pooled: True" in text


# ---------------------------------------------------------------------------
# tpu_f32_identity
# ---------------------------------------------------------------------------

def jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_tpu_f32_identity", REPO / "scripts" / "tpu_f32_identity.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def out(tokens, chosen, tops):
    """An output: tokens, and per token its logprob and top-2 table."""
    return SimpleNamespace(tokens=tokens, logprobs=[
        {"logprob": c, "top_ids": list(i), "top_logprobs": list(v)}
        for c, (i, v) in zip(chosen, tops)])


def envelope_cases():
    same = out([5, 6], [-0.1, -0.2], [((5, 9), (-0.1, -2.0)),
                                      ((6, 9), (-0.2, -2.0))])
    yield "equal", [same], [same]
    yield "dlp under eps", [same], [out([5, 6], [-0.13, -0.22],
                                        [((5, 9), (-0.13, -2.0)),
                                         ((6, 9), (-0.22, -2.0))])]
    yield "dlp over eps", [same], [out([5, 6], [-0.1, -0.3],
                                       [((5, 9), (-0.1, -2.0)),
                                        ((6, 9), (-0.3, -2.0))])]
    tie_a = out([5, 6], [-0.1, -0.70], [((5, 9), (-0.1, -2.0)),
                                        ((6, 7), (-0.70, -0.72))])
    tie_b = out([5, 7], [-0.1, -0.69], [((5, 9), (-0.1, -2.0)),
                                        ((7, 6), (-0.69, -0.71))])
    yield "near-tie swap", [tie_a], [tie_b]
    wide = out([5, 6], [-0.1, -0.5], [((5, 9), (-0.1, -2.0)),
                                      ((6, 7), (-0.5, -0.9))])
    yield "margin over eps", [wide], [tie_b]
    other = out([5, 8], [-0.1, -0.69], [((5, 9), (-0.1, -2.0)),
                                        ((8, 6), (-0.69, -0.71))])
    yield "not the other's #2", [tie_a], [other]
    yield "two lanes", [same, tie_a], [same, tie_b]


@pytest.mark.parametrize("case", list(envelope_cases()), ids=lambda c: c[0])
def test_f32_identity_envelope_matches_jax(case):
    _, a, b = case
    verdict = []
    for fn in (jax_script()._assert_envelope, tfi._assert_envelope):
        try:
            quiet(fn, a, b, "case")
            verdict.append(True)
        except AssertionError:
            verdict.append(False)
    assert verdict[0] == verdict[1], verdict
    assert tfi.EPS == jax_script().EPS == 0.06


def test_f32_identity_leg1_on_cpu():
    """Leg 1 at tiny sizes (2 layers of width 128, 2 x (150 + 12) tokens,
    past the tight engine's max_seq_len 128, so both stream): exact."""
    cfg = dataclasses.replace(tfi._cfg(), num_layers=2, hidden_size=128,
                              intermediate_size=256, num_q_heads=4,
                              num_kv_heads=2, head_dim=32)
    r, text = quiet(tfi.check_native_exact, "cpu", cfg=cfg,
                    prompts=tfi._prompts(2, 150), gen=12)
    assert r["streamed_tokens"] > 0
    assert "streamed==pooled (f32): True" in text
    assert "fused(h=8)==per-step (f32): True" in text


# ---------------------------------------------------------------------------
# bench_ablate
# ---------------------------------------------------------------------------

def test_bench_ablate_modes_emit_identical_tokens():
    res, text = quiet(bench_ablate.main, [
        "--device", "cpu", "--reps", "1", "--modes",
        "lstm,nolstm,noprefetch"])
    toks = list(res["tokens"].values())
    assert len(toks) == 3 and all(t == toks[0] for t in toks)
    assert all(res["finished"].values())
    assert "# summary (tok/s per rep)" in text
