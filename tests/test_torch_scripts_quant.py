"""The ported KV-quantization accuracy scripts against the JAX package on
the CPU, on the same converted weights and tokens, at float32 attention
compute (`tests/torch_surface.py`'s pairing):

- kv_quant_ppl: the port's `mean_nll` (echo scoring through the engine's
  prompt logprobs) equals the JAX script's `mean_nll`
  (`scripts/kv_quant_ppl.py:44`, loaded from its file with the process's
  JAX settings and environment restored afterwards) per KV scheme, and at
  W8A16, within 2e-4 nats a token (LP_TOL);
- kv_quant_accuracy: the port's per-scheme mean KL, logprob delta and
  greedy agreement (`scheme_metrics`) equal a restatement of
  `scripts/kv_quant_accuracy.py:52-96` on the JAX `prefill_chunk`,
  `decode_step` and `forward_dense` within 2e-4 (agreement exactly), at
  the tiny preset with 2 sequences of 16 + 4 tokens.
"""

import dataclasses
import importlib.util
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxl_speckv_tpu.config import KVDtype as JKV
from cxl_speckv_tpu.models.configs import tiny_test_config as j_tiny
from cxl_speckv_tpu.models.llama import decode_step as j_decode_step
from cxl_speckv_tpu.models.llama import forward_dense as j_forward_dense
from cxl_speckv_tpu.models.llama import init_params as j_init_params
from cxl_speckv_tpu.models.llama import prefill_chunk as j_prefill_chunk
from cxl_speckv_tpu.ops.quant import kv_storage_dtype as j_storage
from cxl_speckv_tpu_torch.models.configs import tiny_test_config
from cxl_speckv_tpu_torch.models.convert import params_from_jax
from cxl_speckv_tpu_torch.scripts import kv_quant_accuracy as kqa
from cxl_speckv_tpu_torch.scripts import kv_quant_ppl as kpp

REPO = Path(__file__).resolve().parent.parent
LP_TOL = 2e-4
SCHEMES = ("bf16", "int8", "fp8", "int4")
JCFG = dataclasses.replace(j_tiny(), attn_compute_dtype="float32")
CFG = dataclasses.replace(tiny_test_config(), attn_compute_dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and these tests' many small ops slow down many times over when each
    process's thread pool contends for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    jp = j_init_params(j_tiny(), jax.random.PRNGKey(42))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp))


def load_jax_script(name: str):
    """The JAX package's script module, loaded from its file; the module
    sets SPECKV_INTERPRET and the JAX platform when imported
    (`kv_quant_ppl.py:19-25`), so both are put back afterwards."""
    env = os.environ.get("SPECKV_INTERPRET")
    platforms = jax.config.jax_platforms
    try:
        spec = importlib.util.spec_from_file_location(
            f"jax_{name}", REPO / "scripts" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        if env is None:
            os.environ.pop("SPECKV_INTERPRET", None)
        else:
            os.environ["SPECKV_INTERPRET"] = env
        jax.config.update("jax_platforms", platforms)
    return mod


def test_port_module_import_has_no_side_effect():
    env = dict(os.environ)
    import importlib

    importlib.reload(kpp)
    assert dict(os.environ) == env


@pytest.mark.parametrize("scheme,wq", [(s, "native") for s in SCHEMES]
                         + [("bf16", "int8")])
def test_kv_quant_ppl_mean_nll_matches_jax(weights, scheme, wq):
    jp, params = weights
    jmod = load_jax_script("kv_quant_ppl")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, CFG.vocab_size, 40).tolist() for _ in range(2)]
    want = jmod.mean_nll(JCFG, jp, JKV(scheme), prompts, 16,
                         weight_dtype=wq)
    got = kpp.mean_nll(CFG, params, scheme, prompts, 16, weight_dtype=wq,
                       device="cpu")
    assert abs(got - want) <= LP_TOL, (got, want)


def jax_scheme_metrics(jp, scheme, seqs, prompt):
    """`scripts/kv_quant_accuracy.py:157-204` for one scheme, restated on
    the JAX functions (bs 16, table blocks 1 .., fresh pools a sequence)."""
    c, kv = JCFG, JKV(scheme)
    bs = 16
    kls, agrees, dlps = [], [], []
    for tokens in seqs:
        total = len(tokens)
        max_blocks = -(-total // bs) + 1
        slots = max_blocks + 2
        pack = 2 if kv == JKV.INT4 else 1
        kp = jnp.zeros((c.num_layers, slots, c.head_dim // pack,
                        c.num_kv_heads * bs), j_storage(kv))
        vp = jnp.zeros((c.num_layers, slots, c.num_kv_heads, bs,
                        c.head_dim // pack), j_storage(kv))
        sc = jnp.ones((c.num_layers, slots, 1, c.num_kv_heads * bs))
        vs = jnp.ones_like(sc)
        table = jnp.arange(1, max_blocks + 1, dtype=jnp.int32)[None]
        lg, kp, vp, sc, vs = j_prefill_chunk(
            jp, c, kv, jnp.asarray(tokens[:prompt]), jnp.int32(0), kp, vp,
            sc, vs, table[0])
        logits = [lg]
        for t in range(prompt, total):
            lg, kp, vp, sc, vs = j_decode_step(
                jp, c, kv, jnp.asarray(tokens[t])[None],
                jnp.array([t], jnp.int32), kp, vp, sc, vs, table,
                jnp.array([t + 1], jnp.int32))
            logits.append(lg[0])
        got = np.stack([np.asarray(x) for x in logits])
        ref = np.asarray(j_forward_dense(jp, c, jnp.asarray(tokens)[None])[0])
        ref = ref[prompt - 1:]
        p_ref = jax.nn.softmax(jnp.asarray(ref), axis=-1)
        lp_ref = jax.nn.log_softmax(jnp.asarray(ref), axis=-1)
        lp_got = jax.nn.log_softmax(jnp.asarray(got), axis=-1)
        kls.append(float(jnp.mean(jnp.sum(p_ref * (lp_ref - lp_got), -1))))
        agrees.append(float((got.argmax(-1) == ref.argmax(-1)).mean()))
        nxt = jnp.asarray(tokens[prompt:])[:, None]
        dlps.append(float(jnp.mean(
            jnp.take_along_axis(lp_ref[:-1], nxt, 1)
            - jnp.take_along_axis(lp_got[:-1], nxt, 1))))
    return {"mean_kl": float(np.mean(kls)),
            "greedy_agreement": float(np.mean(agrees)),
            "logprob_delta": float(np.mean(dlps))}


@pytest.mark.parametrize("scheme", SCHEMES)
def test_kv_quant_accuracy_matches_jax(weights, scheme):
    jp, params = weights
    seqs = kqa.draw_seqs(np.random.RandomState(0), 2, 20, CFG.vocab_size)
    got = kqa.scheme_metrics(CFG, params, scheme, seqs, 16, "cpu")
    want = jax_scheme_metrics(jp, scheme, seqs, 16)
    for k in ("mean_kl", "logprob_delta"):
        assert abs(got[k] - want[k]) <= 2e-4, (k, got[k], want[k])
    assert got["greedy_agreement"] == want["greedy_agreement"]
    assert got["compression"] == JKV(scheme).compression_ratio


def test_kv_quant_scripts_print_their_tables():
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ppl = kpp.main(["--device", "cpu", "--seqs", "2", "--len", "24",
                        "--chunk", "8"])
        acc = kqa.main(["--device", "cpu", "--seqs", "1", "--prompt", "8",
                        "--decode", "4"])
    text = buf.getvalue()
    assert list(ppl["kv"]) == list(SCHEMES)
    assert set(ppl["weights"]) == {(w, s) for w in ("int8", "int4")
                                   for s in ("bf16", "int8")}
    assert list(acc) == list(SCHEMES)
    assert all(np.isfinite(list(r.values())).all() for r in acc.values())
    assert text.count("nll/token") == 8 and '"int4": {"mean_kl"' in text
