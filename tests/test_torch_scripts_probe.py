"""The ported probe scripts (`cxl_speckv_tpu_torch/scripts/`) against the
JAX package, on the CPU at small sizes:

- round_anatomy: `decompose` equals the JAX script's formulas
  (`scripts/round_anatomy.py:157-200`, restated here in numpy) on a
  synthetic table within 1e-12 relative; `weight_gb` of a converted W8A16
  tree equals the JAX count (`:112-121`) on the JAX tree exactly (W4A16:
  the port counts the packed bytes); `packed_for` equals `:97-110`'s array;
  `decode_multi_packed`'s greedy tokens at horizon 1 and 2 equal the JAX
  `decode_multi_packed(use_pallas=False)` on the same weights, pools and
  packed input at float32 attention compute (or diverge first at a
  near-tie, the reference's rule);
- kernel_probe / kernel_bench: two dependent iterations of K1's plain
  version (the loop the scripts time) equal two of the JAX `paged_attention`
  in interpret mode within rtol = atol = 2e-4, unsplit and in the split
  form; the command lines print every (scheme, block size, splits) and
  (scheme, ctx) point;
- tpu_window_check: the case list equals the JAX script's, and each case's
  plain version equals the numpy statement of its window mask and softcap
  within 1e-5 (a statement without the window misses by far more);
- hostop_probe: programs A-D on a CPU store gather the bytes
  `index_select` gives.
"""

import contextlib
import dataclasses
import io
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxl_speckv_tpu.config import KVDtype as JKV
from cxl_speckv_tpu.models.configs import tiny_test_config as j_tiny
from cxl_speckv_tpu.models.llama import decode_multi_packed as j_decode_multi
from cxl_speckv_tpu.models.llama import init_params as j_init_params
from cxl_speckv_tpu.ops.paged_attention import paged_attention as j_k1
from cxl_speckv_tpu.ops.wquant import QuantizedTensor as JQT
from cxl_speckv_tpu.ops.wquant import quantize_weights as j_quantize
from cxl_speckv_tpu_torch.config import KVDtype
from cxl_speckv_tpu_torch.models.configs import tiny_test_config
from cxl_speckv_tpu_torch.models.convert import params_from_jax
from cxl_speckv_tpu_torch.models.llama import decode_multi_packed
from cxl_speckv_tpu_torch.scripts import hostop_probe as hp
from cxl_speckv_tpu_torch.scripts import kernel_bench, kernel_probe as kp
from cxl_speckv_tpu_torch.scripts import round_anatomy as ra
from cxl_speckv_tpu_torch.scripts import tpu_window_check as twc

REPO = Path(__file__).resolve().parent.parent
NEAR_TIE = 0.06


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
    """(fn's result, what it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **kw)
    return out, buf.getvalue()


# ---------------------------------------------------------------------------
# round_anatomy
# ---------------------------------------------------------------------------

def jax_decomposition(results, wgb, kvgb, horizons, ctxs):
    """`scripts/round_anatomy.py:160-180`, as the script computes it."""
    hi, lo = max(horizons), min(horizons)
    cb_hi, cb_lo = max(ctxs), min(ctxs)
    slope = {wq: (results[(wq, hi, cb_lo)] - results[(wq, lo, cb_lo)])
             / (hi - lo) for wq in ("bf16", "int8")}
    dispatch = {wq: results[(wq, lo, cb_lo)] - lo * slope[wq]
                for wq in ("bf16", "int8")}
    rate = (wgb["bf16"] - wgb["int8"]) / (slope["bf16"] - slope["int8"])
    kvstep = (results[("int8", hi, cb_hi)] - results[("int8", hi, cb_lo)]) / (
        hi - lo)
    kv_rate = (kvgb(cb_hi) - kvgb(cb_lo)) / kvstep
    w_int8_s = wgb["int8"] / rate
    kv_lo_s = kvgb(cb_lo) / kv_rate
    return {"dispatch": dispatch, "slope": slope, "rate_gbs": rate,
            "kv_rate_gbs": kv_rate, "w_int8_s": w_int8_s, "kv_lo_s": kv_lo_s,
            "resid": slope["int8"] - w_int8_s - kv_lo_s,
            "round16_s": dispatch["int8"] + 16 * slope["int8"]}


def test_round_anatomy_decompose_matches_jax_formulas():
    rng = np.random.RandomState(5)
    horizons, ctxs = (1, 4, 16), (2, 8)
    results = {}
    for wq, per_step in (("bf16", 0.004), ("int8", 0.003)):
        for h in horizons:
            for cb in ctxs:
                results[(wq, h, cb)] = (0.02 + h * (per_step + cb * 1e-5)
                                        + rng.rand() * 1e-4)
    wgb = {"bf16": 2.47, "int8": 1.50}
    kvgb = lambda cb: ra.kv_gb_per_step(tiny_test_config(), 8, 32, cb)
    got = ra.decompose(results, wgb, kvgb, horizons, ctxs)
    want = jax_decomposition(results, wgb, kvgb, horizons, ctxs)
    for k, w in want.items():
        g = got[k]
        for a, b in ((g, w),) if not isinstance(w, dict) else \
                ((g[x], w[x]) for x in w):
            assert abs(a - b) <= 1e-12 * abs(b), (k, a, b)


def jax_weight_bytes(tree) -> int:
    """`scripts/round_anatomy.py:112-121` in bytes (before the / 1e9)."""
    tot = 0
    for x in jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, JQT)):
        if isinstance(x, JQT):
            tot += x.q.size * x.q.dtype.itemsize + x.s.size * 4
        else:
            tot += x.size * x.dtype.itemsize
    return tot


@pytest.fixture(scope="module")
def jparams():
    return j_init_params(j_tiny(), jax.random.PRNGKey(3))


def as_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def test_round_anatomy_weight_gb_matches_jax_count(jparams):
    q8 = j_quantize(jparams)
    port = params_from_jax(as_numpy(q8))
    assert ra.weight_gb(port) == jax_weight_bytes(q8) / 1e9
    assert ra.weight_gb(params_from_jax(as_numpy(jparams))) == \
        jax_weight_bytes(jparams) / 1e9
    # W4A16: the JAX count takes an int4 q at one byte a value; the port
    # counts its packed bytes, two values a byte
    q4 = j_quantize(jparams, bits=4)
    int4_values = sum(x.q.size for x in jax.tree.leaves(
        q4, is_leaf=lambda x: isinstance(x, JQT))
        if isinstance(x, JQT) and x.q.dtype.name == "int4")
    assert int4_values > 0
    assert ra.weight_gb(params_from_jax(as_numpy(q4))) == \
        (jax_weight_bytes(q4) - int4_values // 2) / 1e9


@pytest.mark.parametrize("ctx_blocks", [1, 2, 8])
def test_round_anatomy_packed_matches_jax_layout(ctx_blocks):
    """`:97-110` restated: first token 7 at ctx * bs - 2, greedy, counter
    1, guard-filled rows of B's slot ranges."""
    for B, bs, mb in ((2, 8, 16), (8, 32, 16)):
        slots = B * mb + 1
        want = np.zeros((B, 4 + mb), np.int32)
        want[:, 0], want[:, 1], want[:, 2], want[:, 3] = \
            7, ctx_blocks * bs - 2, 0, 1
        want[:, 4:] = slots - 1
        for b in range(B):
            want[b, 4:4 + mb] = np.arange(b * mb, (b + 1) * mb)
        got = ra.packed_for(B, bs, mb, slots, ctx_blocks)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("horizon", [1, 2])
def test_round_anatomy_decode_matches_jax(jparams, horizon):
    jcfg = dataclasses.replace(j_tiny(), attn_compute_dtype="float32")
    cfg = dataclasses.replace(tiny_test_config(),
                              attn_compute_dtype="float32")
    params = params_from_jax(as_numpy(jparams))
    g = ra.geometry(smoke=True)
    B, bs, mb, S = g["B"], g["bs"], g["max_blocks"], g["num_slots"]
    for cb in g["ctxs"]:
        pk = ra.packed_for(B, bs, mb, S, cb)
        pools = ra.fresh_pools(cfg, S, bs, "cpu")
        got, logits = decode_multi_packed(params, cfg, KVDtype.INT8, pk, pools,
                                          horizon=horizon, return_logits=True)
        c = jcfg
        jpools = (jnp.zeros((c.num_layers, S, c.head_dim,
                             c.num_kv_heads * bs), jnp.int8),
                  jnp.zeros((c.num_layers, S, c.num_kv_heads, bs, c.head_dim),
                            jnp.int8),
                  jnp.ones((c.num_layers, S, 1, c.num_kv_heads * bs)),
                  jnp.ones((c.num_layers, S, 1, c.num_kv_heads * bs)))
        want = np.asarray(j_decode_multi(jparams, jcfg, JKV.INT8,
                                         jnp.asarray(pk), *jpools,
                                         horizon=horizon,
                                         use_pallas=False)[0])
        got = got.numpy()
        for b in range(B):
            d = np.flatnonzero(got[b] != want[b])
            if d.size:
                j = d[0]
                top = torch.topk(logits[b, j], 2)
                assert {int(got[b, j]), int(want[b, j])} == \
                    set(top.indices.tolist())
                assert float(top.values[0] - top.values[1]) <= NEAR_TIE


# ---------------------------------------------------------------------------
# kernel_probe / kernel_bench
# ---------------------------------------------------------------------------

TINY_HEADS = (8, 2, 32)


def jax_pool(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("scheme", ["int8", "int4", "bf16"])
@pytest.mark.parametrize("splits,cd", [(1, torch.bfloat16),
                                       (1, torch.float32),
                                       (2, torch.float32)])
def test_kernel_probe_loop_matches_jax_kernel(scheme, splits, cd):
    """Two dependent iterations (q <- attention(q), `kernel_probe.py:56-62`)
    at B 2, Hq 8, Hkv 2, D 32, bs 8, ctx 64, float32 q: the port's loop on
    the plain version (split form at S 2) against the JAX kernel in
    interpret mode, within rtol = atol = 2e-4. At bf16 compute the split
    form rounds p * v_scale to bf16 against each split's own running max,
    so there it is held at S 1 (the unsplit walk the TPU kernel makes)."""
    p = kp.probe_pools(scheme, 8, 64, 2, 0, 7, "cpu", heads=TINY_HEADS)
    step, state = kp.dependent_loop(p, splits, cd)
    state["q"] = p.q
    step()
    step()
    S = p.k.shape[0]
    kt = jax_pool(p.kt)
    flat = lambda s: jnp.asarray(s.reshape(S, 1, -1).numpy())
    q = jnp.asarray(p.q.numpy())
    for _ in range(2):
        q = j_k1(q, kt, jax_pool(p.v), flat(p.ks), flat(p.vs),
                 jnp.asarray(p.table.numpy()), jnp.asarray(p.lens.numpy()),
                 JKV(scheme), interpret=True,
                 compute_dtype=jnp.bfloat16 if cd == torch.bfloat16
                 else jnp.float32).astype(q.dtype)
    np.testing.assert_allclose(state["q"].numpy(), np.asarray(q), rtol=2e-4,
                               atol=2e-4)


def test_kernel_probe_labels_cover_the_sweep():
    argv = ["--device", "cpu", "--ctx", "64", "--batch", "2", "--bs", "8,16",
            "--minpool", "0", "--iters", "1", "--splits", "1,S,2S,4S"]
    rows, text = quiet(kp.main, argv)
    want = set()
    for scheme in ("int8", "int4", "bf16"):
        for bs in (8, 16):
            p = kp.probe_pools(scheme, bs, 64, 2, 0, 0, "cpu")
            for n in kp.split_counts("1,S,2S,4S", kp.rule_splits(p, "cpu")):
                want.add((scheme, bs, n))
                assert kp.point_label(scheme, bs, n) in text
    assert set(rows) == want
    assert kp.split_counts("1,S,2S,4S", 20) == [1, 20, 40, 64]
    assert kp.split_counts("1,S,2S", 1) == [1, 2]


def test_kernel_bench_points(monkeypatch):
    monkeypatch.setattr(kernel_bench, "BATCH", 1)       # small on the CPU
    monkeypatch.setattr(kernel_bench, "MINPOOL", 0)
    rows, text = quiet(kernel_bench.main, [
        "--device", "cpu", "--ctx", "64", "--schemes", "int8"])
    assert list(rows) == [("int8", 64)]
    assert "int8  ctx=   64" in text and "host CPU" in text


# ---------------------------------------------------------------------------
# tpu_window_check
# ---------------------------------------------------------------------------

def test_window_check_cases_match_jax_script():
    src = (REPO / "scripts" / "tpu_window_check.py").read_text()
    schemes = re.search(r"for kv_dtype in \(([^)]*)\)", src).group(1)
    assert [s.split(".")[-1].lower() for s in schemes.split(",") if s.strip()] \
        == list(twc.SCHEMES)
    pairs = re.search(r"for win, cap in \((.*)\):", src).group(1)
    want = [tuple(None if x.strip() == "None" else
                  (twc.WINDOW if x.strip() == "window" else float(x))
                  for x in pair.split(","))
            for pair in re.findall(r"\(([^()]*)\)", pairs)]
    assert list(twc.VARIANTS) == want
    assert "mb, window = 32, 200" in src and "T = 8" in src
    assert (twc.MB, twc.WINDOW, twc.T) == (32, 200, 8)
    assert len(twc.CASES) == 18


def test_window_check_plain_matches_numpy_statement():
    errs, _ = quiet(twc.main, ["--device", "cpu"])
    assert set(errs) == set(twc.CASES)
    assert max(errs.values()) < 1e-5, errs
    # the statement binds: without the window it misses the plain version
    data = twc.scheme_data("int8", np.random.RandomState(0), "cpu")
    got, _ = twc.case_pair(data, "decode", twc.WINDOW, None, "cpu")
    assert twc.rel_err(got, twc.numpy_case(data, "decode", None, None)) > 1e-2


# ---------------------------------------------------------------------------
# hostop_probe
# ---------------------------------------------------------------------------

def test_hostop_programs_gather_index_select_bytes():
    store = hp.make_store("cpu", seed=4)
    for name, fn in (("A", hp.prog_a), ("B", hp.prog_b), ("C", hp.prog_c)):
        hp.check(name, store, fn(store, "cpu"))
    hp.check("D", store, hp.prog_d(store, "cpu", None))
    out = hp.prog_a(store, "cpu")
    out[3][1][0, 0, 0, 0] += 1             # a wrong byte is caught
    with pytest.raises(AssertionError):
        hp.check("A", store, out)
    res, text = quiet(hp.main, ["--device", "cpu", "--reps", "1"])
    assert [res[k]["copies"] for k in "ABCD"] == [8192, 2048, 512, 8192]
    assert text.count("bytes == index_select") == 4
