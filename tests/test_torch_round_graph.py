"""The decode round as one dispatch (`models/round_graph.py`), what of it
runs without a card: on `tiny_test_config()`, 2 lanes, horizon 3.

- The round from its uploaded buffer (`round_from_buffer`, the function a
  CUDA graph captures, sampling words decoded from the buffer) equals the
  round as `decode_multi_packed` composed it before (words decoded on the
  host and copied), bit for bit: tokens, pools, logprobs, pen counts and
  the LSTM leg's continue probability; and its tokens equal the JAX
  `decode_multi_packed`'s (Pallas in interpret mode), pools as
  `_assert_pools_equal` holds them, logprobs and the continue probability
  within 1e-5 (float32 sums in another order), pen counts exactly.
- Sampled lanes at one seed are bit-equal between the two port paths.
- The per-(config, device) RoPE cache holds `layer_ropes`'s values.
- The key, the launch-counter bookkeeping (`LaunchDelta`) and the CPU
  engine's eager route.

The capture and replay themselves need the card:
`tests/test_torch_round_graph_cuda.py`.
"""

from collections import Counter
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_llama import (
    CFG,
    JCFG,
    JPARAMS,
    MB,
    SLOTS,
    _assert_pools_equal,
    _jax_pools,
    _schemes,
    _torch_pools,
    carried,
)

from cxl_speckv_tpu.models import llama as jl
from cxl_speckv_tpu.prefetcher import lstm as jlstm
from cxl_speckv_tpu_torch.config import KVDtype
from cxl_speckv_tpu_torch.engine.sampling import decode_sampling, encode_sampling
from cxl_speckv_tpu_torch.models import configs
from cxl_speckv_tpu_torch.models import llama as tl
from cxl_speckv_tpu_torch.models.convert import lstm_params_from_jax
from cxl_speckv_tpu_torch.models.round_graph import (
    LaunchDelta,
    RoundGraphs,
    _snapshot,
    launch_counters,
    round_key,
)

H = 3                     # horizon
LP_K = 3                  # logprobs top-k
HIST = 16                 # LSTM history columns
BUCKETS = 64              # LSTM classes
TOL = 1e-5
TABLES = np.array([[3, 7, 1, SLOTS], [10, 0, 5, SLOTS]], np.int32)
PARAMS = carried(JPARAMS)


def todays_round(params, kv, packed, pools, pen_info=None, pen_counts=None,
                 lstm_params=None, *, rng_seed=0, logprobs_k=0, lstm_eos=-1,
                 lstm_cols=0):
    """The eager round as `decode_multi_packed` composed it before the
    static buffer: the sampling words decoded on the host and copied to
    the device, then `decode_multi`."""
    temps, top_ps = decode_sampling(torch.from_numpy(packed[:, 2]))
    sampled, nucleus = tl.round_flags(packed[:, 2])
    w = packed.shape[1]
    tw = w - lstm_cols
    p = tl._upload(packed, pen_info if pen_counts is not None else None,
                   "cpu")
    gen = (tl.seeded_generator("cpu", rng_seed, int(packed[0, 3]))
           if sampled else None)
    return tl.decode_multi(
        params, CFG, kv, p[:, 0], p[:, 1], pools, p[:, 4:tw], gen, temps,
        top_ps, p[:, w:] if pen_counts is not None else None, pen_counts,
        lstm_params, p[:, tw:w] if lstm_params is not None else None,
        horizon=H, sampled=sampled, nucleus=nucleus, logprobs_k=logprobs_k,
        lstm_eos=lstm_eos)


def packed_round(seed, lstm_cols=0, words=(0, 0), counter=5):
    """[2, 4 + MB + lstm_cols]: lane 0 at position 9, lane 1 at 2 (over
    pools the round fills itself), the tables, then the histories."""
    rng = np.random.RandomState(seed)
    p = np.zeros((2, 4 + MB + lstm_cols), np.int32)
    p[:, 0] = rng.randint(1, CFG.vocab_size, 2)
    p[:, 1] = (9, 2)
    p[:, 2] = words
    p[:, 3] = counter
    p[:, 4:4 + MB] = TABLES
    if lstm_cols:
        p[:, 4 + MB:] = rng.randint(0, BUCKETS, (2, lstm_cols))
    return p


def pen_inputs(seed):
    """pen_info [2, 5] (lane 0 penalized on row 0, lane 1 on the guard
    row) and a plane [2 + 1, V] holding earlier counts and prompt bits."""
    from cxl_speckv_tpu_torch.engine.sampling import (
        PEN_PROMPT_BIT,
        encode_pen_info,
    )

    rng = np.random.RandomState(seed)
    info = np.array([encode_pen_info(0, 0.5, 0.3, 1.3),
                     encode_pen_info(2, 0.0, 0.0, 0.0)], np.int32)
    plane = rng.randint(0, 3, (3, CFG.vocab_size)).astype(np.int32)
    plane[0, rng.randint(0, CFG.vocab_size, 20)] |= PEN_PROMPT_BIT
    plane[2] = 0
    return info, plane


def lstm_twins():
    j = jlstm.LSTMPredictor(CFG.vocab_size, seed=4, vocab_buckets=BUCKETS)
    return j.params, lstm_params_from_jax(jax.tree.map(np.asarray, j.params))


def assert_bitwise(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert torch.equal(a, b), what


@pytest.mark.parametrize("full", [False, True], ids=["greedy", "pen-lp-lstm"])
@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_static_buffer_round_equals_eager_and_jax(kv, full):
    """`decode_multi_packed` (now `round_from_buffer`) against the round
    composed as before, bit for bit, and against the JAX round."""
    jkv, tkv, _ = _schemes(kv)
    cols = HIST if full else 0
    packed = packed_round(1, cols)
    kw, jkw = {}, {}
    pen_info = plane = None
    if full:
        pen_info, plane = pen_inputs(2)
        jtree, ttree = lstm_twins()
        eos = CFG.eos_token_id % BUCKETS
        kw = dict(lstm_params=ttree, logprobs_k=LP_K, lstm_eos=eos,
                  lstm_cols=cols)
        jkw = dict(pen_info=jnp.asarray(pen_info),
                   pen_counts=jnp.asarray(plane), lstm_params=jtree,
                   logprobs_k=LP_K, lstm_eos=eos, lstm_cols=cols)
    before, now = _torch_pools(kv), _torch_pools(kv)
    pc_before = torch.from_numpy(plane.copy()) if full else None
    pc_now = torch.from_numpy(plane.copy()) if full else None
    want = todays_round(PARAMS, tkv, packed, before, pen_info, pc_before,
                        **kw)
    got = tl.decode_multi_packed(PARAMS, CFG, tkv, packed, now, pen_info,
                                 pc_now, horizon=H, **kw)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want) == (5 if full else 1)
    for i, (a, b) in enumerate(zip(got, want)):
        assert_bitwise(a, b, f"output {i}")
    for i, (a, b) in enumerate(zip(now, before)):
        assert_bitwise(a, b, f"pool {i}")
    if full:
        assert_bitwise(pc_now, pc_before, "pen counts")

    out = jl.decode_multi_packed(JPARAMS, JCFG, jkv, jnp.asarray(packed),
                                 *_jax_pools(kv), horizon=H, use_pallas=True,
                                 **jkw)
    jtoks = np.asarray(out[0])
    np.testing.assert_array_equal(got[0].numpy(), jtoks[:, :H])
    _assert_pools_equal(out[1:5], now, kv)
    if full:
        for a, b in zip(got[1:4], out[5:8]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=TOL)
        pcont = jtoks[:, H].view(np.float32)
        np.testing.assert_allclose(got[4].numpy(), pcont, rtol=0, atol=TOL)
        np.testing.assert_array_equal(pc_now.numpy(), np.asarray(out[-1]))


def test_sampled_lanes_bit_equal_between_port_paths():
    """Temperature and nucleus lanes beside a greedy one, at one seed: the
    buffer round draws what the round composed as before draws."""
    words = (encode_sampling(0.9, 0.8), encode_sampling(0.0))
    packed = packed_round(3, words=words, counter=11)
    assert tl.round_flags(packed[:, 2]) == (True, True)
    before, now = _torch_pools("int8"), _torch_pools("int8")
    want = todays_round(PARAMS, KVDtype.INT8, packed, before, rng_seed=7)
    got = tl.decode_multi_packed(PARAMS, CFG, KVDtype.INT8, packed, now,
                                 horizon=H, rng_seed=7)
    assert_bitwise(got, want, "tokens")
    for i, (a, b) in enumerate(zip(now, before)):
        assert_bitwise(a, b, f"pool {i}")


@pytest.mark.parametrize("make", [configs.tiny_test_config,
                                  configs.llama_3_8b, configs.gemma3_12b])
def test_cached_ropes_equal_layer_ropes(make):
    """The cached frequencies are `rope_frequency_pair`'s picked per layer,
    made once per (config, device)."""
    c = make()
    glob, loc = tl.rope_frequency_pair(c)
    want = [tl.pick_rope((glob, loc), w) for w in c.layer_windows()]
    got = tl.layer_ropes(c, "cpu")
    assert len(got) == len(want) == c.num_layers
    for a, b in zip(got, want):
        assert_bitwise(a, b, "inverse frequencies")
    again = tl.layer_ropes(c, torch.device("cpu"))
    assert all(a is b for a, b in zip(again, got))


def test_embed_scale_rounds_to_the_activation_dtype():
    """Gemma's sqrt(H), made once on the device, rounded to bf16 first."""
    s = tl._device_scalar(3584 ** 0.5, torch.bfloat16, torch.device("cpu"))
    assert s.dtype == torch.bfloat16 and float(s) == 59.75
    assert s is tl._device_scalar(3584 ** 0.5, torch.bfloat16,
                                  torch.device("cpu"))


KEY_BASE = dict(pen=False, lstm=False, horizon=32, sampled=False,
                nucleus=False, return_logits=False, logprobs_k=0,
                lstm_eos=-1, lstm_cols=0, bound=(1, (2, 3, 4, 5), None))
KEY_CHANGES = [("shape", (8, 20)), ("kv", KVDtype.INT4),
               ("kv", (KVDtype.INT8, KVDtype.FP8)), ("pen", True),
               ("lstm", True), ("horizon", 16), ("sampled", True),
               ("nucleus", True), ("return_logits", True),
               ("logprobs_k", 20), ("bound", (9, (2, 3, 4, 5), None)),
               ("bound", (1, (2, 3, 4, 6), None)),
               ("bound", (1, (2, 3, 4, 5), 7))]


@pytest.mark.parametrize("field,value", KEY_CHANGES,
                         ids=[f"{f}-{i}" for i, (f, _) in
                              enumerate(KEY_CHANGES)])
def test_round_key_differs_in_each_field(field, value):
    base = dict(KEY_BASE)
    key = round_key((8, 24), KVDtype.INT8, **base)
    assert key == round_key((8, 24), KVDtype.INT8, **dict(KEY_BASE))
    shape, kv = (8, 24), KVDtype.INT8
    if field == "shape":
        shape = value
    elif field == "kv":
        kv = value
    else:
        base[field] = value
    assert round_key(shape, kv, **base) != key


def test_round_key_lstm_fields_count_with_the_leg():
    """lstm_eos and lstm_cols are static only where the leg runs."""
    on = dict(KEY_BASE, lstm=True, lstm_eos=3, lstm_cols=16)
    assert (round_key((8, 40), KVDtype.INT8, **on)
            != round_key((8, 40), KVDtype.INT8, **dict(on, lstm_eos=4)))
    off = dict(KEY_BASE, lstm_eos=3)
    assert (round_key((8, 24), KVDtype.INT8, **off)
            == round_key((8, 24), KVDtype.INT8, **dict(off, lstm_eos=4)))


def fake_counters():
    k1 = SimpleNamespace(launches=Counter({("int8", 0): 5}),
                         split_launches=Counter())
    mm = SimpleNamespace(launches=Counter(), tied_launches=2)
    return [(k1, "launches"), (k1, "split_launches"), (mm, "launches"),
            (mm, "tied_launches")], k1, mm


def test_launch_delta_adds_once_per_replay():
    """A capture's counts come back out, and each replay adds them once;
    an integer count replaced between replays (a reset) still adds."""
    counters, k1, mm = fake_counters()
    before = _snapshot(counters)
    # what a capture's wrappers count: 2 layers x 3 steps, a tied head
    k1.launches["int8", 0] += 6
    k1.split_launches[1] += 6
    mm.launches["bfloat16"] += 21
    mm.tied_launches += 3
    delta = LaunchDelta(counters, before)
    delta.apply(-1)
    assert k1.launches == Counter({("int8", 0): 5})
    assert +k1.split_launches == Counter() and +mm.launches == Counter()
    assert mm.tied_launches == 2
    for _ in range(4):
        delta.apply(+1)
    assert k1.launches == Counter({("int8", 0): 5 + 4 * 6})
    assert k1.split_launches == Counter({1: 24})
    assert mm.launches == Counter({"bfloat16": 84})
    assert mm.tied_launches == 2 + 12
    mm.tied_launches = 0
    delta.apply(+1)
    assert mm.tied_launches == 3


def test_launch_counters_name_live_counts():
    """Every counter the cache keeps exact exists, as a Counter or an int."""
    names = set()
    for owner, attr in launch_counters():
        v = getattr(owner, attr)
        assert isinstance(v, (Counter, int)), (owner, attr)
        names.add(attr)
    assert {"launches", "sink_launches", "split_launches", "tied_launches",
            "quantized_calls", "calls"} <= names


def test_round_graphs_needs_a_card():
    with pytest.raises(ValueError, match="CUDA device"):
        RoundGraphs("cpu")


def test_cpu_engine_rounds_are_eager():
    """A CPU engine builds no cache and names its route: every decode
    round eager, none replayed."""
    from test_torch_engine import engine, prompts

    eng = engine(batch=2, horizon=3)
    assert eng.round_graphs is None
    for p in prompts(3):
        eng.add_request(p, max_new_tokens=7)
    eng.run()
    st = eng.get_statistics()
    e = st["engine"]
    assert e["round_route"] == "eager: cpu"
    assert e["graph_rounds"] == e["graph_captures"] == e["graphs_held"] == 0
    assert e["eager_rounds"] == st["scheduler"]["decode_batches"] > 0
    eng.reset_statistics()
    assert eng.get_statistics()["engine"]["eager_rounds"] == 0
