"""Decode rounds captured in CUDA graphs and replayed
(`models/round_graph.py`) against the eager round, on the card. Every
test here needs an NVIDIA card and `nvcc` and skips without them; on the
card run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_round_graph_cuda.py

(`--noconftest`: the JAX test settings in tests/conftest.py import jax).

- Graph and eager rounds are bit-equal over a key's eager round, its
  capture and three replays with changed packed inputs and tables:
  tokens, pools, logprobs, pen counts, the LSTM leg and `return_logits`
  logits; sampled lanes at one seed too (the graph's registered generator
  is reseeded to the eager round's seed before each replay).
- The launch counters after the graph rounds equal the eager rounds'
  exactly (K1 = rounds x horizon x layers, `w8a16_mm` = int8 matmul calls).
- A capture succeeds while another thread copies host -> device on its own
  stream, as the host tier's stager does, and while graphs of dropped
  caches wait in garbage cycles for the collector.
- New pools drop the graphs; an engine on the card replays every round
  after a key's first and serves what an eager engine serves, also after
  a pool rebuild, and a draft model's proposals replay too.

This file imports no JAX.
"""

import dataclasses
import threading
from collections import Counter

import numpy as np
import pytest
import torch

from cxl_speckv_tpu_torch.config import KVDtype
from cxl_speckv_tpu_torch.engine.sampling import encode_pen_info, encode_sampling
from cxl_speckv_tpu_torch.models import llama as tl
from cxl_speckv_tpu_torch.models.configs import tiny_test_config
from cxl_speckv_tpu_torch.models.round_graph import RoundGraphs
from cxl_speckv_tpu_torch.ops import wquant
from cxl_speckv_tpu_torch.ops.paged_attention import paged_attention
from cxl_speckv_tpu_torch.ops.quant import kv_pack, kv_storage_dtype
from cxl_speckv_tpu_torch.ops.w8a16_mm import w8a16_mm
from cxl_speckv_tpu_torch.prefetcher.lstm import LSTMPredictor, tree_to

pytestmark = pytest.mark.cuda

B, MB, BS, SLOTS, H, HIST = 4, 6, 8, 40, 4, 16
ROUNDS = 5                 # the eager round, the capture, three replays
BF16_CFG = dataclasses.replace(tiny_test_config(), dtype="bfloat16")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def make_params(cfg, dev, bits):
    gen = torch.Generator(device=dev).manual_seed(3)
    return (tl.init_params_quantized(cfg, gen, dev, bits=bits) if bits
            else tl.init_params(cfg, gen, dev))


def make_pools(cfg, kv, dev):
    shape = (cfg.num_layers, SLOTS + 1, cfg.num_kv_heads, BS,
             cfg.head_dim // kv_pack(kv))
    return (torch.zeros(shape, dtype=kv_storage_dtype(kv), device=dev),
            torch.zeros(shape, dtype=kv_storage_dtype(kv), device=dev),
            torch.ones(shape[:-1], device=dev),
            torch.ones(shape[:-1], device=dev))


def packed_rounds(cfg, seed, words, hist_cols=0):
    """ROUNDS packed arrays: every round new first tokens, positions
    further on, a new permutation of the slots in the tables, new
    histories; the sampling words `words` [B] and the counter advance."""
    rng = np.random.RandomState(seed)
    out = []
    for r in range(ROUNDS):
        p = np.zeros((B, 4 + MB + hist_cols), np.int32)
        p[:, 0] = rng.randint(1, cfg.vocab_size, B)
        p[:, 1] = rng.randint(0, 8, B) + r * H
        p[:, 2] = words
        p[:, 3] = 100 + r
        p[:, 4:4 + MB] = rng.permutation(SLOTS)[:B * MB].reshape(B, MB)
        if hist_cols:
            p[:, 4 + MB:] = rng.randint(0, 64, (B, hist_cols))
        out.append(p)
    return out


MODES = {
    # W8A16 at bf16 activations, INT8 KV, penalties, logprobs, the LSTM leg
    "w8-pen-lp-lstm": dict(cfg=BF16_CFG, bits=8, kv=KVDtype.INT8,
                           pen=True, lp=20, lstm=True, logits=False,
                           words=[0] * B),
    # sampled and nucleus lanes beside greedy ones, INT4 KV
    "w8-sampled-int4": dict(cfg=BF16_CFG, bits=8, kv=KVDtype.INT4,
                            pen=False, lp=0, lstm=False, logits=False,
                            words=[encode_sampling(0.8, 0.9),
                                   encode_sampling(1.0), 0,
                                   encode_sampling(0.6, 0.5)]),
    # float32 weights (cuBLAS), the draft's return_logits round, sampled
    "f32-logits": dict(cfg=tiny_test_config(), bits=0, kv=KVDtype.BF16,
                       pen=False, lp=0, lstm=False, logits=True,
                       words=[encode_sampling(0.7)] * B),
}


def run_rounds(mode, dev, graphs, stop=None):
    """The mode's ROUNDS rounds on fresh pools (and pen plane) through
    `decode_multi_packed`; returns (each round's outputs copied to the
    host, pools, pen plane, the launch counters' increments)."""
    m = MODES[mode]
    cfg = m["cfg"]
    params = make_params(cfg, dev, m["bits"])
    pools = make_pools(cfg, m["kv"], dev)
    kw = dict(horizon=H, rng_seed=9, logprobs_k=m["lp"],
              return_logits=m["logits"])
    plane = pen_info = None
    if m["pen"]:
        plane = torch.zeros((3, cfg.vocab_size), dtype=torch.int32,
                            device=dev)
        pen_info = np.array([encode_pen_info(0, 0.4, 0.2, 1.2),
                             encode_pen_info(2), encode_pen_info(1, 0.9),
                             encode_pen_info(2)], np.int32)
    if m["lstm"]:
        pred = LSTMPredictor(cfg.vocab_size, seed=1, vocab_buckets=64)
        kw.update(lstm_params=tree_to(pred.params, dev), lstm_eos=5,
                  lstm_cols=HIST)
    before = {"k1": Counter(paged_attention.launches),
              "w8": Counter(w8a16_mm.launches),
              "q8": wquant.quantized_calls[8]}
    outs = []
    for p in packed_rounds(cfg, 4, m["words"], HIST if m["lstm"] else 0):
        out = tl.decode_multi_packed(params, cfg, m["kv"], p, pools,
                                     pen_info, plane, graphs=graphs, **kw)
        out = out if isinstance(out, tuple) else (out,)
        outs.append([t.cpu() for t in out])
    torch.cuda.synchronize()
    if stop is not None:
        stop()
    k1 = Counter(paged_attention.launches)
    k1.subtract(before["k1"])
    w8 = Counter(w8a16_mm.launches)
    w8.subtract(before["w8"])
    counts = {"k1": sum(k1.values()), "w8": sum(w8.values()),
              "q8": wquant.quantized_calls[8] - before["q8"],
              "layers": cfg.num_layers}
    return (outs, [t.cpu() for t in pools],
            None if plane is None else plane.cpu(), counts)


def assert_same(got, want):
    g_outs, g_pools, g_plane, g_counts = got
    w_outs, w_pools, w_plane, w_counts = want
    for r, (a, b) in enumerate(zip(g_outs, w_outs)):
        assert len(a) == len(b), r
        for i, (x, y) in enumerate(zip(a, b)):
            assert torch.equal(x, y), f"round {r} output {i}"
    for i, (x, y) in enumerate(zip(g_pools, w_pools)):
        assert torch.equal(x, y), f"pool {i}"
    if w_plane is not None:
        assert torch.equal(g_plane, w_plane), "pen counts"
    assert g_counts == w_counts
    assert w_counts["k1"] == ROUNDS * H * w_counts["layers"]


@pytest.mark.parametrize("mode", list(MODES))
def test_graph_rounds_equal_eager(dev, mode):
    """Eager round, capture and three replays against five eager rounds:
    bit-equal outputs, pools and pen counts; launch counts equal."""
    want = run_rounds(mode, dev, None)
    graphs = RoundGraphs(dev)
    got = run_rounds(mode, dev, graphs)
    assert_same(got, want)
    st = graphs.statistics()
    assert (st["eager_rounds"], st["graph_captures"], st["graph_rounds"],
            st["graphs_held"]) == (1, 1, ROUNDS - 1, 1)
    assert st["graph_capture_ms"] > 0 and st["graph_pool_bytes"] > 0
    if MODES[mode]["bits"] == 8:
        assert got[3]["w8"] == got[3]["q8"] > 0


def test_capture_beside_a_copying_thread(dev):
    """A thread copies pinned host memory to the card on its own stream,
    as the stager does, through the capture and the replays: the capture
    (thread_local) succeeds and the rounds equal the eager ones."""
    want = run_rounds("w8-pen-lp-lstm", dev, None)
    src = torch.ones(1 << 22).pin_memory()
    dst = torch.empty(1 << 22, device=dev)
    stream = torch.cuda.Stream(dev)
    done = threading.Event()
    copies = []

    def stager():
        with torch.cuda.stream(stream):
            while not done.is_set():
                dst.copy_(src, non_blocking=True)
                stream.synchronize()
                copies.append(1)

    t = threading.Thread(target=stager, daemon=True)
    t.start()
    try:
        while not copies:
            pass
        graphs = RoundGraphs(dev)
        got = run_rounds("w8-pen-lp-lstm", dev, graphs, stop=done.set)
    finally:
        done.set()
        t.join()
    assert graphs.graph_captures == 1 and len(copies) > 1
    assert_same(got, want)


def test_capture_beside_graphs_in_garbage_cycles(dev, monkeypatch):
    """Caches whose graphs sit in reference cycles (engines dropped) turn
    into garbage in the middle of a capture, with the collector set to run
    at nearly every allocation: the capture succeeds (no collection runs
    inside it: freeing a graph there would end the capture) and the rounds
    equal the eager ones."""
    import gc

    cfg = tiny_test_config()
    params = make_params(cfg, dev, 8)
    ps = packed_rounds(cfg, 6, [0] * B)
    held = []
    for _ in range(2):
        d = RoundGraphs(dev)
        own = make_pools(cfg, KVDtype.INT8, dev)
        for p in ps[:2]:
            tl.decode_multi_packed(params, cfg, KVDtype.INT8, p, own,
                                   horizon=H, graphs=d)
        assert d.graphs_held == 1
        d.cycle = d                    # only the collector can free it
        held.append(d)
    embed = tl._embed

    def dropping_embed(*args, **kw):
        if held and torch.cuda.is_current_stream_capturing():
            held.clear()               # the cycles become garbage here
        return embed(*args, **kw)

    monkeypatch.setattr(tl, "_embed", dropping_embed)
    want_pools = make_pools(cfg, KVDtype.INT8, dev)
    want = [tl.decode_multi_packed(params, cfg, KVDtype.INT8, p, want_pools,
                                   horizon=H).cpu() for p in ps[:3]]
    graphs = RoundGraphs(dev)
    pools = make_pools(cfg, KVDtype.INT8, dev)
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        got = [tl.decode_multi_packed(params, cfg, KVDtype.INT8, p, pools,
                                      horizon=H, graphs=graphs).cpu()
               for p in ps[:3]]
    finally:
        gc.set_threshold(*thresholds)
    assert not held and graphs.graph_captures == 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(pools, want_pools))


def test_new_pools_drop_the_graphs(dev):
    """A round over other pools drops what was captured over the old ones
    and runs its key eagerly again."""
    cfg = tiny_test_config()
    params = make_params(cfg, dev, 8)
    graphs = RoundGraphs(dev)
    ps = packed_rounds(cfg, 2, [0] * B)
    pools = make_pools(cfg, KVDtype.INT8, dev)
    for p in ps[:3]:
        tl.decode_multi_packed(params, cfg, KVDtype.INT8, p, pools,
                               horizon=H, graphs=graphs)
    assert graphs.graphs_held == 1 and graphs.graph_rounds == 2
    fresh = make_pools(cfg, KVDtype.INT8, dev)
    want = tl.decode_multi_packed(params, cfg, KVDtype.INT8, ps[3],
                                  make_pools(cfg, KVDtype.INT8, dev),
                                  horizon=H)
    got = tl.decode_multi_packed(params, cfg, KVDtype.INT8, ps[3], fresh,
                                 horizon=H, graphs=graphs)
    assert torch.equal(got, want)
    st = graphs.statistics()
    assert (st["graphs_held"], st["graph_drops"], st["eager_rounds"]) == (
        0, 1, 2)


def serve(dev, kv=KVDtype.INT8, hbm=14, fused=False, eager=False,
          draft=False, rebuild_to=None):
    """The tiny model (W8A16) served on the card, tiered: greedy, sampled,
    penalized and logprob requests; with `eager` the engine's rounds run
    without graphs. Returns (tokens, statistics, tokens after a rebuild
    to `rebuild_to`)."""
    from cxl_speckv_tpu_torch.config import (
        CacheConfig,
        EngineConfig,
        PrefetchConfig,
        SystemConfig,
    )
    from cxl_speckv_tpu_torch.engine import Engine

    sc = SystemConfig(
        cache=CacheConfig(block_size=8, num_hbm_blocks=hbm,
                          num_host_blocks=256, kv_dtype=kv),
        prefetch=PrefetchConfig(enabled=True, depth=2),
        engine=EngineConfig(max_batch_size=2, max_seq_len=128,
                            prefill_chunk=32, decode_horizon=4,
                            fused_rounds=fused, weight_dtype="int8"))
    eng = Engine(tiny_test_config(), sc, device=None, seed=3,
                 draft_config=tiny_test_config() if draft else None)
    if eager:
        eng.round_graphs = None
        if draft:
            eng.spec.graphs = None
    rng = np.random.RandomState(5)
    ps = [rng.randint(1, 256, rng.randint(6, 24)).tolist() for _ in range(8)]

    def run():
        ids = []
        for i, p in enumerate(ps):
            kw = {} if draft else [
                {}, {"temperature": 0.8, "top_p": 0.9},
                {"frequency_penalty": 0.5, "logprobs": 2}, {}][i % 4]
            ids.append(eng.add_request(p, max_new_tokens=12, **kw))
        outs = {o.req_id: o for o in eng.run()}
        return [(outs[i].tokens, outs[i].logprobs) for i in ids]

    toks = run()
    st = eng.get_statistics()
    st["keys"] = (len(eng.round_graphs._seen) if eng.round_graphs is not None
                  else 0)
    after = None
    if rebuild_to is not None:
        eng.set_kv_dtype(rebuild_to)
        st["after_rebuild"] = eng.get_statistics()["engine"]
        after = run()
        st["after_serve"] = eng.get_statistics()["engine"]
    return toks, st, after


@pytest.mark.parametrize("fused", [False, True])
def test_engine_replays_its_rounds(dev, fused):
    """Every decode round after a key's first replays; the tokens (also
    sampled and penalized ones) and logprobs are the eager engine's."""
    want, _, _ = serve(dev, fused=fused, eager=True)
    got, st, _ = serve(dev, fused=fused)
    assert got == want
    e = st["engine"]
    assert e["round_route"] == "graph"
    assert e["graph_rounds"] > 0 and e["graphs_held"] >= 1
    assert e["eager_rounds"] == st["keys"] >= e["graph_captures"]
    assert (e["graph_rounds"] + e["eager_rounds"]
            == st["scheduler"]["decode_batches"])
    assert st["transfer"]["up_transfers"] > 0


def test_engine_rebuild_drops_the_graphs(dev):
    """A cross-width scheme switch rebuilds the pools: the graphs go, and
    the rounds after it replay graphs captured over the new pools, serving
    what an eager engine serves."""
    want, _, want_after = serve(dev, hbm=64, eager=True,
                                rebuild_to=KVDtype.INT4)
    got, st, got_after = serve(dev, hbm=64, rebuild_to=KVDtype.INT4)
    assert got == want and got_after == want_after
    assert st["after_rebuild"]["graphs_held"] == 0
    assert st["after_rebuild"]["graph_drops"] >= 1
    assert st["after_serve"]["graph_rounds"] > st["engine"]["graph_rounds"]


def test_draft_proposals_replay(dev):
    """A draft model's proposal rounds replay from its own cache; the
    speculative engine serves what it serves without graphs."""
    want, _, _ = serve(dev, hbm=64, draft=True, eager=True)
    got, st, _ = serve(dev, hbm=64, draft=True)
    assert got == want
    assert st["engine"]["draft_graph_rounds"] > 0
