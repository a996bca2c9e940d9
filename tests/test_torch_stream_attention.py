"""The port's streamed attention (`ops/stream_attention.py`) against the JAX
package's, on the same numpy inputs, at float32 (rtol = atol = ATOL: the
two sum in different orders); and the port's store reads and writes
(`runtime/hoststore.py`) against numpy indexing of the same store.

Cases cover every KV scheme, a sliding window (with the waves wholly below
it skipped), the tanh softcap, GPT-OSS sinks merged at finalize, and
queries of one token and of a chunk. In the port, the staged-slab version
equals the per-wave version bit for bit, as the JAX pair does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxl_speckv_tpu.config import KVDtype as JKV
from cxl_speckv_tpu.ops import stream_attention as js
from cxl_speckv_tpu.runtime.hoststore import StoreOps
from cxl_speckv_tpu_torch.config import KVDtype
from cxl_speckv_tpu_torch.ops import stream_attention as ts
from cxl_speckv_tpu_torch.ops.quant import kv_pack, kv_storage_dtype
from cxl_speckv_tpu_torch.runtime import hoststore as hs

ATOL = 2e-4
L, HKV, G, D, BS, WAVE = 3, 2, 2, 16, 8, 2
SLOTS = 14
OPS = StoreOps(pinned=False)


def make_store(kv: str, seed: int):
    """A port store filled with random stored values of scheme `kv` (FP8
    bytes include NaN patterns, which read as 0), and its numpy arrays."""
    rng = np.random.RandomState(seed)
    kvd = KVDtype(kv)
    st = hs.DeviceHostStore(SLOTS, L, BS, HKV, D // kv_pack(kvd),
                            kv_storage_dtype(kvd), pin=False)
    for a in (st.k, st.v):
        if kvd == KVDtype.BF16:
            a.copy_(torch.from_numpy(rng.randn(*a.shape).astype(np.float32)))
        else:
            lo, hi = (-127, 128) if kvd == KVDtype.INT8 else (-128, 128)
            a.copy_(torch.from_numpy(rng.randint(lo, hi, a.shape)
                                     .astype(np.int8)))
    for a in (st.ks, st.vs):
        a.copy_(torch.from_numpy(rng.uniform(0.002, 0.02, a.shape)
                                 .astype(np.float32)))
    if kvd == KVDtype.BF16:
        st.ks.fill_(1.0)
        st.vs.fill_(1.0)
    return st


def jax_arrays(st):
    out = []
    for a in st.arrays:
        if a.dtype == torch.bfloat16:
            out.append(jnp.asarray(a.float().numpy()).astype(jnp.bfloat16))
        else:
            out.append(jnp.asarray(a.numpy()))
    return tuple(out)


def host_row(seed: int, n_blocks: int, width: int) -> np.ndarray:
    """A lane's store slots (shuffled) padded with the guard slot."""
    row = np.full(width, SLOTS, np.int32)
    row[:n_blocks] = np.random.RandomState(seed).permutation(SLOTS)[:n_blocks]
    return row


def queries(seed: int, T: int) -> np.ndarray:
    return np.random.RandomState(seed).randn(T, HKV * G, D).astype(np.float32)


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=ATOL,
                               atol=ATOL)


CASES = [  # (kv, T, start, window, softcap)
    ("int8", 1, 37, None, None),
    ("int8", 5, 40, None, None),
    ("int8", 1, 0, None, None),          # no context: no wave runs
    ("int8", 4, 51, 20, None),           # window: the first waves skipped
    ("int8", 3, 29, None, 30.0),
    ("int4", 2, 45, None, None),
    ("fp8", 1, 33, 9, 30.0),
    ("bf16", 4, 26, None, None),
]


@pytest.mark.parametrize("kv,T,start,window,softcap", CASES)
def test_stream_context_attention_matches_jax(kv, T, start, window, softcap):
    """Per-wave context attention (each wave fetched from the store by
    layer) against the JAX function, and the port's staged-slab version
    bit for bit equal to it."""
    st = make_store(kv, seed=start)
    n_blocks = -(-(start + T) // BS)
    max_blocks = 8
    row = host_row(start, n_blocks, -(-max_blocks // WAVE) * WAVE)
    q = queries(start + 1, T)
    layer = 1
    kw = dict(sm_scale=0.3, window=window, softcap=softcap)
    want = js.stream_context_attention(
        jnp.asarray(q), jax_arrays(st), jnp.asarray(row), jnp.int32(start),
        jnp.int32(layer), JKV(kv), OPS, num_layers=L, block_size=BS,
        max_blocks=max_blocks, wave=WAVE, **kw)
    got = ts.stream_context_attention(
        torch.from_numpy(q), st, row, start, layer, KVDtype(kv), BS,
        max_blocks, WAVE, **kw)
    for g, w in zip(got, want):
        close(g.numpy(), w)
    # the staged slab: the same rows, staged by the group gather
    slab = tuple(a[:, 0] for a in hs.stage_layers(st, row, layer, 1, "cpu"))
    staged = ts.stream_context_attention_slab(
        torch.from_numpy(q), slab, start, KVDtype(kv), BS, WAVE, **kw)
    for a, b in zip(staged, got):
        assert torch.equal(a, b)
    jslab = js.stream_context_attention_slab(
        jnp.asarray(q), tuple(jnp.asarray(a.float().numpy()
                                          if a.dtype == torch.bfloat16
                                          else a.numpy()).astype(b.dtype)
                              for a, b in zip(slab, jax_arrays(st))),
        jnp.int32(start), JKV(kv), block_size=BS, wave=WAVE, **kw)
    for g, w in zip(staged, jslab):
        close(g.numpy(), w)


@pytest.mark.parametrize("T,window,softcap,sinks", [
    (1, None, None, False), (6, None, None, False), (6, 3, None, False),
    (5, None, 30.0, False), (5, 4, None, True), (1, None, None, True)])
def test_merge_chunk_causal_matches_jax(T, window, softcap, sinks):
    """The in-chunk causal merge and finalize, with the sinks added to the
    softmax denominator, over the accumulators of a real context."""
    start = 35
    st = make_store("int8", seed=3)
    row = host_row(3, -(-(start + T) // BS), 8)
    q = queries(5, T)
    rng = np.random.RandomState(6)
    k_new = rng.randn(T, HKV, D).astype(np.float32)
    v_new = rng.randn(T, HKV, D).astype(np.float32)
    sk = (rng.randn(HKV * G) * 2).astype(np.float32) if sinks else None
    kw = dict(sm_scale=0.25, window=window, softcap=softcap)
    jcarry = js.stream_context_attention(
        jnp.asarray(q), jax_arrays(st), jnp.asarray(row), jnp.int32(start),
        jnp.int32(0), JKV.INT8, OPS, num_layers=L, block_size=BS,
        max_blocks=8, wave=WAVE, **kw)
    tcarry = ts.stream_context_attention(
        torch.from_numpy(q), st, row, start, 0, KVDtype.INT8, BS, 8, WAVE,
        **kw)
    want = js.merge_chunk_causal(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new), jcarry,
        sinks=None if sk is None else jnp.asarray(sk), **kw)
    got = ts.merge_chunk_causal(
        torch.from_numpy(q), torch.from_numpy(k_new), torch.from_numpy(v_new),
        tcarry, sinks=None if sk is None else torch.from_numpy(sk), **kw)
    assert got.shape == (T, HKV * G, D)
    close(got.numpy(), want)
    if sinks:
        # the sinks take their share: the output is not the sink-free one
        plain = ts.merge_chunk_causal(
            torch.from_numpy(q), torch.from_numpy(k_new),
            torch.from_numpy(v_new), tcarry, **kw)
        assert float((plain - got).abs().max()) > 1e-3


@pytest.mark.parametrize("kv,window,softcap", [
    ("int8", None, None), ("int4", 7, None), ("fp8", None, 20.0)])
def test_wave_update_matches_jax(kv, window, softcap):
    """`_make_wave_attend`: one wave's online-softmax update from a
    non-trivial running state."""
    T, start, w = 3, 30, 1
    rng = np.random.RandomState(9)
    st = make_store(kv, seed=9)
    row = host_row(9, 4, 4)
    slab = hs.fetch_layer(st, row[w * WAVE:(w + 1) * WAVE], 2, "cpu")
    q = queries(10, T)
    qg = q.reshape(T, HKV, G, D)
    acc = (rng.randn(HKV, G, T, 1).astype(np.float32),
           rng.uniform(0.5, 2, (HKV, G, T, 1)).astype(np.float32),
           rng.randn(HKV, G, T, D).astype(np.float32))
    args = (HKV, WAVE, BS, D)
    jatt = js._make_wave_attend(jnp.asarray(qg), *args, JKV(kv),
                                jnp.int32(start), 0.3, window, softcap, T)
    tatt = ts._make_wave_attend(torch.from_numpy(qg), *args, KVDtype(kv),
                                start, 0.3, window, softcap, T)
    want = jatt(jnp.int32(w), tuple(jnp.asarray(a) for a in acc),
                tuple(jnp.asarray(a.numpy()) for a in slab))
    got = tatt(w, tuple(torch.from_numpy(a) for a in acc), slab)
    for g, wv in zip(got, want):
        close(g.numpy(), wv)


def test_store_reads_and_writes_match_numpy():
    """fetch_blocks / fetch_layer / stage_layers read what
    numpy indexing of the flat rows reads (row = slot * L + layer), in
    order, with guard and repeated slots; stash_blocks writes exactly the
    slots' rows, a repeated slot taking its last slab."""
    st = make_store("int8", seed=1)
    ref = [a.clone() for a in st.arrays]
    slots = np.array([3, 4, 5, 9, SLOTS, 0])        # a run, a gap, the guard
    got = hs.fetch_blocks(st, slots, "cpu")
    rows = (slots[:, None] * L + np.arange(L)).reshape(-1)
    for g, r in zip(got, ref):
        assert torch.equal(g, r[rows].reshape(len(slots), L, *r.shape[1:]))
    got = hs.fetch_layer(st, slots, 2, "cpu")
    for g, r in zip(got, ref):
        assert torch.equal(g, r[slots * L + 2])
    got = hs.stage_layers(st, slots, 1, 2, "cpu")
    for g, r in zip(got, ref):
        want = r[(slots[:, None] * L + np.array([1, 2])).reshape(-1)]
        assert torch.equal(g, want.reshape(len(slots), 2, *r.shape[1:]))
    assert st.staged_bytes == (len(slots) * (L + 1 + 2)) * st.bytes_per_row
    new = tuple(torch.randint_like(a, -50, 50) if a.dtype == torch.int8
                else torch.rand_like(a) for a in hs.fetch_blocks(
                    st, np.array([7, 2, 7]), "cpu"))
    hs.stash_blocks(st, new, np.array([7, 2, 7]))
    for a, r, n in zip(st.arrays, ref, new):
        want = r.clone()
        want[7 * L:8 * L] = n[2]
        want[2 * L:3 * L] = n[1]
        assert torch.equal(a, want)
