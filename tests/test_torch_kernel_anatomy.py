"""The decode-anatomy probes P1-P3 (`cxl_speckv_tpu_torch/ops/
decode_anatomy.py`) and their command line, at a tiny geometry (B 2, Hq 8,
Hkv 2, D 32, bs 8, ctx 64; lanes of 64 and 37 tokens at shuffled slots),
for INT8, INT4 and BF16 pools.

The TPU probes are closures inside `scripts/kernel_anatomy.py:main` and
print only times, so each plain version is held against an independent
numpy statement of the TPU body it mirrors (cited per test); P2 against
the JAX package's `paged_attention` in interpret mode on the same kT pools,
unsplit and in its split form; and the port's command line against the
JAX script, label by label. Tolerances: `fetchint` and the w8a8 int32
scores bit-exact; the float sums within 1e-6 relative plus 1e-3 absolute
(float64 sums in another order, then rounded to float32); matmul / matmulT
within 2e-3 of each (lane, head)'s largest value (a float32 score can
round to the neighbouring bf16 value, one step of 2^-8 of its share); P2
within rtol = atol = 2e-4, the existing bf16 K1 tests' tolerance, and its
split form within that plus 2^-8 of the largest |vs * v| of the lane's
tokens (a split rounds p * vs to bf16 against its own running max: each
term may land one bf16 step, 2^-8 of itself, from the unsplit walk's). The
kernels themselves need the card: tests/test_torch_kernels_cuda.py."""

import os
import re
from collections import Counter
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from cxl_speckv_tpu.config import KVDtype as JKV
from cxl_speckv_tpu.ops.paged_attention import paged_attention as j_decode
from cxl_speckv_tpu_torch.ops import decode_anatomy as da
from cxl_speckv_tpu_torch.ops.paged_attention import paged_attention
from cxl_speckv_tpu_torch.utils.card import bound_ms

REPO = Path(__file__).resolve().parent.parent
HEADS = (8, 2, 32)
BS, CTX, LENS = 8, 64, (64, 37)
SCHEMES = ("int8", "int4", "bf16")


def probe_pools(scheme, seed=3):
    return da.build_pools(scheme, BS, CTX, batch=len(LENS), heads=HEADS,
                          seed=seed, lens=LENS, shuffle=True, device="cpu")


def np_(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def bf16(x) -> np.ndarray:
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16).astype(np.float32)


def unpack(raw: np.ndarray, axis: int) -> np.ndarray:
    """INT4 half-split nibbles as the TPU bodies sign-extend them
    (`kernel_anatomy.py:269-273`, `:301-304`)."""
    r = raw.astype(np.int32)
    return np.concatenate([(r << 28) >> 28, (r << 24) >> 28], axis=axis)


def lane_slots(p, b):
    n = -(-int(p.lens[b]) // BS)
    return p.table[b, :n].numpy()


def np_variant(mode, p):
    """The TPU body of `mode` (`kernel_anatomy.py:100-171`), per (lane, kv
    head), within the head, over the lane's blocks."""
    k, v, ks, vs = (np_(x) for x in p.token_major())
    q = np_(p.q)
    B, hq, d = q.shape
    hkv, dp = k.shape[1], k.shape[3]
    G = hq // hkv
    out = np.zeros((B, hkv) if mode in da.SUM_MODES else (B, hkv, G, dp),
                   np.int64 if mode == "fetchint" else np.float64)
    for b in range(B):
        for s in lane_slots(p, b):
            for h in range(hkv):
                kt, vt = k[s, h], v[s, h]                 # [bs, D/pack]
                if mode == "fetchrow":                    # :100-110
                    out[b, h] += kt[0].sum(dtype=np.float64) + vt[0].sum(
                        dtype=np.float64)
                elif mode == "fetchint":                  # :111-118
                    out[b, h] += (np.trunc(kt).astype(np.int64).sum()
                                  + np.trunc(vt).astype(np.int64).sum())
                elif mode == "fetch":                     # :119-127
                    out[b, h] += (kt.sum(dtype=np.float64)
                                  + vt.sum(dtype=np.float64)
                                  + ks[s, h].sum(dtype=np.float64)
                                  + vs[s, h].sum(dtype=np.float64))
                elif mode == "dequant":                   # :128-140
                    for raw, sc in ((kt, ks[s, h]), (vt, vs[s, h])):
                        x = unpack(raw, -1) if p.kv.value == "int4" else raw
                        out[b, h] += bf16(bf16(x) * bf16(sc)[:, None]).sum(
                            dtype=np.float64)
                else:                                     # :141-171
                    qv = bf16(q[b].reshape(hkv, G, d)[h, :, :dp])
                    sc = qv @ kt.astype(np.float32).T            # [G, bs]
                    if mode == "matmul":
                        pr = bf16(sc)
                    else:
                        pr = bf16(np.exp(sc - sc.max(-1, keepdims=True)))
                    out[b, h] += pr @ vt.astype(np.float32)
    return out


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("mode", da.P1_MODES)
def test_p1_plain_matches_numpy(scheme, mode):
    p = probe_pools(scheme)
    got = da.variant(mode, p.q, *p.token_major(), p.table, p.lens, p.kv)
    want = np_variant(mode, p)
    if mode == "fetchint":
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    elif mode in da.SUM_MODES:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-3)
    else:
        err, ok = da.within_rows(got, torch.from_numpy(want))
        assert ok, err
    assert not any(da.probe_launches().values())   # CPU calls count nothing


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("nbuf", da.RING_DEPTHS)
def test_p3_ring_plain_is_the_row_sum(scheme, nbuf):
    """`compute == "row"` (`kernel_anatomy.py:421-424`): token row 0 of
    every K and V tile, summed over the lane's blocks."""
    p = probe_pools(scheme)
    got = da.ring(nbuf, *p.token_major(), p.table, p.lens, p.kv)
    np.testing.assert_allclose(got.numpy(), np_variant("fetchrow", p),
                               rtol=1e-6, atol=1e-3)


def test_p3_ring_that_does_not_fit_raises():
    """bs 128, D 128: BF16 stages are 64 KB + 1 KB, so four need 260 KB;
    INT8 fits four (132 KB), not eight."""
    fits = {("int8", 4): True, ("int8", 8): False, ("bf16", 4): False,
            ("bf16", 16): False}
    for (scheme, nbuf), ok in fits.items():
        p = da.build_pools(scheme, 128, 128, batch=1, heads=(4, 1, 128),
                           seed=0, device="cpu")
        args = (*p.token_major(), p.table, p.lens, p.kv)
        if ok:
            da.ring(nbuf, *args)
        else:
            with pytest.raises(ValueError, match="shared memory"):
                da.ring(nbuf, *args)


@pytest.mark.parametrize("lens,bs,width,splits", [
    ((8192,) * 8, 32, 256, 5),      # the probe's lanes at the derived S
    ((0, 1, 32, 33), 32, 4, 3),     # lanes of 0 and 1 tokens, short lanes
    ((64, 37), 8, 8, 7),            # fewer blocks than splits
    ((100, 9000), 32, 10, 4),       # the table's width caps the walk
    ((8192,), 32, 256, 1),
    ((5 * 32,), 32, 5, 64),
])
def test_split_plan_covers_every_block_once(lens, bs, width, splits):
    """`split_ranges` (the kernels' `tile_ring.cuh:split_range`): the
    splits of each lane cover its min(ceil(len / bs), width) blocks, each
    exactly once, in order; an empty split has count 0."""
    for n in lens:
        blocks = min(-(-n // bs), width)
        ranges = da.split_ranges(blocks, splits)
        assert len(ranges) == splits
        walked = [i for first, count in ranges
                  for i in range(first, first + count)]
        assert walked == list(range(blocks))
        assert all(count >= 0 for _, count in ranges)


@pytest.mark.parametrize("sm", [132, 114])
@pytest.mark.parametrize("depth", [0, 2, 4, 8, 16])
def test_derived_splits_fill_the_card(sm, depth):
    """At the probe's geometry (B 8, Hkv 8, ctx 8192 at bs 32: a table 256
    blocks wide; at bs 128, 64 blocks, where no ring deeper than 4 fits)
    the derived count puts at least two CTAs on every SM and leaves no
    split shorter than the ring depth; where the lanes alone fill the card
    it is 1."""
    ctas = da.PROBE_BATCH * da.PROBE_HEADS[1]
    for products in (False, True):
        for width in (256, 64) if depth <= 4 else (256,):
            S = da.probe_splits(ctas, width, depth, sm, products)
            assert ctas * S >= 2 * sm
            assert S <= width // max(depth, 1) and S <= da.MAX_SPLITS
        assert da.probe_splits(4 * sm, 256, depth, sm, products) == 1
        assert da.probe_splits(0, 256, depth, sm, products) == 1


@pytest.mark.parametrize("scheme,bs,nbuf,fits", [
    ("int8", 32, 4, True), ("int8", 32, 8, True), ("int8", 32, 16, True),
    ("int4", 32, 16, True), ("bf16", 32, 8, True), ("bf16", 32, 16, False),
    ("int8", 128, 4, True), ("int8", 128, 8, False), ("int8", 128, 16, False),
])
def test_ring_bytes_give_the_refusal_table(scheme, bs, nbuf, fits):
    """`ring_bytes` counts each stage's two 8-byte barriers beside K, V and
    both scale rows; at D 128 the rings it refuses are still the ones
    `chip_smoke.py`'s PROBE_REFUSED names (BF16 ring16 at bs 32, INT8
    ring8 / ring16 at bs 128)."""
    row = 128 // (2 if scheme == "int4" else 1) * (2 if scheme == "bf16" else 1)
    assert da.ring_bytes(nbuf, bs, row) == nbuf * (2 * bs * row + 8 * bs + 16)
    assert (da.ring_bytes(nbuf, bs, row) <= da.SMEM_LIMIT) == fits
    p = da.build_pools(scheme, bs, bs, batch=1, heads=(4, 1, 128), seed=0,
                       device="cpu")
    args = (*p.token_major(), p.table, p.lens, p.kv)
    if fits:
        da.ring(nbuf, *args)
    else:
        with pytest.raises(ValueError, match="shared memory"):
            da.ring(nbuf, *args)


def test_split_and_depth_arguments_are_checked():
    """Forced split counts and depths change no result (the CPU runs the
    plain version) and are checked on either device."""
    p = probe_pools("int8")
    args = (p.q, *p.token_major(), p.table, p.lens, p.kv)
    want = da.variant("fetch", *args)
    assert torch.equal(da.variant("fetch", *args, num_splits=7, depth=0), want)
    assert torch.equal(da.ring(4, *args[1:], num_splits=64),
                       da.variant("fetchrow", *args))
    for bad in (0, 65, 2.0):
        with pytest.raises(ValueError, match="num_splits"):
            da.variant("fetch", *args, num_splits=bad)
        with pytest.raises(ValueError, match="num_splits"):
            da.ring(8, *args[1:], num_splits=bad)
    for mode, depth in (("fetchrow", 0), ("matmul", 0), ("fetch", 3),
                        ("fetch", 16)):
        with pytest.raises(ValueError, match="depth"):
            da.variant(mode, *args, depth=depth)
    assert da.p1_depth("fetch", 32, 128) == da.P1_DEPTH["fetch"]
    # BF16 tiles at bs 128 (64 KB + 1 KB a stage): the ring halves to 2
    # stages (and fetch / dequant would read into registers past that)
    assert da.p1_depth("dequant", 128, 256) == 2
    assert da.p1_depth("dequant", 256, 256) == 0
    with pytest.raises(ValueError, match="shared memory"):
        da.p1_depth("matmul", 256, 256)


@pytest.mark.parametrize("scheme", ["int8", "int4"])
def test_w8a8_scores_bit_exact(scheme):
    """`kernel_anatomy.py:265-280`: q8 = clip(q * 127) truncated to int8
    (q and q * 127 in bf16), int8 x int8 products summed in int32, on the
    kT tiles (INT4 unpacked along the rows)."""
    p = probe_pools(scheme)
    got = da.w8a8_scores(p.q, p.kt, p.table, p.lens, HEADS[1], p.kv)
    q, kt, table = np_(p.q), p.kt.numpy(), p.table.numpy()
    B, hq, d = q.shape
    hkv = HEADS[1]
    G = hq // hkv
    q8 = np.clip(bf16(bf16(q) * 127.0), -127, 127).astype(np.int8)
    q8 = q8.reshape(B, hkv, G, d).astype(np.int32)
    nblk = -(-max(LENS) // BS)
    want = np.zeros((B, hkv, G, nblk * BS), np.int32)
    for b in range(B):
        for i in range(nblk):
            t = kt[table[b, i]]                           # [D/pack, Hkv*bs]
            if scheme == "int4":
                t = unpack(t, 0)
            t = t.astype(np.int32)
            for h in range(hkv):
                want[b, h, :, i * BS:(i + 1) * BS] = (
                    q8[b, h] @ t[:, h * BS:(h + 1) * BS])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def jax_pool(t: torch.Tensor):
    a = np_(t)
    return jnp.asarray(a).astype(jnp.bfloat16) if t.dtype == torch.bfloat16 \
        else jnp.asarray(a)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("name", ["v2", "v3fused"])
def test_p2_plain_matches_jax_kernel(scheme, name):
    """v2 / v3fused against the JAX package's `paged_attention` (interpret
    mode, compute bf16) on the production kT layout
    (`paged_attention.py:234-237`: kT, flat scales [S, 1, Hkv * bs]); K1's
    plain version on the token-major copy of the same pools too."""
    p = probe_pools(scheme)
    S = p.kt.shape[0]
    flat = lambda s: s.reshape(S, 1, -1)
    want = np.asarray(j_decode(
        jnp.asarray(np_(p.q)), jax_pool(p.kt), jax_pool(p.v),
        jnp.asarray(np_(flat(p.ks))), jnp.asarray(np_(flat(p.vs))),
        jnp.asarray(p.table.numpy()), jnp.asarray(p.lens.numpy()),
        JKV(scheme), interpret=True, compute_dtype=jnp.bfloat16))
    sc = (p.scf, None) if name == "v3fused" else (flat(p.ks), flat(p.vs))
    got = da.kt_attention(p.q, p.kt, p.v, *sc, p.table, p.lens, p.kv, name)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    tm = da.token_major_from_kt(p.kt, p.v, flat(p.ks), flat(p.vs), HEADS[1])
    for a, b in zip(tm, p.token_major()):
        assert torch.equal(a, b)
    k1 = paged_attention(p.q, *tm, p.table, p.lens, p.kv,
                         compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(k1.numpy(), want, rtol=2e-4, atol=2e-4)


def vs_v_max(p) -> torch.Tensor:
    """max over each lane's tokens of |vs * v| -> [B, Hq, D] (each query
    head of a kv head takes its row), dequantized as the plain version."""
    from cxl_speckv_tpu_torch.ops.quant import dequant_values
    B, hq, d = p.q.shape
    hkv = p.v.shape[1]
    out = torch.zeros((B, hkv, d))
    for b in range(B):
        blk = da._lane_blocks(p.table, p.lens, b, BS)
        n = int(p.lens[b])
        if not n:
            continue
        x = (dequant_values(p.v[blk], p.kv) * p.vs[blk][..., None]).abs()
        x = x.permute(1, 0, 2, 3).reshape(hkv, -1, d)[:, :n]
        out[b] = x.amax(1)
    return out.repeat_interleave(hq // hkv, 1)


@pytest.mark.parametrize("splits", [1, 2, 7])
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("name", ["v2", "v3fused"])
def test_p2_split_form_matches_jax_kernel(scheme, name, splits):
    """`kt_attention_plain(..., num_splits=S)`, the kernel's grid on the
    CPU: each split walks `split_ranges`' blocks from a fresh state and
    `merge_splits` combines them. Against the JAX `paged_attention`
    (interpret mode, compute bf16): S = 1 bit-equal to the unsplit walk and
    within rtol = atol = 2e-4; S > 1 within that plus 2^-8 of the lane's
    largest |vs * v| (where p * vs rounds)."""
    p = probe_pools(scheme)
    S = p.kt.shape[0]
    flat = lambda s: s.reshape(S, 1, -1)
    want = np.asarray(j_decode(
        jnp.asarray(np_(p.q)), jax_pool(p.kt), jax_pool(p.v),
        jnp.asarray(np_(flat(p.ks))), jnp.asarray(np_(flat(p.vs))),
        jnp.asarray(p.table.numpy()), jnp.asarray(p.lens.numpy()),
        JKV(scheme), interpret=True, compute_dtype=jnp.bfloat16))
    sc = (p.scf, None) if name == "v3fused" else (p.ks, p.vs)
    args = (p.q, p.kt, p.v, *sc, p.table, p.lens, p.kv, name)
    got = da.kt_attention_plain(*args, num_splits=splits)
    if splits == 1:
        assert torch.equal(got, da.kt_attention_plain(*args))
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
        return
    bound = 2e-4 + 2e-4 * np.abs(want) + 2.0 ** -8 * vs_v_max(p).numpy()
    err = np.abs(got.numpy() - want)
    assert (err <= bound).all(), float(err.max())
    assert not got.isnan().any()


@pytest.mark.parametrize("splits", [2, 7, 64])
@pytest.mark.parametrize("scheme", ["int8", "int4"])
def test_p2_w8a8_split_form_merges_the_same_scores(scheme, splits):
    """w8a8's split form walks the same int32 scores (`w8a8_scores`, bit
    exact above) through the split plan: within 2^-8 of the lane's largest
    |vs * v| of its unsplit walk, every split's blocks taken once."""
    p = probe_pools(scheme)
    args = (p.q, p.kt, p.v, p.ks, p.vs, p.table, p.lens, p.kv, "w8a8")
    one = da.kt_attention_plain(*args)
    got = da.kt_attention_plain(*args, num_splits=splits)
    assert torch.equal(da.kt_attention_plain(*args, num_splits=1), one)
    bound = 4e-4 + 2.0 ** -8 * vs_v_max(p)
    assert bool(((got - one).abs() <= bound).all())
    assert not got[1:].isnan().any()


@pytest.mark.parametrize("dp", [16, 64, 128])
@pytest.mark.parametrize("bs", [8, 32, 128])
@pytest.mark.parametrize("kind", ["int8", "int4", "bf16", "int8-w8a8",
                                  "int4-w8a8"])
def test_p2_fragment_slots_take_every_element_once(kind, bs, dp):
    """`kt_fragment_slots`, the Python mirror of the P2 kernel's score
    fragments: each register position of each product instruction is
    filled once, the K element a slot holds is the element its q fragment
    puts on that k position, and every (token, element) of the block
    (token < bs, element < D) is taken exactly once."""
    scheme, _, w8 = kind.partition("-")
    kv = da.SCHEMES[scheme]
    d = dp * (2 if scheme == "int4" else 1)
    slots = list(da.kt_fragment_slots(kv, bs, dp, bool(w8)))
    positions = Counter((mma, row, kpos) for mma, row, kpos, *_ in slots)
    assert max(positions.values()) == 1
    assert all(el == q_el for *_, el, q_el in slots)
    taken = Counter((t, el) for _, _, _, t, el, _ in slots if t < bs)
    assert set(taken) == {(t, e) for t in range(bs) for e in range(d)}
    assert max(taken.values()) == 1


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("bs", [32, 128])
def test_p2_shared_memory_plan_refuses_no_variant(scheme, bs):
    """`p2_depth` at Llama-3-8B's D 128: every P2 variant takes a ring at bs
    32 and bs 128 (PROBE_REFUSED in chip_smoke.py refuses none of them;
    w8a8 on BF16 stays refused, by the wrapper); the default depth halves
    while the ring does not fit (BF16 at bs 128: 2), and a forced depth
    that does not fit raises."""
    kv = da.SCHEMES[scheme]
    for name in da.P2_VARIANTS:
        dep = da.p2_depth(name, kv, bs, 128)
        assert dep in da.P2_DEPTHS
        fused = name == "v3fused"
        assert da._p2_smem(dep, kv, bs, 128, fused) <= da.SMEM_LIMIT
        if dep < da.P2_DEPTH:
            assert da._p2_smem(2 * dep, kv, bs, 128, fused) > da.SMEM_LIMIT
        for depth in da.P2_DEPTHS:
            if da._p2_smem(depth, kv, bs, 128, fused) <= da.SMEM_LIMIT:
                assert da.p2_depth(name, kv, bs, 128, depth) == depth
            else:
                with pytest.raises(ValueError, match="shared memory"):
                    da.p2_depth(name, kv, bs, 128, depth)
    want = {("int8", 32): 4, ("int4", 32): 4, ("bf16", 32): 4,
            ("int8", 128): 4, ("int4", 128): 4, ("bf16", 128): 2}
    assert da.p2_depth("v2", kv, bs, 128) == want[(scheme, bs)]
    p = da.build_pools(scheme, bs, bs, batch=1, heads=(4, 1, 128), seed=0,
                       device="cpu")
    args = (p.q, p.kt, p.v, p.ks, p.vs, p.table, p.lens, p.kv)
    if scheme == "bf16":
        with pytest.raises(ValueError, match="w8a8"):
            da.kt_attention(*args, "w8a8")
    else:
        da.kt_attention(*args, "w8a8")


def test_p2_stage_layout():
    """`kt_stage` (the kernel's `stage_geometry`): at the probe cell a stage
    is 4 KB of K, 4 KB of V and 256 B of scales; the K box widens to 16
    bytes at bs 8 INT8 and starts on a 16-byte boundary, so it spans the
    bytes of the head before as far back as that; v3fused's scale box
    starts on a 128-byte boundary; bs past 256 takes 256-column boxes."""
    g = da.kt_stage(da.SCHEMES["int8"], 32, 128, False)
    assert (g["kpt"], g["voff"], g["soff"], g["tx"], g["stage"]) == (
        32, 4096, 8192, 8448, 8448)
    g = da.kt_stage(da.SCHEMES["int8"], 8, 32, False, hkv=2)
    assert g["kpt"] == 16 and g["voff"] == 16 * 32 and g["tx"] == 512 + 256 + 64
    g = da.kt_stage(da.SCHEMES["bf16"], 8, 32, True, hkv=2)
    assert g["kpt"] == 8 and g["soff"] % 128 == 0 and g["sw"] == 8
    # bs 12 INT8: heads start 12, 8, 4 bytes past a 16-byte boundary
    assert da.kt_stage(da.SCHEMES["int8"], 12, 32, False, hkv=4)["kpt"] == 32
    assert da.kt_stage(da.SCHEMES["int8"], 12, 32, False, hkv=1)["kpt"] == 16
    g = da.kt_stage(da.SCHEMES["int4"], 260, 32, True)
    assert (g["kpieces"], g["kpt"], g["sw"]) == (2, 256, 256)
    assert g["tx"] == 2 * 256 * 16 + 260 * 16 + 2 * 8 * 256
    assert g["stage"] % 128 == 0 and g["stage"] >= g["soff"] + 2 * 8 * 256


def test_p2_split_and_depth_arguments_are_checked():
    """P2's forced split counts and depths change no result on the CPU (the
    plain version runs) and are checked on either device; a kT row that is
    not a multiple of 16 bytes (the TMA map's row stride) is refused."""
    p = probe_pools("int8")
    args = (p.q, p.kt, p.v, p.ks, p.vs, p.table, p.lens, p.kv, "v2")
    want = da.kt_attention(*args)
    for ns, depth in ((1, 2), (7, 4), (64, 8), (None, 8)):
        assert torch.equal(da.kt_attention(*args, num_splits=ns, depth=depth),
                           want)
    for bad in (0, 65, 2.0):
        with pytest.raises(ValueError, match="num_splits"):
            da.kt_attention(*args, num_splits=bad)
    for bad in (0, 3, 16):
        with pytest.raises(ValueError, match="depth"):
            da.kt_attention(*args, depth=bad)
    q = da.build_pools("int8", 8, 16, batch=1, heads=(2, 1, 32), seed=0,
                       device="cpu")
    with pytest.raises(ValueError, match="kT rows of 8 bytes"):
        da.kt_attention(q.q, q.kt, q.v, q.ks, q.vs, q.table, q.lens, q.kv)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    p = probe_pools("bf16")
    with pytest.raises(ValueError, match="w8a8"):
        da.kt_attention(p.q, p.kt, p.v, p.ks, p.vs, p.table, p.lens, p.kv,
                        "w8a8")
    with pytest.raises(ValueError, match="one scale array"):
        da.kt_attention(p.q, p.kt, p.v, p.scf, p.vs, p.table, p.lens, p.kv,
                        "v3fused")
    with pytest.raises(ValueError, match="mode"):
        da.variant("dma", p.q, *p.token_major(), p.table, p.lens, p.kv)
    with pytest.raises(ValueError, match="depth"):
        da.ring(2, *p.token_major(), p.table, p.lens, p.kv)


def test_work_counts_bytes_and_operations():
    """The bytes of a call at the tiny geometry, by hand: 8 + 5 blocks,
    tiles of Hkv * bs * 32 bytes (INT8), scale rows of Hkv * bs * 4."""
    p = probe_pools("int8")
    tile, sc, blocks = 2 * BS * 32, 2 * BS * 4, 8 + 5
    walk = blocks * 4 + 2 * 4
    assert da.probe_work("fetchint", p)[0] == blocks * 2 * tile + walk + 2 * 2 * 4
    assert da.probe_work("fetch", p)[0] == blocks * 2 * (tile + sc) + walk + 16
    # the rings and fetchrow: token row 0 of each head's K and V tile
    row = 2 * 32
    assert da.probe_work("v5ring8", p) == (blocks * 2 * row + walk + 16,
                                           {"f32": 2 * blocks * 2 * 32})
    assert da.probe_work("fetchrow", p) == da.probe_work("v5ring8", p)
    nb, ops = da.probe_work("v2", p)
    assert nb == 2 * 8 * 32 * 2 + blocks * 2 * (tile + sc) + walk + 2 * 8 * 32 * 4
    assert ops == {"bf16": 4 * 4 * 32 * sum(LENS) * 2}
    ms, by = bound_ms({"hbm": 1e9, "bf16": 1e12, "f32": 1e11}, nb, ops)
    assert by == "bytes" and ms == pytest.approx(nb / 1e9 * 1e3)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_constant_pools_hold_the_script_constants(scheme):
    """Without a seed the pools hold `kernel_anatomy.py:71-84`'s constants:
    zero K, V and q, unit scales, the table arange(B * max_blocks); every
    probe's output is zero but fetch's, which sums the unit scales."""
    p = da.build_pools(scheme, BS, CTX, batch=2, heads=HEADS, seed=None,
                       device="cpu")
    assert not p.k.float().any() and not p.v.float().any()
    assert not p.q.any() and not p.kt.float().any()
    assert bool((p.ks == 1).all()) and bool((p.scf == 1).all())
    assert torch.equal(p.table.flatten(), torch.arange(2 * CTX // BS,
                                                       dtype=torch.int32))
    for label, fn in da.probe_calls(p).items():
        if label == "w8a8" and scheme == "bf16":
            continue
        want = 2 * CTX if label == "fetch" else 0
        assert bool((fn().float() == want).all()), label


def labels(out: str) -> list[str]:
    return [m.group(1) for m in re.finditer(r"^(\w+)\s*:", out, re.M)]


def test_cli_prints_every_label_of_the_jax_script():
    """Both probes at a tiny size on the CPU: the JAX script (its Pallas
    kernels in interpret mode) and the port's command line with --device
    cpu, both on the script's constant pools; the port prints every
    variant label the script prints, in the script's order, then the modes
    the script's loop skips."""
    args = ["--ctx", "64", "--bs", "16", "--iters", "1", "--minpool", "0"]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    jax_run = subprocess.run(
        [sys.executable, "scripts/kernel_anatomy.py", *args, "--ppb", "2"],
        cwd=REPO,
        env=env, capture_output=True, text=True, timeout=600)
    port = subprocess.run(
        [sys.executable, "-m", "cxl_speckv_tpu_torch.scripts.kernel_anatomy",
         *args, "--constants", "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=600)
    assert jax_run.returncode == 0, jax_run.stderr[-2000:]
    assert port.returncode == 0, port.stderr[-2000:]
    want = labels(jax_run.stdout)
    got = labels(port.stdout)
    assert len(want) == 9 and "FAIL" not in port.stdout
    assert got[:len(want)] == want
    assert got[len(want):] == ["fetchrow", "fetchint", "dequant", "w8a8"]
    assert port.stdout.startswith("scheme=int8 bs=16 ctx=64")
    assert "not measured" in port.stdout.splitlines()[0]
