"""The CUDA kernels K1 (decode) and K2 (chunk) against their plain PyTorch
versions, on the card, for every storage scheme (INT8, BF16, INT4, FP8;
MIXED8 by scheme id), with and without the sliding window, softcap and
GPT-OSS attention sinks; K1 at the split count its rule chooses and at
forced ones, against the plain version's split form at the same count.
Every test here needs an NVIDIA card and `nvcc` and skips without them; on
the card run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

(`--noconftest`: the JAX test settings in tests/conftest.py import jax,
which the card's machine does not need). K2 at bf16 compute runs the
tensor-core kernel, at float32 compute the float32 FMA kernel. Tolerances:
2e-4 at float32 compute (the kernel sums in another order) and rtol = atol
= 2e-2 at bfloat16 compute with bf16 q (q and p * v_scale round to
bfloat16, and so does the output; a different float32 sum can round to the
neighbouring value); float32 q at bf16 compute: `TOL_F32_Q`. Then the
card's migration batch against `migrate_program` byte for byte, the copy
stream's ordering with a stream held until the test releases it
(`utils.card.StreamHold`), and fused rounds on the card. This file imports no JAX.
"""

import numpy as np
import pytest
import torch

from cxl_speckv_tpu_torch.config import KVDtype
from cxl_speckv_tpu_torch.ops.chunk_attention import paged_chunk_attention
from cxl_speckv_tpu_torch.ops.chunk_attention_cuda import (
    paged_chunk_attention_cuda,
)
from cxl_speckv_tpu_torch.ops.paged_attention import (
    default_splits,
    paged_attention,
)
from cxl_speckv_tpu_torch.ops.paged_attention_ref import paged_attention_ref
from cxl_speckv_tpu_torch.ops.quant import encode_for_pool, quantize_kv
from cxl_speckv_tpu_torch.utils.card import StreamHold

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
HQ, HKV, D, BS = 8, 2, 64, 16
SCHEMES = [KVDtype.INT8, KVDtype.BF16, KVDtype.INT4, KVDtype.FP8]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def pools(lens, kv, dev, seed, bs=BS, hkv=HKV, d=D):
    """Pools holding ceil(len / bs) blocks a lane at shuffled slots, the
    guard slot last. INT4 / FP8 hold quantized random K/V, as the engine
    writes them; in FP8 pools every row no lane holds (the guard slot, the
    tails of partly filled blocks) holds NaN bytes (0x7F), which must read
    as 0."""
    rng = np.random.RandomState(seed)
    nblk = [-(-n // bs) for n in lens]
    S = sum(nblk) + 1
    shape = (S, hkv, bs, d)
    if kv == KVDtype.INT8:
        k = torch.from_numpy(rng.randint(-127, 128, shape).astype(np.int8))
        v = torch.from_numpy(rng.randint(-127, 128, shape).astype(np.int8))
        ks = torch.from_numpy(rng.rand(*shape[:3]).astype(np.float32) * 0.02)
        vs = torch.from_numpy(rng.rand(*shape[:3]).astype(np.float32) * 0.02)
    elif kv == KVDtype.BF16:
        k = torch.from_numpy(rng.randn(*shape).astype(np.float32)).bfloat16()
        v = torch.from_numpy(rng.randn(*shape).astype(np.float32)).bfloat16()
        ks, vs = torch.ones(shape[:3]), torch.ones(shape[:3])
    else:
        q, sc = quantize_kv(torch.from_numpy(
            rng.randn(2, *shape).astype(np.float32)), kv)
        (k, v), (ks, vs) = encode_for_pool(q, kv), sc[..., 0]
    perm = rng.permutation(S - 1)
    table = np.full((len(lens), max(nblk) + 1), S - 1, np.int32)
    at = 0
    live = torch.zeros((S, bs), dtype=torch.bool)
    for i, (n, nb) in enumerate(zip(lens, nblk)):
        table[i, :nb] = perm[at:at + nb]
        at += nb
        for j in range(nb):
            live[table[i, j], :min(bs, n - j * bs)] = True
    if kv == KVDtype.FP8:
        k = k.masked_fill(~live[:, None, :, None], 0x7F)
        v = v.masked_fill(~live[:, None, :, None], 0x7F)
    return ([t.contiguous().to(dev) for t in (k, v, ks, vs)],
            torch.from_numpy(table).to(dev))


def misread(p, kv):
    """(pools, scheme) that read `kv`'s bytes under a wrong interpretation:
    FP8 bytes as INT8, INT4 with the two nibbles of each byte swapped. A
    kernel that decoded so must fail the comparison the right one passes."""
    if kv == KVDtype.FP8:
        return p, KVDtype.INT8
    swap = lambda x: ((x.view(torch.uint8) << 4)
                      | (x.view(torch.uint8) >> 4)).view(torch.int8)
    return [swap(p[0]), swap(p[1]), *p[2:]], KVDtype.INT4


def within(got, want, cd) -> bool:
    tol = TOL[cd]
    d = (got.float() - want.float()).abs()
    return bool((d <= tol + tol * want.float().abs()).all())


def close(got, want, cd):
    assert torch.isfinite(got).all()
    assert within(got, want, cd), float((got.float() - want.float()).abs().max())


def launched(fn) -> int:
    """The wrapper's kernel launches, summed over (scheme, window)."""
    return sum(fn.launches.values())


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv", SCHEMES)
def test_decode_kernel_matches_plain(dev, kv, cd):
    lens = [0, 1, 15, 16, 17, 130]
    p, table = pools(lens, kv, dev, seed=1)
    q = torch.randn(len(lens), HQ, D, device=dev).to(cd)
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    n0 = paged_attention.launches[kv.value, 0]
    got = paged_attention(q, *p, table, sl, kv, compute_dtype=cd)
    torch.cuda.synchronize()
    assert paged_attention.launches[kv.value, 0] == n0 + 1
    want = paged_attention_ref(q, *p, table, sl, kv, compute_dtype=cd)
    close(got, want, cd)
    assert not got[0].any()                       # seq_len 0 -> zeros
    if kv in (KVDtype.INT4, KVDtype.FP8):
        wp, wkv = misread(p, kv)
        wrong = paged_attention_ref(q, *wp, table, sl, wkv, compute_dtype=cd)
        assert not within(wrong, want, cd)


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sid", [0, 1])
def test_mixed8_kernels_equal_their_scheme(dev, sid, cd):
    """MIXED8 with scheme id 0 (1) launches the INT8 (FP8) kernel: the same
    bits, and launches counted under that scheme."""
    kv = (KVDtype.INT8, KVDtype.FP8)[sid]
    lens = [0, 5, 40, 130]
    p, table = pools(lens, kv, dev, seed=6)
    q = torch.randn(len(lens), HQ, D, device=dev).to(cd)
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    n0 = paged_attention.launches[kv.value, 0]
    got = paged_attention(q, *p, table, sl, KVDtype.MIXED8, compute_dtype=cd,
                          scheme_id=sid)
    assert torch.equal(got, paged_attention(q, *p, table, sl, kv,
                                            compute_dtype=cd))
    assert paged_attention.launches[kv.value, 0] == n0 + 2
    T = 12
    qc = torch.randn(len(lens), T, HQ, D, device=dev).to(cd)
    kn = torch.randn(len(lens), T, HKV, D, device=dev)
    args = (qc, kn, kn * 0.5, *p, table, sl)
    got = paged_chunk_attention_cuda(*args, KVDtype.MIXED8, compute_dtype=cd,
                                     scheme_id=sid)
    assert torch.equal(got, paged_chunk_attention_cuda(*args, kv,
                                                       compute_dtype=cd))
    close(got, paged_chunk_attention(*args, KVDtype.MIXED8, compute_dtype=cd,
                                     scheme_id=sid), cd)


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv", SCHEMES)
@pytest.mark.parametrize("T", [5, 12, 128])
def test_chunk_kernel_matches_plain(dev, kv, cd, T):
    starts = [0, 3, 16, 40, 0]
    p, table = pools([max(s, 1) for s in starts], kv, dev, seed=2)
    B = len(starts)
    q = torch.randn(B, T, HQ, D, device=dev).to(cd)
    kn = torch.randn(B, T, HKV, D, device=dev)
    vn = torch.randn(B, T, HKV, D, device=dev)
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    n0 = launched(paged_chunk_attention_cuda)
    got = paged_chunk_attention_cuda(q, kn, vn, *p, table, st, kv,
                                     compute_dtype=cd)
    torch.cuda.synchronize()
    assert launched(paged_chunk_attention_cuda) == n0 + 1
    want = paged_chunk_attention(q, kn, vn, *p, table, st, kv,
                                 compute_dtype=cd)
    close(got, want, cd)
    if kv in (KVDtype.INT4, KVDtype.FP8):
        wp, wkv = misread(p, kv)
        wrong = paged_chunk_attention(q, kn, vn, *wp, table, st, wkv,
                                      compute_dtype=cd)
        assert not within(wrong, want, cd)


@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv", SCHEMES)
def test_decode_kernel_sinks_matches_plain(dev, kv, cd, window):
    """GPT-OSS sinks (N(0, 2^2), so they bind): the kernel equals the plain
    version, a seq_len 0 lane still gives zeros, the plain result without
    sinks fails the comparison, and the launch counts in `sink_launches`."""
    lens = [0, 1, 15, 16, 17, 130]
    p, table = pools(lens, kv, dev, seed=3)
    q = torch.randn(len(lens), HQ, D, device=dev).to(cd)
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    sinks = (torch.randn(HQ, device=dev) * 2).to(cd)
    kw = dict(compute_dtype=cd, window=window)
    key = (kv.value, window or 0)
    n0 = paged_attention.sink_launches[key]
    got = paged_attention(q, *p, table, sl, kv, sinks=sinks, **kw)
    torch.cuda.synchronize()
    assert paged_attention.sink_launches[key] == n0 + 1
    want = paged_attention_ref(q, *p, table, sl, kv, sinks=sinks, **kw)
    close(got, want, cd)
    assert not got[0].any()
    assert not within(paged_attention_ref(q, *p, table, sl, kv, **kw), want,
                      cd)
    with pytest.raises(ValueError, match="sinks"):
        paged_attention(q, *p, table, sl, kv, sinks=sinks[:-1], **kw)


@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv", SCHEMES)
def test_chunk_kernel_sinks_matches_plain(dev, kv, cd, window):
    """Row r = t * G + g takes sinks[h * G + g]; T = 44 leaves padded rows
    in the last row tile."""
    starts = [0, 3, 16, 40, 100]
    T = 44
    p, table = pools([max(s, 1) for s in starts], kv, dev, seed=7)
    B = len(starts)
    q = torch.randn(B, T, HQ, D, device=dev).to(cd)
    kn = torch.randn(B, T, HKV, D, device=dev)
    vn = torch.randn(B, T, HKV, D, device=dev)
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    sinks = torch.randn(HQ, device=dev) * 2
    kw = dict(compute_dtype=cd, window=window)
    key = (kv.value, window or 0)
    n0 = paged_chunk_attention_cuda.sink_launches[key]
    got = paged_chunk_attention_cuda(q, kn, vn, *p, table, st, kv,
                                     sinks=sinks, **kw)
    torch.cuda.synchronize()
    assert paged_chunk_attention_cuda.sink_launches[key] == n0 + 1
    want = paged_chunk_attention(q, kn, vn, *p, table, st, kv, sinks=sinks,
                                 **kw)
    close(got, want, cd)
    assert not within(paged_chunk_attention(q, kn, vn, *p, table, st, kv,
                                            **kw), want, cd)


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv", SCHEMES)
@pytest.mark.parametrize("window,cap", [(40, None), (None, 5.0), (7, 5.0)])
def test_decode_kernel_window_softcap_matches_plain(dev, kv, cd, window, cap):
    """Windows that skip whole blocks and mask partial ones; q scaled so
    raw scores pass the cap and the tanh bites."""
    lens = [0, 1, 6, 17, 40, 41, 130]
    p, table = pools(lens, kv, dev, seed=4)
    q = (torch.randn(len(lens), HQ, D, device=dev) * 8).to(cd)
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    kw = dict(compute_dtype=cd, window=window, softcap=cap)
    got = paged_attention(q, *p, table, sl, kv, **kw)
    torch.cuda.synchronize()
    want = paged_attention_ref(q, *p, table, sl, kv, **kw)
    close(got, want, cd)
    if cap is not None:
        # a kernel that ignored the cap would fail the comparison above
        uncapped = paged_attention_ref(q, *p, table, sl, kv, compute_dtype=cd,
                                       window=window)
        assert not within(uncapped, want, cd)


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv", SCHEMES)
@pytest.mark.parametrize("T", [5, 40])
def test_chunk_kernel_window_softcap_matches_plain(dev, kv, cd, T):
    """Window 20 with starts on both sides of it (context blocks and
    fresh tiles below a row tile's window are skipped) and cap 5."""
    starts = [0, 3, 16, 40, 100]
    p, table = pools([max(s, 1) for s in starts], kv, dev, seed=5)
    B = len(starts)
    q = (torch.randn(B, T, HQ, D, device=dev) * 8).to(cd)
    kn = torch.randn(B, T, HKV, D, device=dev)
    vn = torch.randn(B, T, HKV, D, device=dev)
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    kw = dict(compute_dtype=cd, window=20, softcap=5.0)
    got = paged_chunk_attention_cuda(q, kn, vn, *p, table, st, kv, **kw)
    torch.cuda.synchronize()
    want = paged_chunk_attention(q, kn, vn, *p, table, st, kv, **kw)
    close(got, want, cd)


def decode_case(dev, kv, cd, lens, seed, heads=(HQ, HKV, D), num_splits=None,
                sinks=False, q_scale=1.0, bs=BS, **kw):
    """K1 on random pools against its plain version: (got, the unsplit
    plain result, the plain result in the split form of the count the
    kernel ran, that count). One launch, counted under (scheme, window) and
    under its split count."""
    hq, hkv, d = heads
    p, table = pools(lens, kv, dev, seed, bs=bs, hkv=hkv, d=d)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q = (torch.randn(len(lens), hq, d, device=dev, generator=gen)
         * q_scale).to(cd)
    sk = (torch.randn(hq, device=dev, generator=gen) * 2) if sinks else None
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    args = (q, *p, table, sl, kv)
    kw = dict(kw, compute_dtype=cd, sinks=sk)
    S = num_splits or default_splits(q, p[0], table, kw.get("window"))
    n0, s0 = launched(paged_attention), paged_attention.split_launches[S]
    got = paged_attention(*args, num_splits=num_splits, **kw)
    torch.cuda.synchronize()
    assert launched(paged_attention) == n0 + 1
    assert paged_attention.split_launches[S] == s0 + 1
    return (got, paged_attention_ref(*args, **kw),
            paged_attention_ref(*args, num_splits=S, **kw), S)


@pytest.mark.parametrize("k", [2, 5])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv", SCHEMES)
def test_decode_kernel_forced_splits_match_plain(dev, kv, cd, k):
    """K1 at a forced split count with window 40 (mid-block), cap 5 and
    sinks: against the plain version's split form at the same count and
    against the unsplit plain version; a seq_len 0 lane gives zeros."""
    got, want, want_k, S = decode_case(dev, kv, cd, [0, 1, 15, 16, 17, 130],
                                       seed=21, num_splits=k, sinks=True,
                                       q_scale=8.0, window=40, softcap=5.0)
    assert S == k
    close(got, want_k, cd)
    close(got, want, cd)
    assert not got[0].any()


@pytest.mark.parametrize("sinks", [False, True])
@pytest.mark.parametrize("window", [None, 700])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv", SCHEMES)
def test_decode_kernel_long_context_matches_plain(dev, kv, cd, window, sinks):
    """Lanes of 1000-4100 tokens (most not a multiple of bs) beside lanes
    of length 0, Mistral-like heads (G 4, D 128), at the split count the
    rule chooses (12 CTAs: S > 1); window 700 starts each lane's walk in the
    middle of a block and cuts the attended blocks the splits share."""
    got, want, want_s, S = decode_case(
        dev, kv, cd, [1000, 0, 2049, 4100, 0, 3333], seed=22,
        heads=(8, 2, 128), sinks=sinks, window=window)
    assert S > 1
    close(got, want_s, cd)
    close(got, want, cd)
    assert not got[1].any() and not got[4].any()


@pytest.mark.parametrize("sinks", [False, True])
@pytest.mark.parametrize("window", [None, 20])
def test_decode_kernel_empty_splits(dev, window, sinks):
    """More splits than a lane has (attended) blocks: the empty splits add
    nothing, at both compute dtypes; window 20 leaves a lane of 130 tokens
    2-3 blocks for 12 splits."""
    for cd in (torch.float32, torch.bfloat16):
        got, want, want_s, S = decode_case(
            dev, KVDtype.INT8, cd, [0, 1, 16, 17, 40, 130], seed=23,
            num_splits=12, sinks=sinks, window=window)
        close(got, want_s, cd)
        close(got, want, cd)
        assert not got[0].any()


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
def test_decode_kernel_gemma_heads_auto_splits(dev, cd):
    """Gemma-2's heads (G 2, D 256: 68 KB of shared memory a CTA) at the
    split count the rule chooses, window 1000 and cap 50 (q x 16 so the cap
    bites)."""
    got, want, want_s, S = decode_case(
        dev, KVDtype.INT8, cd, [0, 1, 33, 1500, 2500], seed=24,
        heads=(4, 2, 256), q_scale=16.0, window=1000, softcap=50.0)
    assert S > 1
    close(got, want_s, cd)
    close(got, want, cd)


def test_decode_split_launches_count_the_split(dev):
    """`split_launches` counts each call once under the split count it
    launched (the merge kernel is not counted apart); `launches` counts
    the call once whatever S."""
    for k in (1, 3, None):
        got, _, want_s, S = decode_case(dev, KVDtype.INT8, torch.float32,
                                        [5, 300, 0], seed=25, num_splits=k)
        assert S == k if k else S >= 1
        close(got, want_s, torch.float32)
    with pytest.raises(ValueError, match="num_splits"):
        decode_case(dev, KVDtype.INT8, torch.float32, [5], seed=25,
                    num_splits=65)


def chunk_case(dev, kv, cd, T, starts, seed, heads=(HQ, HKV, D), bs=BS,
               q_dtype=None, **kw):
    """K2 on random pools and chunks against its plain version: (got,
    want, plain call). One launch, counted under (scheme, window)."""
    hq, hkv, d = heads
    p, table = pools([max(s, 1) for s in starts], kv, dev, seed, bs=bs,
                     hkv=hkv, d=d)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    B = len(starts)
    q = torch.randn(B, T, hq, d, device=dev, generator=gen).to(q_dtype or cd)
    kn = torch.randn(B, T, hkv, d, device=dev, generator=gen)
    vn = torch.randn(B, T, hkv, d, device=dev, generator=gen)
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    args = (q, kn, vn, *p, table, st, kv)
    kw = dict(kw, compute_dtype=cd)
    key = (kv.value, kw.get("window") or 0)
    n0 = paged_chunk_attention_cuda.launches[key]
    got = paged_chunk_attention_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert paged_chunk_attention_cuda.launches[key] == n0 + 1
    plain = lambda **over: paged_chunk_attention(*args, **dict(kw, **over))
    return got, plain(), plain


@pytest.mark.parametrize("sinks", [False, True])
@pytest.mark.parametrize("window", [None, 700])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv", SCHEMES)
def test_chunk_kernel_long_context_matches_plain(dev, kv, cd, window, sinks):
    """Long lanes (starts 1000-4100, most not a multiple of bs) beside
    start-0 lanes, Mistral-like heads (G 4, D 128: T * G = 160 rows, not a
    multiple of the tensor-core kernel's 64); window 700 starts each row's
    context in the middle of a block; sinks join at finalize."""
    hq = 8
    sk = (torch.randn(hq, device=dev) * 2) if sinks else None
    got, want, plain = chunk_case(dev, kv, cd, 40, [1000, 0, 2049, 4100, 0,
                                                    3333], seed=11,
                                  heads=(hq, 2, 128), window=window,
                                  sinks=sk)
    close(got, want, cd)
    if sinks:
        assert not within(plain(sinks=None), want, cd)


@pytest.mark.parametrize("bs", [8, 32])
@pytest.mark.parametrize("heads", [(4, 4, 96), (14, 2, 64)],
                         ids=["G1-D96", "G7-D64"])
@pytest.mark.parametrize("kv", SCHEMES)
def test_chunk_kernel_groups_and_block_sizes(dev, kv, heads, bs):
    """G = 1 (Phi-3's MHA, D 96) and G = 7, T = 37 (37 and 259 rows: the
    last 64-row tile part padding, tiles spanning several t), bs 8 (the
    tensor-core kernel pads its k-dimension to 16 with zero rows) and 32,
    with a window cutting blocks and fresh tiles in the middle."""
    for cd in (torch.float32, torch.bfloat16):
        for window in (None, 45):
            got, want, _ = chunk_case(dev, kv, cd, 37, [0, 5, 100, 517, 64],
                                      seed=12, heads=heads, bs=bs,
                                      window=window)
            close(got, want, cd)


# float32 q at bf16 compute: the output stays float32, so it is not rounded
# to bf16 at the end; kernel and plain version round q and p * vs to bf16
# alike and differ only in the order of float32 sums, which can move a
# value of p * vs across a bf16 rounding boundary (one step of 2^-8 on one
# term of a sum over thousands). Measured on an H100 80GB HBM3 at 700 W
# (PERF.md): the
# largest |got - want| / (1 + |want|) was 1.6e-4 at this test's cases and
# 2.7e-4 at Gemma-2's heads (D 256, window 4096, cap 50); 1e-3 leaves a
# margin of ~4x, 20x tighter than the bf16-output tolerance.
TOL_F32_Q = 1e-3


# ---------------------------------------------------------------------------
# speculative decoding's shapes: K2 scores gamma + 1 verify positions at any
# start inside a block; K1 runs the draft (Llama-3.2-1B: 32 / 8 heads of 64)
# over 8 lanes of 65-136 tokens in 32-token blocks
# ---------------------------------------------------------------------------

SPEC_HEADS = {64: (32, 8, 64), 128: (32, 8, 128), 256: (16, 8, 256)}


@pytest.mark.parametrize("variant", ["plain", "window+sinks"])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [2, 5, 9])
def test_chunk_kernel_verify_shapes_match_plain(dev, T, cd, d, variant):
    """K2 at the verify shape, B 8, 32-token blocks: four calls whose 32
    lanes start at every offset inside a block (0 .. 31, at blocks 0 .. 4,
    so a chunk starts at a boundary, inside, and crosses into the next
    block); window 40 (mid-block) with sinks, or neither. INT8 pools, the
    verify's scheme."""
    bs = 32
    starts = [off + bs * (off * 7 % 5) for off in range(bs)]
    kw = {}
    if variant != "plain":
        kw = dict(window=40,
                  sinks=torch.randn(SPEC_HEADS[d][0], device=dev) * 2)
    for c in range(0, bs, 8):
        got, want, plain = chunk_case(dev, KVDtype.INT8, cd, T,
                                      starts[c:c + 8], seed=40 + c, bs=bs,
                                      heads=SPEC_HEADS[d], **kw)
        close(got, want, cd)
        if kw:
            assert not within(plain(sinks=None), want, cd)


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv", SCHEMES)
def test_decode_kernel_draft_shape_matches_plain(dev, kv, cd):
    """K1 at the draft's shape: Llama-3.2-1B's heads (G 4, D 64), 8 lanes
    of 65-136 tokens (the served prompts of 64, grown by up to 64 tokens
    and gamma + 1 proposals), 32-token blocks, at the split count the rule
    chooses; against the unsplit plain version and its split form."""
    lens = [65, 66, 96, 97, 100, 127, 128, 136]
    got, want, want_s, S = decode_case(dev, kv, cd, lens, seed=31,
                                       heads=SPEC_HEADS[64], bs=32)
    close(got, want_s, cd)
    close(got, want, cd)


@pytest.mark.parametrize("onehot", [False, True])
def test_accept_core_on_card_matches_cpu(dev, onehot):
    """`engine/spec.accept_core` on the card against the same call on the
    CPU: greedy lanes' n_acc and final bit for bit, at the served shape (8
    lanes, gamma 4, Llama-3's 128256 tokens), beside sampled lanes and
    through the greedy-only path."""
    from cxl_speckv_tpu_torch.engine.spec import accept_core

    B, gamma, V = 8, 4, 128256
    rng = np.random.RandomState(5)
    tgt = torch.from_numpy(rng.randn(B, gamma + 1, V).astype(np.float32))
    dl = None if onehot else torch.from_numpy(
        rng.randn(B, gamma, V).astype(np.float32))
    drafts = torch.from_numpy(rng.randint(0, V, (B, gamma)).astype(np.int32))
    preds = tgt.argmax(-1)
    for b in range(B):
        drafts[b, :b % (gamma + 1)] = preds[b, :b % (gamma + 1)]
    temps = torch.tensor([0.0, 0.8] * (B // 2))
    top_ps = torch.zeros(B)
    greedy = (temps <= 0).numpy()
    for sampled in (False, True):
        t = temps if sampled else torch.zeros(B)
        keep = greedy if sampled else np.ones(B, bool)
        outs = []
        for device in ("cpu", dev):
            on = lambda x: None if x is None else x.to(device)
            gen = torch.Generator(device=device).manual_seed(3)
            outs.append(accept_core(on(tgt), on(dl), on(drafts), on(t),
                                    on(top_ps), gen, gamma=gamma,
                                    sampled=sampled, nucleus=False))
        for cpu, card in zip(*outs):
            assert torch.equal(cpu[keep], card.cpu()[keep])


@pytest.mark.parametrize("kv", SCHEMES)
def test_chunk_kernel_f32_query_bf16_compute(dev, kv):
    got, want, _ = chunk_case(dev, kv, torch.bfloat16, 40,
                              [1000, 0, 2049, 4100], seed=13,
                              heads=(8, 2, 128), q_dtype=torch.float32,
                              window=700, softcap=30.0)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    d = (got - want).abs()
    assert bool((d <= TOL_F32_Q + TOL_F32_Q * want.abs()).all()), float(d.max())


def test_chunk_kernel_bf16_refuses_head_dim(dev):
    """At bf16 compute the tensor-core kernel needs head_dim % 16 == 0: any
    other raises (nothing falls back to the float32 kernel or the plain
    version); float32 compute takes it."""
    with pytest.raises(ValueError, match="head_dim 72"):
        chunk_case(dev, KVDtype.INT8, torch.bfloat16, 5, [0, 20], seed=14,
                   heads=(4, 2, 72))
    got, want, _ = chunk_case(dev, KVDtype.INT8, torch.float32, 5, [0, 20],
                              seed=14, heads=(4, 2, 72))
    close(got, want, torch.float32)


def test_engine_on_card_tiers_invisibly(dev):
    """The tiny model served on the card: oversubscribed == ample, through
    both kernels."""
    from cxl_speckv_tpu_torch.config import (
        CacheConfig,
        EngineConfig,
        PrefetchConfig,
        SystemConfig,
    )
    from cxl_speckv_tpu_torch.engine import Engine
    from cxl_speckv_tpu_torch.models.configs import tiny_test_config

    def run(hbm):
        sc = SystemConfig(
            cache=CacheConfig(block_size=8, num_hbm_blocks=hbm,
                              num_host_blocks=256, kv_dtype=KVDtype.INT8),
            prefetch=PrefetchConfig(enabled=True, depth=2),
            engine=EngineConfig(max_batch_size=2, max_seq_len=128,
                                prefill_chunk=32, decode_horizon=4))
        eng = Engine(tiny_test_config(), sc, device=None, seed=3)
        rng = np.random.RandomState(3)
        ps = [rng.randint(1, 256, rng.randint(6, 24)).tolist()
              for _ in range(8)]
        return eng.generate(ps, max_new_tokens=12), eng.get_statistics()

    k1, k2 = launched(paged_attention), launched(paged_chunk_attention_cuda)
    ample, _ = run(256)
    tight, st = run(14)
    assert tight == ample
    assert st["transfer"]["up_transfers"] > 0
    assert launched(paged_attention) > k1
    assert launched(paged_chunk_attention_cuda) > k2


def test_pcont_leg_on_card_matches_cpu(dev):
    """The decode round's continue-probability leg (`lstm_pcont`) on the
    card equals the CPU's within 1e-5 (float32) at the served shapes."""
    from cxl_speckv_tpu_torch.prefetcher.lstm import (
        LSTMPredictor,
        lstm_pcont,
        tree_to,
    )

    pred = LSTMPredictor(128256, seed=2)
    gen = torch.Generator().manual_seed(4)
    hist = torch.randint(0, pred.n_classes, (8, 16), generator=gen,
                         dtype=torch.int32)
    fresh = torch.randint(0, 128256, (8, 32), generator=gen,
                          dtype=torch.int32)
    want = lstm_pcont(pred.params, hist, fresh, 7)
    got = lstm_pcont(tree_to(pred.params, dev), hist.to(dev), fresh.to(dev),
                     7)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)


def test_default_engine_config_on_card(dev):
    """EngineConfig() with its defaults on the card: the horizon is derived
    from the dispatch cost measured there and written back, and the
    requests are served as at a fixed horizon of 4."""
    from cxl_speckv_tpu_torch.config import (
        CacheConfig,
        EngineConfig,
        SystemConfig,
    )
    from cxl_speckv_tpu_torch.engine import Engine
    from cxl_speckv_tpu_torch.models.configs import tiny_test_config

    rng = np.random.RandomState(5)
    ps = [rng.randint(1, 256, 12).tolist() for _ in range(4)]
    outs = {}
    for h in (0, 4):
        sc = SystemConfig(cache=CacheConfig(block_size=8, num_hbm_blocks=64,
                                            num_host_blocks=64),
                          engine=EngineConfig(decode_horizon=h))
        eng = Engine(tiny_test_config(), sc, device=None, seed=3)
        assert sc.engine.decode_horizon >= 1
        outs[h] = eng.generate(ps, max_new_tokens=9)
    assert outs[0] == outs[4]


# ---------------------------------------------------------------------------
# the decode-anatomy probes P1-P3 (ops/decode_anatomy.py): every mode,
# variant and ring depth against its plain version, at Llama-3-8B's heads
# and the served block size, lanes of 300, 257, 33 and 0 tokens at shuffled
# slots; P1 and P3 at one split, the derived count and a forced 7 (more
# than the 33-token lane's 2 blocks), and a second call bit-equal to the
# first. Sums within 1e-5 of (|plain| + the plain sum of |terms|), fetchint
# exact; matmul / matmulT within 2e-3 of each (lane, head)'s largest value;
# P2 (float32 outputs) within the float32 tolerance above, against its
# plain version's split form at the kernel's count, and at one split
# against K1.
# ---------------------------------------------------------------------------

def probe_pools(scheme, seed=11):
    from cxl_speckv_tpu_torch.ops import decode_anatomy as da

    return da.build_pools(scheme, 32, 300, batch=4, heads=(32, 8, 128),
                          seed=seed, lens=[300, 257, 33, 0], shuffle=True,
                          device="cuda")


def held_to_plain(da, mode, got, want, args):
    if mode == "fetchint":
        assert torch.equal(got, want)
    elif mode in da.SUM_MODES:
        err, ok = da.within_sum(got, want,
                                da.variant_plain(mode, *args, absolute=True))
        assert ok, err
    else:
        err, ok = da.within_rows(got, want)
        assert ok, err


@pytest.mark.parametrize("splits", [1, None, 7])
@pytest.mark.parametrize("scheme", ["int8", "int4", "bf16"])
@pytest.mark.parametrize("mode", ["fetchrow", "fetchint", "fetch", "dequant",
                                  "matmul", "matmulT"])
def test_anatomy_variant_kernel_matches_plain(dev, scheme, mode, splits):
    from cxl_speckv_tpu_torch.ops import decode_anatomy as da

    p = probe_pools(scheme)
    args = (p.q, *p.token_major(), p.table, p.lens, p.kv)
    n0 = da.variant.launches[mode]
    got = da.variant(mode, *args, num_splits=splits)
    again = da.variant(mode, *args, num_splits=splits)
    torch.cuda.synchronize()
    assert da.variant.launches[mode] == n0 + 2
    assert torch.equal(got, again)
    want = da.variant_plain(mode, *args)
    held_to_plain(da, mode, got, want, args)
    assert not got[3].any()                       # seq_len 0 -> zeros


@pytest.mark.parametrize("splits", [None, 1])
@pytest.mark.parametrize("scheme", ["int8", "bf16"])
@pytest.mark.parametrize("depth", [0, 2, 4, 8])
@pytest.mark.parametrize("mode", ["fetchrow", "fetchint", "fetch", "dequant",
                                  "matmul", "matmulT"])
def test_anatomy_variant_depths_match_plain(dev, scheme, mode, depth, splits):
    """Every ring depth P1 takes, and the register path (depth 0) of the
    sum modes that have one; the others refuse depth 0. At one split the
    300-token lane walks 10 blocks in one CTA, more than the ring's stages
    and than its consumer warps."""
    from cxl_speckv_tpu_torch.ops import decode_anatomy as da

    p = probe_pools(scheme, seed=12)
    args = (p.q, *p.token_major(), p.table, p.lens, p.kv)
    if depth == 0 and mode in ("fetchrow", "matmul", "matmulT"):
        with pytest.raises(ValueError, match="depth"):
            da.variant(mode, *args, depth=0, num_splits=splits)
        return
    got = da.variant(mode, *args, depth=depth, num_splits=splits)
    torch.cuda.synchronize()
    held_to_plain(da, mode, got, da.variant_plain(mode, *args), args)


@pytest.mark.parametrize("scheme", ["int8", "bf16"])
def test_anatomy_long_walk_matches_plain(dev, scheme):
    """One split of 282 blocks: the ring stages the table slice in windows
    of 256 entries, so the walk passes a window's end (P1, P2 and P3)."""
    from cxl_speckv_tpu_torch.ops import decode_anatomy as da

    p = da.build_pools(scheme, 32, 9000, batch=2, heads=(32, 8, 128), seed=13,
                       lens=[9000, 8200], shuffle=True, device="cuda")
    args = (p.q, *p.token_major(), p.table, p.lens, p.kv)
    for mode in ("fetchrow", "fetch", "fetchint", "matmulT"):
        for depth in (None, 0) if mode in ("fetch", "fetchint") else (None,):
            got = da.variant(mode, *args, num_splits=1, depth=depth)
            torch.cuda.synchronize()
            held_to_plain(da, mode, got, da.variant_plain(mode, *args), args)
    got = da.ring(8, *args[1:], num_splits=1)
    held_to_plain(da, "fetchrow", got, da.variant_plain("fetchrow", *args),
                  args)
    kt_held_to_plain(da, p, "v2", 1)              # P2 past a window too


def kt_held_to_plain(da, p, name, splits=None, depth=None):
    """P2 `name` on `p` twice: the two bit-equal, each within rtol = atol =
    2e-4 of the plain version's split form at the kernel's own count, a
    0-token lane zeros; returns (output, its split count)."""
    sc = (p.scf, None) if name == "v3fused" else (p.ks, p.vs)
    args = (p.q, p.kt, p.v, *sc, p.table, p.lens, p.kv, name)
    n0 = da.kt_attention.launches[name]
    got = da.kt_attention(*args, num_splits=splits, depth=depth)
    again = da.kt_attention(*args, num_splits=splits, depth=depth)
    torch.cuda.synchronize()
    assert da.kt_attention.launches[name] == n0 + 2
    assert torch.equal(got, again)
    ns = splits or da.probe_setting(name, p, depth)[1]
    close(got, da.kt_attention_plain(*args, num_splits=ns), torch.float32)
    for b, n in enumerate(p.lens.tolist()):
        if n == 0:
            assert not got[b].any()
    return got, ns


@pytest.mark.parametrize("splits", [1, None, 7])
@pytest.mark.parametrize("scheme", ["int8", "int4", "bf16"])
@pytest.mark.parametrize("name", ["v2", "v3fused", "w8a8"])
def test_anatomy_kt_kernel_matches_plain(dev, scheme, name, splits):
    """P2 at one split, its derived count and a forced 7 (more than the
    33-token lane's 2 blocks), against the plain version's split form at
    that count; at one split v2 and v3fused also against K1 unsplit (each
    lane one walk in block order in both)."""
    from cxl_speckv_tpu_torch.ops import decode_anatomy as da

    p = probe_pools(scheme)
    sc = (p.scf, None) if name == "v3fused" else (p.ks, p.vs)
    args = (p.q, p.kt, p.v, *sc, p.table, p.lens, p.kv, name)
    if name == "w8a8" and scheme == "bf16":
        with pytest.raises(ValueError, match="w8a8"):
            da.kt_attention(*args, num_splits=splits)
        return
    got, _ = kt_held_to_plain(da, p, name, splits)
    if name != "w8a8" and splits == 1:
        k1 = paged_attention(p.q, *p.token_major(), p.table, p.lens, p.kv,
                             compute_dtype=torch.bfloat16, num_splits=1)
        close(got, k1, torch.float32)


@pytest.mark.parametrize("splits", [None, 1])
@pytest.mark.parametrize("scheme", ["int8", "int4", "bf16"])
@pytest.mark.parametrize("geometry", ["bs8-d32", "bs128", "d256"])
def test_anatomy_kt_block_sizes_match_plain(dev, scheme, geometry, splits):
    """bs 8 at D 32, Hkv 2 (a head's columns of a kT row are 8 bytes at
    INT8 and INT4: the TMA box widened to 16 bytes, over the neighbour
    head's columns or zeros past the last head), bs 128 at Llama-3-8B's
    heads (a stage of 33 KB at INT8; BF16 halves the ring to 2 stages) and
    D 256 at Gemma's heads (two CTAs a (lane, head, split), each holding
    half of D), every variant the wrapper takes."""
    from cxl_speckv_tpu_torch.ops import decode_anatomy as da

    if geometry == "bs8-d32":
        p = da.build_pools(scheme, 8, 64, batch=3, heads=(8, 2, 32), seed=21,
                           lens=[64, 37, 0], shuffle=True, device="cuda")
    elif geometry == "d256":
        p = da.build_pools(scheme, 32, 300, batch=3, heads=(16, 8, 256),
                           seed=23, lens=[300, 200, 0], shuffle=True,
                           device="cuda")
    else:
        p = da.build_pools(scheme, 128, 1024, batch=4, heads=(32, 8, 128),
                           seed=22, lens=[1024, 1000, 129, 0], shuffle=True,
                           device="cuda")
    for name in da.P2_VARIANTS:
        if name == "w8a8" and scheme == "bf16":
            continue
        kt_held_to_plain(da, p, name, splits)


@pytest.mark.parametrize("scheme", ["int8", "bf16"])
@pytest.mark.parametrize("depth", [2, 4, 8])
def test_anatomy_kt_depths_match_plain(dev, scheme, depth):
    """Every ring depth P2 takes at bs 32, at its derived count and at one
    split (the 300-token lane's 10 blocks in one CTA: more than the ring's
    stages and its consumer warps, so the running max passes from warp to
    warp around the ring)."""
    from cxl_speckv_tpu_torch.ops import decode_anatomy as da

    p = probe_pools(scheme, seed=12)
    for name in ("v2", "v3fused"):
        for splits in (None, 1):
            kt_held_to_plain(da, p, name, splits, depth)


@pytest.mark.parametrize("splits", [1, None, 7])
@pytest.mark.parametrize("scheme", ["int8", "int4", "bf16"])
@pytest.mark.parametrize("nbuf", [4, 8, 16])
def test_anatomy_ring_kernel_matches_plain(dev, scheme, nbuf, splits):
    """bs 32, D 128: a BF16 stage is 16 KB + 256 B, so 16 of them (264 KB)
    do not fit in the 227 KB a block may have and must be refused."""
    from cxl_speckv_tpu_torch.ops import decode_anatomy as da

    p = probe_pools(scheme)
    args = (*p.token_major(), p.table, p.lens, p.kv)
    if scheme == "bf16" and nbuf == 16:
        with pytest.raises(ValueError, match="shared memory"):
            da.ring(nbuf, *args, num_splits=splits)
        return
    got = da.ring(nbuf, *args, num_splits=splits)
    again = da.ring(nbuf, *args, num_splits=splits)
    torch.cuda.synchronize()
    assert da.ring.launches[f"v5ring{nbuf}"] > 0
    assert torch.equal(got, again)
    want = da.variant_plain("fetchrow", p.q, *args)
    err, ok = da.within_sum(got, want, da.variant_plain(
        "fetchrow", p.q, *args, absolute=True))
    assert ok, err


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv", [KVDtype.INT8, KVDtype.FP8])
def test_chunk_kernel_session_turn_matches_plain(dev, kv, cd):
    """K2 at a session turn's shape: T 33 (the last reply token + 32 new
    ones) at unaligned starts 96-191 over a restored context (blocks at
    shuffled slots, as promotes from the host tier place them), Llama-3
    heads (G 4, D 128), bs 32: 132 query rows, not a multiple of the
    tensor-core kernel's 64."""
    got, want, _ = chunk_case(dev, kv, cd, 33,
                              [96, 127, 150, 191, 100, 161, 130, 175],
                              seed=41, heads=(16, 4, 128), bs=32)
    close(got, want, cd)


@pytest.mark.parametrize("seed", [0, 1])
def test_pen_plane_on_card_matches_cpu_bitwise(dev, seed):
    """The sampling-penalty plane of `engine/sampling.py` on the card at the
    served shape ([8, 128256], 16 rows + guard) equals the same functions
    on the CPU bit for bit: reset, prompt mark, penalized greedy draw and
    count."""
    from cxl_speckv_tpu_torch.engine import sampling as ts

    B, V, R = 8, 128256, 16
    rng = np.random.RandomState(seed)
    logits = (rng.randn(B, V) * 3).astype(np.float32)
    plane = rng.randint(0, 9, (R + 1, V)).astype(np.int32)
    plane[rng.rand(R + 1, V) < 0.05] |= ts.PEN_PROMPT_BIT
    info = np.array([ts.encode_pen_info(
        [0, 3, R, 5, 7, 9, 11, 15][b], *[(0.5, 0.5, 0.0), (0.0, 0.0, 1.3),
                                         (0.0, 0.0, 0.0), (-1.2, 0.7, 1.9)][b % 4],
        reset=b == 5, count_sampled=b != 4) for b in range(B)], np.int32)
    ids = rng.randint(0, V, (B, 64)).astype(np.int32)
    valid = rng.randint(0, 65, B).astype(np.int32)
    out = []
    for device in ("cpu", dev):
        t = lambda a: torch.from_numpy(a.copy()).to(device)
        pc, pi = t(plane), t(info)
        ts.pen_reset_rows(pi, pc)
        ts.pen_mark_prompt(pi, pc, t(ids), t(valid))
        toks, _ = ts.penalize_and_count(t(logits), pi, pc,
                                        lambda lg: lg.argmax(-1))
        out.append((toks.cpu(), pc.cpu()))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


# ---------------------------------------------------------------------------
# the host-streamed path: the pinned store's reads and writes, and streamed
# attention on the card against its CPU run
# ---------------------------------------------------------------------------

def stream_store(kv, pin, seed=21, slots=24, layers=3, bs=16, hkv=2, d=64):
    from cxl_speckv_tpu_torch.ops.quant import kv_pack, kv_storage_dtype
    from cxl_speckv_tpu_torch.runtime.hoststore import DeviceHostStore

    rng = np.random.RandomState(seed)
    st = DeviceHostStore(slots, layers, bs, hkv, d // kv_pack(kv),
                         kv_storage_dtype(kv), pin=pin)
    for a in (st.k, st.v):
        a.copy_(torch.from_numpy(rng.randint(-128, 128, a.shape)
                                 .astype(np.int8)))
    for a in (st.ks, st.vs):
        a.copy_(torch.from_numpy(rng.uniform(0.002, 0.02, a.shape)
                                 .astype(np.float32)))
    return st


@pytest.mark.parametrize("kv", [KVDtype.INT8, KVDtype.INT4])
def test_pinned_store_round_trip_is_byte_exact(dev, kv):
    """Pinned store -> device slab (whole blocks, a layer of a wave, a
    layer group) -> stash back: every byte where it came from, and the
    stash lands before the next read of those rows (stream order)."""
    from cxl_speckv_tpu_torch.runtime import hoststore as hs

    st = stream_store(kv, pin=True)
    assert st.k.is_pinned() and st.ks.is_pinned()
    ref = [a.clone() for a in st.arrays]
    slots = np.array([3, 4, 5, 11, 24, 0])          # runs, a gap, the guard
    L = st.num_layers
    rows = (slots[:, None] * L + np.arange(L)).reshape(-1)
    blocks = hs.fetch_blocks(st, slots, dev)
    for g, r in zip(blocks, ref):
        assert g.is_cuda
        assert torch.equal(g.cpu(), r[rows].reshape(g.shape))
    layer = hs.fetch_layer(st, slots, 1, dev)
    group = hs.stage_layers(st, slots, 1, 2, dev)
    for g, gr, r in zip(layer, group, ref):
        assert torch.equal(g.cpu(), r[slots * L + 1])
        assert torch.equal(gr[:, 0].cpu(), r[slots * L + 1])
    # write changed slabs to other slots, then read them straight back
    new = tuple(torch.randint_like(a, -100, 100) if a.dtype == torch.int8
                else torch.rand_like(a) for a in blocks[:4])
    dst = np.array([7, 8, 9, 15, 16, 20])
    hs.stash_blocks(st, new, dst)
    back = hs.fetch_blocks(st, dst, dev)
    for b, n in zip(back, new):
        assert torch.equal(b, n)
    torch.cuda.synchronize()
    drows = (dst[:, None] * L + np.arange(L)).reshape(-1)
    for a, n, r in zip(st.arrays, new, ref):
        assert torch.equal(a[drows], n.cpu().reshape(-1, *a.shape[1:]))
        keep = np.setdiff1d(np.arange(a.shape[0]), drows)
        assert torch.equal(a[keep], r[keep])


@pytest.mark.parametrize("kv,T,start,window,softcap", [
    (KVDtype.INT8, 1, 300, None, None), (KVDtype.INT8, 64, 200, None, None),
    (KVDtype.INT4, 5, 333, 100, 50.0), (KVDtype.FP8, 1, 250, None, 30.0)])
def test_stream_attention_on_card_matches_cpu(dev, kv, T, start, window,
                                              softcap):
    """stream_context_attention (waves fetched from the pinned store) and
    its slab form on the card against the same functions on the CPU, with
    the chunk merge and sinks: float32 throughout, so within 2e-4; the two
    card forms bit for bit equal."""
    from cxl_speckv_tpu_torch.ops import stream_attention as sa
    from cxl_speckv_tpu_torch.runtime import hoststore as hs

    bs, wave, L, layer = 16, 4, 3, 2
    cpu_st, card_st = stream_store(kv, pin=False), stream_store(kv, pin=True)
    n_blocks = -(-(start + T) // bs)
    rng = np.random.RandomState(start)
    row = np.full(24, 24, np.int32)
    row[:n_blocks] = rng.permutation(24)[:n_blocks]
    q = torch.from_numpy(rng.randn(T, 8, 64).astype(np.float32))
    kn = torch.from_numpy(rng.randn(T, 2, 64).astype(np.float32))
    vn = torch.from_numpy(rng.randn(T, 2, 64).astype(np.float32))
    sinks = torch.from_numpy(rng.randn(8).astype(np.float32))
    kw = dict(sm_scale=0.125, window=window, softcap=softcap)
    outs = {}
    for name, st, d in (("cpu", cpu_st, "cpu"), ("card", card_st, dev)):
        carry = sa.stream_context_attention(q.to(d), st, row, start, layer,
                                            kv, bs, 24, wave, **kw)
        slab = tuple(a[:, 0] for a in hs.stage_layers(st, row, layer, 1, d))
        staged = sa.stream_context_attention_slab(q.to(d), slab, start, kv,
                                                  bs, wave, **kw)
        for a, b in zip(carry, staged):
            assert torch.equal(a, b)
        outs[name] = sa.merge_chunk_causal(q.to(d), kn.to(d), vn.to(d), carry,
                                           sinks=sinks.to(d), **kw)
    torch.testing.assert_close(outs["card"].cpu(), outs["cpu"], rtol=2e-4,
                               atol=2e-4)


def test_streamed_engine_on_card_matches_ample(dev):
    """A streamed request on the card (pinned host tier, staged gathers
    and the fused decode) gives the per-wave / per-token run's tokens bit
    for bit and launches neither kernel."""
    from cxl_speckv_tpu_torch.config import (
        CacheConfig,
        EngineConfig,
        PrefetchConfig,
        SystemConfig,
    )
    from cxl_speckv_tpu_torch.engine import Engine
    from cxl_speckv_tpu_torch.models.configs import tiny_test_config

    def run(stage_mb):
        sc = SystemConfig(
            cache=CacheConfig(block_size=8, num_hbm_blocks=6,
                              num_host_blocks=64, kv_dtype=KVDtype.INT8),
            prefetch=PrefetchConfig(enabled=False),
            engine=EngineConfig(max_batch_size=2, max_seq_len=64,
                                prefill_chunk=16, decode_horizon=4,
                                stream_stage_mb=stage_mb))
        eng = Engine(tiny_test_config(), sc, device=None, seed=3)
        rng = np.random.RandomState(4)
        ps = [rng.randint(1, 256, n).tolist() for n in (40, 47)]
        return eng.generate(ps, max_new_tokens=12), eng.get_statistics()

    k1, k2 = launched(paged_attention), launched(paged_chunk_attention_cuda)
    fused, st = run(256)
    per_token, _ = run(0)
    assert fused == per_token and all(fused)
    assert st["engine"]["stream_tokens"] > 0
    assert launched(paged_attention) == k1
    assert launched(paged_chunk_attention_cuda) == k2


# -- migrations on the copy stream, fused rounds --------------------------------

def card_cache(hbm=8, host=16):
    from cxl_speckv_tpu_torch.config import CacheConfig
    from cxl_speckv_tpu_torch.models.configs import tiny_test_config
    from cxl_speckv_tpu_torch.runtime.kv_cache import TieredKVCache

    return TieredKVCache(
        CacheConfig(block_size=8, num_hbm_blocks=hbm, num_host_blocks=host,
                    kv_dtype=KVDtype.INT8), tiny_test_config(), 8, 8,
        device="cuda")


def card_demote(kvc, bid) -> int:
    kvc._demote([bid])
    host = kvc.directory.entry(bid).host_slot
    kvc.dispatch_migrations()
    return host


@pytest.mark.parametrize("kv", [KVDtype.INT8, KVDtype.INT4])
def test_copy_batch_on_card_matches_migrate_program(dev, kv):
    """The card's batch (`copy_batch`, on the cache's copy stream) against
    the plain `migrate_program` on copies of the same pools and pinned
    store: byte for byte, a demoted slot promoted into in the same batch."""
    from cxl_speckv_tpu_torch.runtime import hoststore as hs

    st, ref_st = stream_store(kv, pin=True), stream_store(kv, pin=True)
    L, S = st.num_layers, 30
    gen = torch.Generator(device=dev).manual_seed(1)
    pools = tuple(torch.randint(-127, 128, (L, S + 1, *a.shape[1:]),
                                generator=gen, device=dev).to(a.dtype)
                  for a in st.arrays[:2]) + tuple(
        torch.rand((L, S + 1, *a.shape[1:]), generator=gen, device=dev)
        for a in st.arrays[2:])
    ref = tuple(p.clone() for p in pools)
    mig = hs.pad_migration([(10 + i, i if i < 2 else 12 + i) for i in range(8)],
                           [(i, i) for i in range(6)], S, st.guard_slot)
    hs.migrate_program(ref, ref_st, mig)
    copier = hs.CopyStream(dev)
    copier.wait_for_compute()
    done, keep = copier.run(lambda mark: hs.copy_batch(pools, st, mig, mark))
    done.synchronize()
    for a, b in zip(pools + st.arrays, ref + ref_st.arrays):
        assert torch.equal(a, b)


def test_copy_stream_demote_after_round(dev):
    """(a) A demote issued behind a round still running on the compute
    stream copies the bytes that round writes."""
    kvc = card_cache()
    s = kvc.add_seq()
    kvc.extend_seq(s, 8)
    bid = kvc.pool.seq(s).blocks[0]
    slot = kvc.directory.entry(bid).hbm_slot
    torch.cuda.synchronize()
    hold = StreamHold()             # the round, held until released
    with hold:
        for p in kvc.pools:
            p[:, slot].fill_(7)
        host = card_demote(kvc, bid)
    kvc.drain()
    assert not hold.timed_out()
    for v in kvc.store.units(0, kvc.store.num_layers):
        assert bool((v[host] == 7).all())


def test_copy_stream_holds_demoted_slot(dev):
    """(b) While a demote's copy waits on a busy copy stream, its HBM slot
    is off the free list, the next block lands elsewhere, and the copy
    reads the old bytes; the slot returns when the copy has completed."""
    kvc = card_cache()
    s = kvc.add_seq()
    kvc.extend_seq(s, 8)
    for p in kvc.pools:
        p.fill_(3)
    bid = kvc.pool.seq(s).blocks[0]
    slot = kvc.directory.entry(bid).hbm_slot
    free0 = kvc.directory.hbm_free
    torch.cuda.synchronize()
    hold = StreamHold(kvc.copier.stream)
    with hold:
        host = card_demote(kvc, bid)
        assert kvc.transfer.inflight_down == 1
        assert not kvc.transfer.inflight[0].done.query()
        assert kvc.directory.hbm_free == free0
        s2 = kvc.add_seq()
        kvc.extend_seq(s2, 8)
        slot2 = kvc.directory.entry(kvc.pool.seq(s2).blocks[0]).hbm_slot
        assert slot2 != slot
        for p in kvc.pools:
            p[:, slot2].fill_(9)
    kvc.drain()
    assert not hold.timed_out()
    assert kvc.directory.hbm_free == free0
    for v in kvc.store.units(0, kvc.store.num_layers):
        assert bool((v[host] == 3).all())


def test_round_waits_for_its_promote(dev):
    """A round reading a slot whose promote waits on a busy copy stream
    sees the promoted bytes (`order_round`)."""
    kvc = card_cache()
    s = kvc.add_seq()
    kvc.extend_seq(s, 8)
    bid = kvc.pool.seq(s).blocks[0]
    for p in kvc.pools:
        p[:, kvc.directory.entry(bid).hbm_slot].fill_(5)
    card_demote(kvc, bid)
    kvc.drain()
    for p in kvc.pools:
        p.fill_(0)
    torch.cuda.synchronize()
    hold = StreamHold(kvc.copier.stream)
    with hold:
        kvc.ensure_resident([s])
        slot = kvc.directory.entry(bid).hbm_slot
        kvc.order_round([slot])
        seen = [p[:, slot].clone() for p in kvc.pools]
    torch.cuda.synchronize()
    assert not hold.timed_out()
    assert all(bool((x == 5).all()) for x in seen)


def test_fused_rounds_engine_on_card(dev):
    """The tiny model on the card, oversubscribed: fused rounds, the split
    pipeline (migrations on the copy stream) and an ample pool give the
    same tokens, both tiered runs migrating both ways."""
    from cxl_speckv_tpu_torch.config import (
        CacheConfig,
        EngineConfig,
        PrefetchConfig,
        SystemConfig,
    )
    from cxl_speckv_tpu_torch.engine import Engine
    from cxl_speckv_tpu_torch.models.configs import tiny_test_config

    def run(hbm, fused=False):
        sc = SystemConfig(
            cache=CacheConfig(block_size=8, num_hbm_blocks=hbm,
                              num_host_blocks=256, kv_dtype=KVDtype.INT8),
            prefetch=PrefetchConfig(enabled=True, depth=2),
            engine=EngineConfig(max_batch_size=2, max_seq_len=128,
                                prefill_chunk=32, decode_horizon=4,
                                fused_rounds=fused))
        eng = Engine(tiny_test_config(), sc, device=None, seed=3)
        assert eng._fused_rounds == fused
        rng = np.random.RandomState(5)
        ps = [rng.randint(1, 256, rng.randint(6, 24)).tolist()
              for _ in range(8)]
        return eng.generate(ps, max_new_tokens=12), eng.get_statistics()

    ample, _ = run(256)
    for fused in (False, True):
        got, st = run(14, fused)
        assert got == ample
        assert st["transfer"]["up_transfers"] > 0
        assert st["transfer"]["down_transfers"] > 0


# ---------------------------------------------------------------------------
# the attention shapes of Qwen3-8B (G 4), Qwen3-30B-A3B (G 8, K1's MAX_G),
# Gemma-3-12B (D 256, G 2, window 1024 on five layers of six) and Phi-3-mini
# (G 1, D 96), in 32-token blocks; and the HF converter on the card
# ---------------------------------------------------------------------------

FAMILY_HEADS = {"qwen3": ((32, 8, 128), None),
                "qwen3-moe": ((32, 4, 128), None),
                "gemma3-sliding": ((16, 8, 256), 1024),
                "gemma3-global": ((16, 8, 256), None),
                "phi3": ((32, 32, 96), None)}


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("family", list(FAMILY_HEADS))
def test_kernels_at_family_shapes_match_plain(dev, family, cd):
    """K1 over lanes around the 1024 window (a 0 lane, 1023-1025, 1344, at
    the split count the rule chooses) and K2 with 256-token chunks that
    start before, at and past the window, INT8 and INT4 pools, against
    their plain versions."""
    heads, window = FAMILY_HEADS[family]
    for kv in (KVDtype.INT8, KVDtype.INT4):
        got, want, split_want, _ = decode_case(
            dev, kv, cd, [0, 1, 1023, 1024, 1025, 1344], seed=60,
            heads=heads, bs=32, window=window)
        close(got, want, cd)
        close(got, split_want, cd)
        assert not got[0].any()
        got, want, _ = chunk_case(dev, kv, cd, 256, [0, 768, 1024, 1088],
                                  seed=61, heads=heads, bs=32, window=window)
        close(got, want, cd)


@pytest.mark.parametrize("family", ["qwen3_moe", "phi3"])
def test_hf_convert_int8_on_card_equals_cpu(dev, family):
    """`params_from_hf_state_dict(..., weight_dtype="int8")` on the card
    gives the CPU conversion's tree bit for bit (q bytes and scales): a
    random bf16 state dict with HF's names, Qwen3-MoE's expert stacks or
    Phi-3's fused qkv / gate_up."""
    import types

    from cxl_speckv_tpu_torch.models.hf_convert import (
        config_from_hf,
        params_from_hf_state_dict,
    )
    from cxl_speckv_tpu_torch.ops.wquant import QuantizedTensor

    hf = types.SimpleNamespace(
        model_type=family, vocab_size=512, hidden_size=128,
        intermediate_size=256, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=4 if family == "phi3" else 2, head_dim=32,
        rope_theta=1e6, rope_scaling=None, rms_norm_eps=1e-6,
        tie_word_embeddings=False, max_position_embeddings=256,
        eos_token_id=2, sliding_window=None)
    if family == "qwen3_moe":
        hf.__dict__.update(num_experts=8, num_experts_per_tok=2,
                           moe_intermediate_size=64, norm_topk_prob=True)
    cfg = config_from_hf(hf)
    gen = torch.Generator().manual_seed(5)
    H, V, D = cfg.hidden_size, cfg.vocab_size, cfg.head_dim
    qd, kvd = cfg.num_q_heads * D, cfg.num_kv_heads * D
    shapes = {"model.embed_tokens.weight": (V, H), "model.norm.weight": (H,),
              "lm_head.weight": (V, H)}
    for i in range(cfg.num_layers):
        lay = f"model.layers.{i}."
        shapes.update({lay + "input_layernorm.weight": (H,),
                       lay + "post_attention_layernorm.weight": (H,),
                       lay + "self_attn.o_proj.weight": (H, qd)})
        if family == "phi3":
            shapes.update({
                lay + "self_attn.qkv_proj.weight": (qd + 2 * kvd, H),
                lay + "mlp.gate_up_proj.weight": (2 * cfg.intermediate_size,
                                                  H),
                lay + "mlp.down_proj.weight": (H, cfg.intermediate_size)})
            continue
        shapes.update({lay + f"self_attn.{n}_proj.weight": (w, H) for n, w in
                       (("q", qd), ("k", kvd), ("v", kvd))})
        shapes.update({lay + "self_attn.q_norm.weight": (D,),
                       lay + "self_attn.k_norm.weight": (D,),
                       lay + "mlp.gate.weight": (cfg.num_experts, H)})
        I = cfg.intermediate_size
        for e in range(cfg.num_experts):
            ex = lay + f"mlp.experts.{e}."
            shapes.update({ex + "gate_proj.weight": (I, H),
                           ex + "up_proj.weight": (I, H),
                           ex + "down_proj.weight": (H, I)})
    sd = {k: torch.randn(s, generator=gen).to(torch.bfloat16)
          for k, s in shapes.items()}
    cpu = params_from_hf_state_dict(sd, cfg, weight_dtype="int8",
                                    device="cpu")
    card = params_from_hf_state_dict({k: v.to(dev) for k, v in sd.items()},
                                     cfg, weight_dtype="int8")
    flat = lambda p: {**{k: v for k, v in p.items() if k != "layers"},
                      **p["layers"]}
    assert set(flat(card)) == set(flat(cpu))
    for name, c in flat(cpu).items():
        g = flat(card)[name]
        pairs = ([(g.q, c.q), (g.s, c.s)] if isinstance(c, QuantizedTensor)
                 else [(g, c)])
        for a, b in pairs:
            assert a.is_cuda and torch.equal(a.cpu(), b), name


# ---------------------------------------------------------------------------
# Qwen2 (Qwen2-7B, Qwen2-57B-A14B): 28 query heads on 4 KV heads, G 7 -- an
# odd group, and odd row counts T * G in K2's 16-row tensor-core tiles --
# in 32-token blocks; and the HTTP server on the card
# ---------------------------------------------------------------------------

QWEN2_HEADS = (28, 4, 128)


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv", [KVDtype.INT8, KVDtype.INT4])
def test_decode_kernel_qwen2_heads_matches_plain(dev, kv, cd):
    """K1 at G 7 over a decode step of 8 lanes (a 0 lane, partial and whole
    blocks, one long enough to split), against the plain version unsplit
    and in the split form of the count the kernel ran."""
    lens = [0, 1, 31, 32, 65, 96, 127, 2100]
    got, want, split_want, _ = decode_case(dev, kv, cd, lens, seed=80,
                                           heads=QWEN2_HEADS, bs=32)
    close(got, want, cd)
    close(got, split_want, cd)
    assert not got[0].any()


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 5, 37, 64])
def test_chunk_kernel_qwen2_heads_matches_plain(dev, T, cd):
    """K2 at G 7: T * G = 7, 35, 259 and 448 rows, at the first chunk and
    at unaligned starts behind a context, INT8 and INT4."""
    for kv in (KVDtype.INT8, KVDtype.INT4):
        got, want, _ = chunk_case(dev, kv, cd, T, [0, 64, 77, 130], seed=81,
                                  heads=QWEN2_HEADS, bs=32)
        close(got, want, cd)


def test_server_completion_on_card_equals_engine_run(dev):
    """One greedy completion over HTTP from a server whose engine runs on
    the card (the loop thread launches K1 and K2) equals `Engine.run` of a
    second engine on the same weights."""
    import json
    import urllib.request

    from cxl_speckv_tpu_torch.config import (
        CacheConfig,
        EngineConfig,
        PrefetchConfig,
        SystemConfig,
    )
    from cxl_speckv_tpu_torch.engine import Engine
    from cxl_speckv_tpu_torch.models.configs import tiny_test_config
    from cxl_speckv_tpu_torch.server import SpeckvServer

    def engine(params=None):
        sc = SystemConfig(
            cache=CacheConfig(block_size=8, num_hbm_blocks=64,
                              num_host_blocks=64, kv_dtype=KVDtype.INT8),
            prefetch=PrefetchConfig(enabled=False),
            engine=EngineConfig(max_batch_size=4, max_seq_len=128,
                                prefill_chunk=32, decode_horizon=2))
        return Engine(tiny_test_config(), sc, params=params, device=None,
                      seed=9, enable_lstm=False)

    served = engine()
    prompt = np.random.RandomState(9).randint(1, 256, 21).tolist()
    ref = engine(served.params)
    rid = ref.add_request(prompt, max_new_tokens=12)
    want = {o.req_id: o.tokens for o in ref.run()}[rid]
    k1, k2 = launched(paged_attention), launched(paged_chunk_attention_cuda)
    with SpeckvServer(served, port=0) as srv:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/v1/completions",
            data=json.dumps({"prompt": prompt, "max_tokens": 12}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
        assert srv.loop.alive
    assert body["tokens"] == want
    assert launched(paged_attention) > k1
    assert launched(paged_chunk_attention_cuda) > k2


# ---------------------------------------------------------------------------
# W4A16: the unpack kernel, and engines on the card with int4 weights, the
# numpy host-store backend and the native directory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("shape", [(64, 32), (3, 16, 40), (5, 7),
                                   (2, 4, 96, 24)])
def test_w4_unpack_kernel_equals_plain(dev, shape, dtype):
    """Bit-equal to `unpack_int4(q).to(dtype)` for every byte value, on the
    16-byte path (half width a multiple of 16), the byte path (7, 20) and
    an unaligned view (the byte path too)."""
    from cxl_speckv_tpu_torch.ops.w4_unpack import w4_unpack, w4_unpack_plain

    rng = np.random.RandomState(sum(shape))
    q = torch.from_numpy(rng.randint(-128, 128, shape).astype(np.int8)).to(dev)
    before = sum(w4_unpack.launches.values())
    got = w4_unpack(q, dtype)
    torch.cuda.synchronize()
    assert sum(w4_unpack.launches.values()) == before + 1
    want = w4_unpack_plain(q.cpu(), dtype)
    assert got.shape == (*shape[:-1], 2 * shape[-1]) and got.dtype == dtype
    assert torch.equal(got.cpu(), want)
    # a view one byte past an aligned start takes the byte path
    big = torch.from_numpy(rng.randint(-128, 128, 65).astype(np.int8)).to(dev)
    flat = big[1:].reshape(4, 16)
    assert torch.equal(w4_unpack(flat, dtype).cpu(),
                       w4_unpack_plain(flat.cpu(), dtype))


# the fused int4 matmul's tolerance against its plain version (the same
# float32 products summed in another order, so the sum rounded to the
# result's type may differ by a step, and the scaled result by two): bf16 /
# f16 two steps of that type at |want|, plus 1e-3 of the largest |want| for
# outputs that cancel; float32 1e-5 of the largest |want|
W4MM_MANTISSA = {torch.bfloat16: 7, torch.float16: 10}


def w4mm_close(got, want) -> float:
    """Max |got - want| over the bound (<= 1 passes)."""
    g, w = got.float(), want.float()
    top = float(w.abs().max())
    if got.dtype == torch.float32:
        bound = torch.full_like(w, 1e-5 * top)
    else:
        # a step at |w| in [2^(e-1), 2^e) is 2^(e-1-mantissa bits)
        e = torch.frexp(w)[1] - 1 - W4MM_MANTISSA[got.dtype]
        bound = 2 * torch.ldexp(torch.ones_like(w), e) + 1e-3 * top
    return float(((g - w).abs() / bound.clamp_min(1e-30)).max())


@pytest.mark.parametrize("split", ["planned", "forced"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("shape", [
    (1, 8, 4096, 2048),     # decode rows, 16-byte copies, planned splits
    (1, 1, 512, 128),
    (1, 16, 256, 256),
    (1, 40, 256, 320),      # 48-row block; a ragged strip (160 of 192)
    (1, 512, 128, 256),     # 64-row blocks
    (1, 13, 96, 70),        # packed width 35: byte / element loads
    (1, 5, 37, 40),         # ragged K
    (3, 8, 64, 40),         # a batch (expert stack)
    (4, 17, 128, 128),
])
def test_w4a16_mm_kernel_equals_plain(dev, monkeypatch, shape, dtype, split):
    """The fused kernel against `w4a16_mm_plain` (cuBLAS at full float32
    reduction), two calls bit-equal, one launch a call; `forced` splits K
    into as many parts as it has 64-row stages."""
    from cxl_speckv_tpu_torch.ops import w4a16_mm as wm

    if split == "forced":
        monkeypatch.setattr(wm, "SPLIT_CTAS_PER_SM", 10 ** 6)
        monkeypatch.setattr(wm, "MIN_SPLIT_STAGES", 1)
    monkeypatch.setattr(torch.backends.cuda.matmul,
                        "allow_bf16_reduced_precision_reduction", False)
    monkeypatch.setattr(torch.backends.cuda.matmul,
                        "allow_fp16_reduced_precision_reduction", False)
    B, M, K, N = shape
    rng = np.random.RandomState(M + K + N)
    lead = (B,) if B > 1 else ()
    q = torch.from_numpy(rng.randint(-128, 128, (*lead, K, N // 2))
                         .astype(np.int8)).to(dev)
    s = torch.from_numpy(rng.rand(*lead, 1, N).astype(np.float32) * 0.05
                         + 0.001).to(dev)
    x = torch.from_numpy(rng.randn(*lead, M, K).astype(np.float32)).to(
        dev, dtype)
    before = sum(wm.w4a16_mm.launches.values())
    got = wm.w4a16_mm(x, q, s)
    again = wm.w4a16_mm(x, q, s)
    torch.cuda.synchronize()
    assert sum(wm.w4a16_mm.launches.values()) == before + 2
    assert got.shape == (*lead, M, N) and got.dtype == dtype
    assert torch.equal(got, again)
    assert w4mm_close(got, wm.w4a16_mm_plain(x, q, s)) <= 1.0
    # an x one element past an aligned start takes the element loads
    xs = torch.cat([x.reshape(-1), x.reshape(-1)[:1]])[1:].view(x.shape)
    assert w4mm_close(wm.w4a16_mm(xs, q, s),
                      wm.w4a16_mm_plain(xs, q, s)) <= 1.0


def test_w4a16_mm_refuses_on_card(dev):
    """On a CUDA tensor the wrapper launches or raises; it never runs the
    plain version."""
    from cxl_speckv_tpu_torch.ops import w4a16_mm as wm

    q = torch.zeros(64, 32, dtype=torch.int8, device=dev)
    s = torch.ones(1, 64, device=dev)
    x = torch.zeros(4, 64, device=dev)
    before = dict(wm.w4a16_mm.launches)
    for args in ((x.to(torch.int32), q, s), (x, q.t(), s),
                 (x, q, s.double()), (x, q.to(torch.uint8), s)):
        with pytest.raises(ValueError):
            wm.w4a16_mm(*args)
    assert dict(wm.w4a16_mm.launches) == before


# the fused int8 matmul's shapes: (form, B, M, K, N). "dense" q [K, N];
# "tied" q the transposed view of a [N, K] table (the tied head); "batch" a
# stack [B, K, N]; "expand" a stack against one x expanded over B (the
# dense MoE mode's stride-0 x)
W8MM_CASES = [
    ("dense", 1, 8, 4096, 2048),     # decode rows, 16-byte copies, splits
    ("dense", 1, 1, 512, 128),
    ("dense", 1, 16, 256, 256),
    ("dense", 1, 40, 256, 320),      # 48-row block; a ragged strip
    ("dense", 1, 512, 128, 256),     # 128-row blocks
    ("dense", 1, 100, 64, 130),      # a ragged 128-row block, N % 16 != 0
    ("dense", 1, 13, 96, 70),        # width 70: byte / element loads
    ("dense", 1, 5, 37, 40),         # ragged K
    ("tied", 1, 8, 256, 1000),       # a ragged last strip
    ("tied", 1, 40, 96, 300),
    ("tied", 1, 512, 128, 256),
    ("tied", 1, 3, 40, 130),         # K % 16 != 0: byte loads
    ("batch", 3, 8, 64, 40),
    ("batch", 4, 17, 128, 128),
    ("expand", 5, 8, 64, 96),
]


def w8mm_inputs(dev, form, B, M, K, N, dtype, seed=0):
    rng = np.random.RandomState(seed + M + K + N)
    lead = (B,) if form in ("batch", "expand") else ()
    qs = (N, K) if form == "tied" else (*lead, K, N)
    q = torch.from_numpy(rng.randint(-128, 128, qs).astype(np.int8)).to(dev)
    if form == "tied":
        q = q.t()
    s = torch.from_numpy(rng.rand(*lead, 1, N).astype(np.float32) * 0.05
                         + 0.001).to(dev)
    xs = (M, K) if form == "expand" else (*lead, M, K)
    x = torch.from_numpy(rng.randn(*xs).astype(np.float32)).to(dev, dtype)
    if form == "expand":
        x = x[None].expand(B, M, K)
    return x, q, s


@pytest.mark.parametrize("split", ["planned", "forced"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("case", W8MM_CASES,
                         ids=["-".join(map(str, c)) for c in W8MM_CASES])
def test_w8a16_mm_kernel_equals_plain(dev, monkeypatch, case, dtype, split):
    """The fused int8 kernel against `w8a16_mm_plain` (cuBLAS at full
    float32 reduction) within the int4 kernel's bounds (`w4mm_close`), two
    calls bit-equal, one launch a call (the tied form counted as such);
    `forced` splits K into as many parts as it has 64-deep stages."""
    from cxl_speckv_tpu_torch.ops import w4a16_mm as w4
    from cxl_speckv_tpu_torch.ops import w8a16_mm as w8

    if split == "forced":
        monkeypatch.setattr(w4, "SPLIT_CTAS_PER_SM", 10 ** 6)
        monkeypatch.setattr(w4, "MIN_SPLIT_STAGES", 1)
    monkeypatch.setattr(torch.backends.cuda.matmul,
                        "allow_bf16_reduced_precision_reduction", False)
    monkeypatch.setattr(torch.backends.cuda.matmul,
                        "allow_fp16_reduced_precision_reduction", False)
    form, B, M, K, N = case
    x, q, s = w8mm_inputs(dev, form, B, M, K, N, dtype)
    before = sum(w8.w8a16_mm.launches.values())
    tied = w8.w8a16_mm.tied_launches
    got = w8.w8a16_mm(x, q, s)
    again = w8.w8a16_mm(x, q, s)
    torch.cuda.synchronize()
    assert sum(w8.w8a16_mm.launches.values()) == before + 2
    assert w8.w8a16_mm.tied_launches == tied + 2 * (form == "tied")
    assert got.shape == (*x.shape[:-1], N) and got.dtype == dtype
    assert torch.equal(got, again)
    assert w4mm_close(got, w8.w8a16_mm_plain(x, q, s)) <= 1.0
    if form != "expand":
        # an x one element past an aligned start takes the element loads
        xs = torch.cat([x.reshape(-1), x.reshape(-1)[:1]])[1:].view(x.shape)
        assert w4mm_close(w8.w8a16_mm(xs, q, s),
                          w8.w8a16_mm_plain(xs, q, s)) <= 1.0


@pytest.mark.parametrize("M", [8, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("tied", [False, True])
def test_w8a16_mm_converts_every_byte_exactly(dev, tied, dtype, M):
    """Every int8 value (-128 .. 127, each in every column) through the
    kernel's conversion: one-hot rows of x and unit scales give back the
    weight's rows, bit-equal to `q.to(dtype)` (the products are exact and
    one is summed with zeros)."""
    from cxl_speckv_tpu_torch.ops.w8a16_mm import w8a16_mm

    K = N = 256
    k = torch.arange(K, device=dev)
    table = ((k[:, None] + k[None, :]) % 256 - 128).to(torch.int8)  # [K, N]
    q = table.t().contiguous().t() if tied else table
    assert q.is_contiguous() != tied
    rows = torch.arange(M, device=dev) * (K // M)
    x = torch.nn.functional.one_hot(rows, K).to(dtype)
    got = w8a16_mm(x, q, torch.ones(1, N, device=dev))
    torch.cuda.synchronize()
    assert torch.equal(got, table[rows].to(dtype))
    assert torch.equal(got.to(torch.bfloat16),
                       table[rows].to(torch.bfloat16))


def test_w8a16_mm_refuses_on_card(dev):
    """On a CUDA tensor the wrapper launches or raises; it never runs the
    plain version."""
    from cxl_speckv_tpu_torch.ops.w8a16_mm import w8a16_mm

    q = torch.zeros(64, 32, dtype=torch.int8, device=dev)
    s = torch.ones(1, 32, device=dev)
    x = torch.zeros(4, 64, device=dev)
    before = dict(w8a16_mm.launches)
    for args in ((x.to(torch.int32), q, s), (x, q[:, ::2], s[:, ::2]),
                 (x, q, s.double()), (x, q.to(torch.uint8), s),
                 (x[:, :32], q, s), (x, q, torch.ones(1, 64, device=dev))):
        with pytest.raises(ValueError):
            w8a16_mm(*args)
    assert dict(w8a16_mm.launches) == before


def _tiny_engine(dev_kw, hbm, **cache_kw):
    from cxl_speckv_tpu_torch.config import (
        CacheConfig,
        EngineConfig,
        PrefetchConfig,
        SystemConfig,
    )
    from cxl_speckv_tpu_torch.engine import Engine
    from cxl_speckv_tpu_torch.models.configs import tiny_test_config

    wq = cache_kw.pop("weight_dtype", "int8")
    native = cache_kw.pop("native", False)
    model = cache_kw.pop("model", None) or tiny_test_config()
    sc = SystemConfig(
        cache=CacheConfig(block_size=8, num_hbm_blocks=hbm,
                          num_host_blocks=256, kv_dtype=KVDtype.INT8,
                          **cache_kw),
        prefetch=PrefetchConfig(enabled=True, depth=2),
        engine=EngineConfig(max_batch_size=2, max_seq_len=128,
                            prefill_chunk=32, decode_horizon=4,
                            weight_dtype=wq))
    import os

    if native:                      # the engine's cache reads SPECKV_NATIVE
        os.environ["SPECKV_NATIVE"] = "1"
    try:
        return Engine(model, sc, seed=3, enable_lstm=False, **dev_kw)
    finally:
        os.environ.pop("SPECKV_NATIVE", None)


def _prompts():
    rng = np.random.RandomState(5)
    return [rng.randint(1, 256, rng.randint(6, 24)).tolist() for _ in range(8)]


def test_w4a16_engine_on_card(dev):
    """The tiny model at int4 weights on the card: every quantized matmul
    launches the fused int4 matmul once (none the unpack kernel), and
    tiered == ample tokens."""
    from cxl_speckv_tpu_torch.ops import wquant
    from cxl_speckv_tpu_torch.ops.w4_unpack import w4_unpack
    from cxl_speckv_tpu_torch.ops.w4a16_mm import w4a16_mm

    ample = _tiny_engine({}, 256, weight_dtype="int4")
    assert ample.params["layers"]["up"].bits == 4
    calls, launches = wquant.quantized_calls[4], sum(w4a16_mm.launches.values())
    unpacks = sum(w4_unpack.launches.values())
    want = ample.generate(_prompts(), max_new_tokens=12)
    assert (sum(w4a16_mm.launches.values()) - launches
            == wquant.quantized_calls[4] - calls > 0)
    assert sum(w4_unpack.launches.values()) == unpacks
    tiered = _tiny_engine({}, 14, weight_dtype="int4")
    tiered.params = ample.params
    assert tiered.generate(_prompts(), max_new_tokens=12) == want


@pytest.mark.parametrize("tied", [False, True])
def test_w8a16_engine_on_card(dev, tied):
    """The tiny model at int8 weights on the card (float32 activations: the
    FMA kernel), its head untied or tied to the embedding: every quantized
    matmul launches the fused int8 matmul once, the tied head in the tied
    layout, none calls `operand`, and tiered == ample tokens."""
    import dataclasses

    from cxl_speckv_tpu_torch.ops import wquant
    from cxl_speckv_tpu_torch.ops.w8a16_mm import w8a16_mm

    ample = _tiny_engine({}, 256)
    if tied:
        cfg = dataclasses.replace(ample.model_config, tie_embeddings=True)
        ample = _tiny_engine({}, 256, model=cfg)
    assert ample.params["layers"]["up"].bits == 8
    calls, launches = wquant.quantized_calls[8], sum(w8a16_mm.launches.values())
    tied_launches, copies = w8a16_mm.tied_launches, wquant.operand.calls
    want = ample.generate(_prompts(), max_new_tokens=12)
    assert (sum(w8a16_mm.launches.values()) - launches
            == wquant.quantized_calls[8] - calls > 0)
    assert (w8a16_mm.tied_launches > tied_launches) == tied
    assert wquant.operand.calls == copies
    tiered = _tiny_engine({}, 14, **({"model": ample.model_config}
                                     if tied else {}))
    tiered.params = ample.params
    assert tiered.generate(_prompts(), max_new_tokens=12) == want


@pytest.mark.parametrize("arm", ["numpy", "native"])
def test_host_numpy_and_native_engines_on_card(dev, arm):
    """The numpy host-store backend (staged H2D on the stager's stream,
    demotes bounced through pinned buffers) and the native directory on the
    card: the device backend's tokens, migrations both ways."""
    ref = _tiny_engine({}, 14)
    want = ref.generate(_prompts(), max_new_tokens=12)
    kw = ({"host_store_backend": "numpy"} if arm == "numpy"
          else {"native": True})
    eng = _tiny_engine({}, 14, **kw)
    eng.params = ref.params
    assert eng.generate(_prompts(), max_new_tokens=12) == want
    st = eng.get_statistics()
    assert st["transfer"]["up_transfers"] > 0
    assert st["transfer"]["down_transfers"] > 0
    if arm == "native":
        assert st["directory"] == ref.get_statistics()["directory"]


# the ported scripts whose checks need the card (kernel_probe,
# kernel_bench, tpu_window_check, hostop_probe), at small sizes


@pytest.mark.parametrize("scheme", ["int8", "int4", "bf16"])
def test_kernel_probe_points_on_card(dev, scheme):
    """K1 at kernel_probe's points (split counts 1, the rule's S, 2S): the
    first output equals the plain version's split form at the same count
    within 2e-4, and the dependent loop's last bf16 q equals the same loop
    of plain calls within 2e-2 (each step's output rounds to bf16)."""
    from cxl_speckv_tpu_torch.scripts import kernel_probe as kp

    p = kp.probe_pools(scheme, 16, 512, 2, 0, 1, "cuda", heads=(HQ, HKV, D))
    for n in kp.split_counts("1,S,2S", max(kp.rule_splits(p, "cuda"), 2)):
        r = kp.time_point(p, n, 3, "cuda", True, torch.float32)
        assert r["ok"], (n, r["err"])
        q = p.q.to(torch.bfloat16)
        for _ in range(5):          # back_to_back_us: 2 warm-up calls + 3
            q = paged_attention_ref(q, p.k, p.v, p.ks, p.vs, p.table,
                                    p.lens, p.kv, num_splits=n)
        torch.testing.assert_close(r["out"].float(), q.float(), rtol=2e-2,
                                   atol=2e-2)


def test_kernel_bench_on_card(dev):
    """kernel_bench's command line at ctx 2048: every point's first output
    within 2e-4 of the plain version, rates positive."""
    from cxl_speckv_tpu_torch.scripts import kernel_bench

    rows = kernel_bench.main(["--ctx", "2048", "--check"])
    assert len(rows) == 3
    for key, r in rows.items():
        assert r["ok"], (key, r["err"])
        assert r["gbps"] > 0 and r["us"] > 0


def test_window_check_on_card(dev):
    """tpu_window_check's 18 cases: K1 / K2 at bf16 compute within the
    script's 2e-2 of their plain versions."""
    from cxl_speckv_tpu_torch.scripts import tpu_window_check as twc

    errs = twc.main([])
    assert set(errs) == set(twc.CASES)
    assert max(errs.values()) < twc.TOL


def test_hostop_probe_on_card(dev):
    """hostop_probe's programs on the pinned store: each gathers the bytes
    index_select gives (checked inside), copies counted."""
    from cxl_speckv_tpu_torch.scripts import hostop_probe

    res = hostop_probe.main(["--reps", "1"])
    assert [res[k]["copies"] for k in "ABCD"] == [8192, 2048, 512, 8192]
    assert all(res[k]["host_s"] > 0 for k in "ABCD")


# -- K1 / K2 on a tp shard, in a world of two ranks on one card ----------------

SHARD_LENS, SHARD_T, SHARD_STARTS = [37, 1, 64, 130], 5, [0, 17, 64, 99]


def shard_rank(rank: int, world: int, port: int, out: str) -> None:
    """One rank of a tp world on cuda:0 (gloo): K1 and K2 through the
    mesh wrappers (`parallel/shard_kernels.py`) on this rank's heads and
    pool shard, against their plain versions on the same shard and against
    this rank's head slice of the kernels' whole outputs; the shards'
    outputs gathered over tp against the whole outputs. Results as JSON at
    `{out}.rank{rank}.json`."""
    import json
    from types import SimpleNamespace

    from cxl_speckv_tpu_torch.parallel import distributed
    from cxl_speckv_tpu_torch.parallel.mesh import Mesh
    from cxl_speckv_tpu_torch.parallel.shard_kernels import (
        sharded_chunk_attention,
        sharded_paged_attention,
    )

    dev = distributed.initialize(rank, world, port, device="cuda")
    mesh = Mesh(tp=world)
    cfg = SimpleNamespace(num_q_heads=HQ, num_kv_heads=HKV)
    hq, hkv = HQ // world, HKV // world
    qh = slice(rank * hq, (rank + 1) * hq)
    kh = slice(rank * hkv, (rank + 1) * hkv)
    res = {}
    for kv in (KVDtype.INT8, KVDtype.INT4):
        for cd in (torch.float32, torch.bfloat16):
            key = f"{kv.value} {str(cd)[6:]}"
            g = torch.Generator().manual_seed(7)
            # K1: the decode step of 4 lanes
            p, table = pools(SHARD_LENS, kv, dev, seed=3)
            ps = tuple(t[:, kh].contiguous() for t in p)
            q = torch.randn((len(SHARD_LENS), HQ, D), generator=g).to(dev, cd)
            lens = torch.tensor(SHARD_LENS, dtype=torch.int32, device=dev)
            before = sum(paged_attention.launches.values())
            got = sharded_paged_attention(mesh, cfg, compute_dtype=cd)(
                q[:, qh].contiguous(), *ps, table, lens, kv)
            launched = sum(paged_attention.launches.values()) - before
            plain = paged_attention_ref(q[:, qh].contiguous(), *ps, table,
                                        lens, kv, compute_dtype=cd)
            whole = paged_attention(q, *p, table, lens, kv, compute_dtype=cd)
            both = mesh.all_gather(got, "tp", 1)
            torch.cuda.synchronize()
            res[f"K1 {key}"] = {
                "launched": launched,
                "plain": _close(got, plain, TOL[cd]),
                "slice": _close(got, whole[:, qh], TOL[cd]),
                "gathered": _close(both, whole, TOL[cd])}
            # K2: a 5-token chunk of each lane over its context
            p, table = pools([s + SHARD_T for s in SHARD_STARTS], kv, dev,
                             seed=4)
            ps = tuple(t[:, kh].contiguous() for t in p)
            B = len(SHARD_STARTS)
            q = torch.randn((B, SHARD_T, HQ, D), generator=g).to(dev, cd)
            kn = torch.randn((B, SHARD_T, HKV, D), generator=g).to(dev)
            vn = torch.randn((B, SHARD_T, HKV, D), generator=g).to(dev)
            st = torch.tensor(SHARD_STARTS, dtype=torch.int32, device=dev)
            before = sum(paged_chunk_attention_cuda.launches.values())
            args_s = (q[:, :, qh].contiguous(), kn[:, :, kh].contiguous(),
                      vn[:, :, kh].contiguous(), *ps, table, st, kv)
            got = sharded_chunk_attention(mesh, cfg, compute_dtype=cd)(
                *args_s)
            launched = (sum(paged_chunk_attention_cuda.launches.values())
                        - before)
            plain = paged_chunk_attention(*args_s, compute_dtype=cd)
            whole = paged_chunk_attention_cuda(q, kn, vn, *p, table, st, kv,
                                               compute_dtype=cd)
            both = mesh.all_gather(got, "tp", 2)
            torch.cuda.synchronize()
            res[f"K2 {key}"] = {
                "launched": launched,
                "plain": _close(got, plain, TOL[cd]),
                "slice": _close(got, whole[:, :, qh], TOL[cd]),
                "gathered": _close(both, whole, TOL[cd])}
    res["routes"] = sorted(mesh.stats())
    distributed.shutdown()
    with open(f"{out}.rank{rank}.json", "w") as f:
        json.dump(res, f)


def _close(got, want, tol) -> list:
    """[max |got - want|, within rtol = atol = tol everywhere]."""
    d = (got.float() - want.float()).abs()
    return [float(d.max()), bool((d <= tol + tol * want.float().abs()).all())]


def test_tp_shard_kernels_in_a_world_of_two(dev, tmp_path):
    """Two ranks on this card (gloo): each rank's K1 / K2 launch on its
    shard (launch counted) and agree with their plain versions on the same
    shard and with the head slice of the unsharded kernels' outputs; the
    gathered shards give the whole output."""
    import json
    import os

    from cxl_speckv_tpu_torch.parallel import distributed

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.dirname(here))
    rcs = distributed.launch("test_torch_kernels_cuda", 2,
                             ["--out", str(tmp_path / "shard")],
                             timeout_s=240, env=env, cwd=here,
                             log_dir=str(tmp_path))
    logs = [open(tmp_path / f"rank{r}.log").read()[-3000:] for r in range(2)]
    assert rcs == [0, 0], logs
    for r in range(2):
        with open(tmp_path / f"shard.rank{r}.json") as f:
            res = json.load(f)
        assert res.pop("routes") == ["all_gather/gloo-cuda"]
        for case, v in res.items():
            assert v["launched"] == 1, (r, case)
            for check in ("plain", "slice", "gathered"):
                assert v[check][1], (r, case, check, v[check])


def test_multiproc_serve_tpspan_on_card(dev):
    """The lockstep script's tpspan mode with its ranks on this card:
    identical outputs on both ranks, equal to one process."""
    from cxl_speckv_tpu_torch.scripts import multiproc_serve

    rec = multiproc_serve.main(["--mode", "tpspan", "--threads", "2"])
    assert rec["ok"], rec


if __name__ == "__main__":
    import argparse

    from cxl_speckv_tpu_torch.parallel.distributed import add_rank_args

    ap = argparse.ArgumentParser()
    add_rank_args(ap)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    shard_rank(a.rank, a.world, a.port, a.out)
