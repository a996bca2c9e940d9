"""The CUDA kernels K1 (decode) and K2 (chunk) against their plain PyTorch
versions, on the card, for every storage scheme (INT8, BF16, INT4, FP8;
MIXED8 by scheme id), with and without the sliding window and softcap.
Every test here needs an NVIDIA card and `nvcc` and skips without them; on
the card run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

(`--noconftest`: the JAX test settings in tests/conftest.py import jax,
which the card's machine does not need). Tolerances: 2e-4 at float32
compute (the kernel sums in another order) and rtol = atol = 2e-2 at
bfloat16 compute (q and p * v_scale round to bfloat16; a different float32
sum can round to the neighbouring value). This file imports no JAX.
"""

import numpy as np
import pytest
import torch

from cxl_speckv_tpu_torch.config import KVDtype
from cxl_speckv_tpu_torch.ops.chunk_attention import paged_chunk_attention
from cxl_speckv_tpu_torch.ops.chunk_attention_cuda import (
    paged_chunk_attention_cuda,
)
from cxl_speckv_tpu_torch.ops.paged_attention import paged_attention
from cxl_speckv_tpu_torch.ops.paged_attention_ref import paged_attention_ref
from cxl_speckv_tpu_torch.ops.quant import encode_for_pool, quantize_kv

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
HQ, HKV, D, BS = 8, 2, 64, 16
SCHEMES = [KVDtype.INT8, KVDtype.BF16, KVDtype.INT4, KVDtype.FP8]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def pools(lens, kv, dev, seed):
    """Pools holding ceil(len / BS) blocks a lane at shuffled slots, the
    guard slot last. INT4 / FP8 hold quantized random K/V, as the engine
    writes them; in FP8 pools every row no lane holds (the guard slot, the
    tails of partly filled blocks) holds NaN bytes (0x7F), which must read
    as 0."""
    rng = np.random.RandomState(seed)
    nblk = [-(-n // BS) for n in lens]
    S = sum(nblk) + 1
    shape = (S, HKV, BS, D)
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
    live = torch.zeros((S, BS), dtype=torch.bool)
    for i, (n, nb) in enumerate(zip(lens, nblk)):
        table[i, :nb] = perm[at:at + nb]
        at += nb
        for j in range(nb):
            live[table[i, j], :min(BS, n - j * BS)] = True
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


def test_unported_variants_raise_on_cuda(dev):
    p, table = pools([20], KVDtype.INT8, dev, seed=3)
    q = torch.randn(1, HQ, D, device=dev)
    sl = torch.tensor([20], dtype=torch.int32, device=dev)
    sinks = torch.zeros(HQ, device=dev)
    with pytest.raises(NotImplementedError):
        paged_attention(q, *p, table, sl, KVDtype.INT8, sinks=sinks)
    kn = torch.randn(1, 4, HKV, D, device=dev)
    with pytest.raises(NotImplementedError):
        paged_chunk_attention_cuda(q[:, None].expand(1, 4, HQ, D), kn, kn, *p,
                                   table, sl, KVDtype.INT8, sinks=sinks)


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
