"""K1's split-context grid on the CPU: the plain version's split form
(`paged_attention_ref(..., num_splits=k)`: each lane's attended blocks
divided evenly among k walks, merged with the sink as the kernel's merge
pass does) against the JAX package's Pallas kernel in interpret mode, on
the same numpy inputs; and the rule that chooses the split count
(`ops/paged_attention.decode_splits`), which reads static shapes only.
Tolerances: 2e-4 at float32 compute (the JAX kernel's own) and 2e-2 at
bf16 compute, where p * v_scale rounds to bf16 against each split's own
running max, not the whole lane's. The kernel itself is held to the same
split form on the card (tests/test_torch_kernels_cuda.py)."""

import functools
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxl_speckv_tpu.config import KVDtype as JKV
from cxl_speckv_tpu.ops.paged_attention import paged_attention as j_decode
from cxl_speckv_tpu_torch.config import KVDtype
from cxl_speckv_tpu_torch.models.convert import pools_from_jax
from cxl_speckv_tpu_torch.ops.paged_attention import (
    MAX_SPLITS,
    MIN_SPLIT_BLOCKS,
    SPLIT_WAVES,
    decode_splits,
    paged_attention,
)
from cxl_speckv_tpu_torch.ops.paged_attention_ref import (
    paged_attention_ref,
    split_ranges,
)

from helpers import build_pools

BLOCK = 8
HQ, HKV, D = 4, 2, 32
TOL = {"float32": 2e-4, "bfloat16": 2e-2}
CD = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SCHEMES = ["int8", "bf16", "int4", "fp8"]
# lanes of length 0, 1 and bs beside long ones (up to 17 blocks)
LENS = (0, 1, BLOCK, 37, 100, 131)
# (window, softcap, sinks): none, or a window that starts mid-block with
# the cap and sinks
VARIANTS = {"none": (None, None, False), "window-cap-sinks": (21, 5.0, True)}
H100_SMS = 132


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@functools.cache
def case(kv: str, cd: str, var: str):
    """Same inputs for both packages, and the JAX kernel's output."""
    rng = np.random.RandomState(31)
    keys = [jnp.asarray(rng.randn(L, HKV, D).astype(np.float32)) for L in LENS]
    vals = [jnp.asarray(rng.randn(L, HKV, D).astype(np.float32)) for L in LENS]
    kp, vp, ks, vs, table, seq_lens, _, _ = build_pools(
        keys, vals, BLOCK, num_slots=64, kv_dtype=JKV(kv))
    q = (rng.randn(len(LENS), HQ, D) * 3).astype(np.float32)
    window, cap, with_sinks = VARIANTS[var]
    sinks = (rng.randn(HQ) * 2).astype(np.float32) if with_sinks else None
    want = j_decode(jnp.asarray(q), kp, vp, ks, vs, table, seq_lens, JKV(kv),
                    interpret=True, compute_dtype=CD[cd][0], window=window,
                    softcap=cap,
                    sinks=None if sinks is None else jnp.asarray(sinks))
    torch_args = (t(q), *pools_from_jax(kp, vp, ks, vs, HKV), t(table),
                  t(seq_lens), KVDtype(kv))
    kw = dict(compute_dtype=CD[cd][1], window=window, softcap=cap,
              sinks=None if sinks is None else t(sinks))
    return torch_args, kw, np.asarray(want)


@pytest.mark.parametrize("k", [1, 2, 3, 40])
@pytest.mark.parametrize("var", list(VARIANTS))
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv", SCHEMES)
def test_split_plain_matches_jax_kernel(kv, cd, var, k):
    """k = 40 exceeds every lane's block count: empty splits add nothing;
    a seq_len 0 lane gives zeros, with sinks too."""
    args, kw, want = case(kv, cd, var)
    got = paged_attention_ref(*args, num_splits=k, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL[cd], atol=TOL[cd])
    assert not got[0].any()
    # the wrapper on a CPU tensor runs this split form
    assert torch.equal(paged_attention(*args, num_splits=k, **kw), got)


@pytest.mark.parametrize("window", [None, 21])
def test_one_split_is_the_unsplit_walk(window):
    """num_splits 1 and None are the unsplit plain version, bit for bit."""
    args, kw, _ = case("int8", "bfloat16", "window-cap-sinks")
    kw = dict(kw, window=window)
    assert torch.equal(paged_attention_ref(*args, num_splits=1, **kw),
                       paged_attention_ref(*args, **kw))


@pytest.mark.parametrize("window", [None, 5, 21, 1000])
def test_split_ranges_partition_the_attended_blocks(window):
    """The splits tile each lane's [first, nblk) in order, evenly (sizes
    differ by at most one), never below `first`; lanes with fewer blocks
    than splits leave the rest empty."""
    rng = np.random.RandomState(3)
    lens = torch.tensor(rng.randint(0, 200, 40).tolist() + [0, 1, 8, 9])
    max_blocks = 25
    for S in (1, 2, 3, 7, 40):
        begin, end = split_ranges(lens, BLOCK, max_blocks, window, S)
        for n, b, e in zip(lens.tolist(), begin.tolist(), end.tolist()):
            first = max(n - window, 0) // BLOCK if window else 0
            nblk = min(-(-n // BLOCK), max_blocks)
            assert b[0] == first and e[-1] == max(nblk, first)
            assert all(e[i] == b[i + 1] for i in range(S - 1))
            sizes = [y - x for x, y in zip(b, e)]
            assert min(sizes) >= 0 and max(sizes) - min(sizes) <= 1


def test_wrapper_refuses_split_counts_out_of_range():
    args, kw, _ = case("int8", "float32", "none")
    for k in (0, MAX_SPLITS + 1):
        with pytest.raises(ValueError, match="num_splits"):
            paged_attention(*args, num_splits=k, **kw)


# (B, Hkv, table width, window, bs) -> S on an H100 (132 SMs), at the K1
# shapes chip_smoke.py times and serves: the served Llama-3-8B / INT4 /
# FP8 / Gemma-2 decode (8 lanes, 5 blocks a table row; chip_smoke's rows
# add 1), GPT-OSS-20B's (9 blocks, window 128 or none), the long Gemma-2
# pair (146 blocks, window 4096 or none) and Mistral's (133, window 4096),
# and the decode-anatomy probe's ctx 8192 at bs 32 and 128 and its check
# lanes (ctx 1024).
CHIP_SMOKE_SHAPES = {
    "llama / int4 / fp8 served": ((8, 8, 5, None, 32), 1),
    "llama timed row": ((8, 8, 6, None, 32), 1),
    "gemma2 sliding": ((8, 8, 5, 4096, 32), 1),
    "gemma2 global": ((8, 8, 5, None, 32), 1),
    "gpt-oss sliding": ((8, 8, 9, 128, 32), 1),
    "gpt-oss global": ((8, 8, 9, None, 32), 1),
    "gpt-oss timed row": ((8, 8, 10, None, 32), 1),
    "gemma2-long sliding": ((2, 8, 146, 4096, 32), 17),
    "gemma2-long global": ((2, 8, 146, None, 32), 17),
    "mistral": ((2, 8, 133, 4096, 32), 17),
    "probe ctx 8192 bs 32": ((8, 8, 256, None, 32), 5),
    "probe ctx 8192 bs 128": ((8, 8, 64, None, 128), 5),
    "probe check ctx 1024": ((8, 8, 32, None, 32), 5),
}


@pytest.mark.parametrize("name", list(CHIP_SMOKE_SHAPES))
def test_decode_splits_at_chip_smoke_shapes(name):
    shape, want = CHIP_SMOKE_SHAPES[name]
    assert decode_splits(*shape, H100_SMS) == want


def test_decode_splits_bounds():
    """S >= 1; S = 1 where B * Hkv already fills the card; otherwise no more
    than about SPLIT_WAVES waves of CTAs, and no fewer than
    MIN_SPLIT_BLOCKS of the most blocks a lane can attend a split."""
    rng = np.random.RandomState(5)
    for _ in range(2000):
        B, hkv = int(rng.randint(1, 65)), int(rng.choice([1, 2, 4, 8, 16]))
        bs = int(rng.choice([8, 16, 32, 128]))
        width = int(rng.randint(1, 600))
        window = int(rng.choice([0, 100, 4096])) or None
        sms = int(rng.choice([66, 114, 132]))
        S = decode_splits(B, hkv, width, window, bs, sms)
        assert 1 <= S <= MAX_SPLITS
        if B * hkv >= sms:
            assert S == 1
        if S > 1:
            attended = min(width, -(-window // bs) + 1) if window else width
            assert attended // S >= MIN_SPLIT_BLOCKS
            assert B * hkv * (S - 1) < SPLIT_WAVES * sms


def test_decode_splits_reads_static_shapes_only():
    """The rule takes no sequence lengths, and a lane's split output does not
    depend on what the other lanes hold: two engines of the same batch and
    table geometry (tiered and ample) get the same S and the same bits."""
    assert list(inspect.signature(decode_splits).parameters) == [
        "B", "Hkv", "max_blocks", "window", "bs", "sm_count"]
    (q, kp, vp, ks, vs, table, lens, kv), kw, _ = case(
        "int8", "bfloat16", "window-cap-sinks")
    kw = dict(kw, window=None)
    S = decode_splits(q.shape[0], HKV, table.shape[1], None, BLOCK, 64)
    assert S > 1
    a = paged_attention_ref(q, kp, vp, ks, vs, table, lens, kv, num_splits=S,
                            **kw)
    other = lens.clone()
    other[[1, 2, 3, 5]] = torch.tensor([3, 0, 17, 64], dtype=lens.dtype)
    b = paged_attention_ref(q, kp, vp, ks, vs, table, other, kv, num_splits=S,
                            **kw)
    assert torch.equal(a[[0, 4]], b[[0, 4]]) and not torch.equal(a, b)
