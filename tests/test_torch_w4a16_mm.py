"""The W4A16 fused matmul's wrapper (`ops/w4a16_mm.py`) and its wiring into
`ops/wquant.py`, against the JAX package's `ops/wquant.py` at bits 4, on the
CPU at tiny sizes (the kernel itself runs only on the card:
tests/test_torch_kernels_cuda.py):

- `mm` / `qeinsum` at bits 4 within the reference's 2e-4 (float32; the
  matmuls sum in other orders) at M in {1, 3, 8, 40}, for ragged widths, and
  for the batched expert specs;
- the plain version bit-equal to the composition it replaces (`w4_unpack`,
  then the matmul or einsum, then the scale);
- `mm` / `qeinsum` route every int4 call through `w4a16_mm` and count it in
  `quantized_calls[4]`; another einsum spec raises;
- the wrapper's refusals, its plan (row block, split-K count), and no
  launch counted on the CPU;
- the sweep script's variant sources, and its refusal without CUDA.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxl_speckv_tpu.ops import wquant as jw
from cxl_speckv_tpu_torch.ops import w4a16_mm as wm
from cxl_speckv_tpu_torch.ops import wquant as tw
from cxl_speckv_tpu_torch.ops.cuda_build import CSRC
from cxl_speckv_tpu_torch.ops.w4_unpack import w4_unpack
from cxl_speckv_tpu_torch.scripts import w4a16_sweep

TOL = 2e-4                 # tests/test_torch_w4a16.py: float32, sum order
SPECS = ("ech,ehi->eci", "eci,eih->ech")


def quantized(shape, seed):
    w = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return (jw.quantize_tensor(jnp.asarray(w), bits=4),
            tw.quantize_tensor(torch.from_numpy(w), bits=4))


@pytest.mark.parametrize("kn", [(24, 40), (37, 70), (64, 160)])
@pytest.mark.parametrize("M", [1, 3, 8, 40])
def test_mm_int4_matches_jax(M, kn):
    """Ragged K (37) and packed widths (20, 35, 80: not multiples of 16 or
    64), and x with leading dims that flatten into rows."""
    K, N = kn
    jq, tq = quantized((K, N), K + N)
    x = np.random.RandomState(M).randn(2, M, K).astype(np.float32)
    want = np.asarray(jw.mm(jnp.asarray(x), jq))
    got = tw.mm(torch.from_numpy(x), tq)
    assert got.shape == (2, M, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("C", [1, 8, 40])
def test_qeinsum_int4_matches_jax(spec, C):
    E, inn, out = 3, 24, 10
    jq, tq = quantized((E, inn, out), C)
    x = np.random.RandomState(C + 1).randn(E, C, inn).astype(np.float32)
    want = np.asarray(jw.qeinsum(spec, jnp.asarray(x), jq))
    got = tw.qeinsum(spec, torch.from_numpy(x), tq)
    assert got.shape == (E, C, out)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_bit_equal_to_the_composition(dtype):
    """The plain version is the composition the port ran before the fused
    kernel (`x @ w4_unpack(q) * s`, the expert einsum), to the bit."""
    _, tq = quantized((48, 70), 5)
    x = torch.from_numpy(np.random.RandomState(6).randn(9, 48)
                         .astype(np.float32)).to(dtype)
    old = (x @ w4_unpack(tq.q, dtype)) * tq.s.to(dtype)
    assert torch.equal(wm.w4a16_mm_plain(x, tq.q, tq.s), old)
    _, te = quantized((3, 48, 22), 7)
    xe = torch.from_numpy(np.random.RandomState(8).randn(3, 5, 48)
                          .astype(np.float32)).to(dtype)
    old = (torch.einsum("ech,ehi->eci", xe, w4_unpack(te.q, dtype))
           * te.s.squeeze(-2).to(dtype)[..., None, :])
    assert torch.equal(wm.w4a16_mm_plain(xe, te.q, te.s), old)


def test_mm_and_qeinsum_route_int4_through_the_wrapper(monkeypatch):
    seen = []

    def spy(x, q, s):
        seen.append((tuple(x.shape), tuple(q.shape)))
        return wm.w4a16_mm_plain(x, q, s)

    monkeypatch.setattr(tw, "w4a16_mm", spy)
    _, tq = quantized((24, 40), 1)
    _, te = quantized((3, 24, 10), 2)
    calls = tw.quantized_calls[4]
    tw.mm(torch.zeros(2, 5, 24), tq)
    tw.qeinsum(SPECS[0], torch.zeros(3, 4, 24), te)
    _, td = quantized((3, 10, 24), 3)
    tw.qeinsum(SPECS[1], torch.zeros(3, 4, 10), td)
    assert seen == [((10, 24), (24, 20)), ((3, 4, 24), (3, 24, 5)),
                    ((3, 4, 10), (3, 10, 12))]
    assert tw.quantized_calls[4] == calls + 3
    # int8 weights take the int8 kernel's wrapper, not this one
    i8 = tw.quantize_tensor(torch.ones(24, 40))
    tw.mm(torch.zeros(1, 24), i8)
    assert len(seen) == 3 and tw.quantized_calls[4] == calls + 3
    with pytest.raises(ValueError, match="int4"):
        tw.operand(tq, torch.float32)


def test_qeinsum_int4_other_spec_raises():
    _, te = quantized((3, 24, 10), 4)
    calls = tw.quantized_calls[4]
    with pytest.raises(ValueError, match="int4 weight takes only"):
        tw.qeinsum("ech,ehi->ehc", torch.zeros(3, 4, 24), te)
    assert tw.quantized_calls[4] == calls


def test_wrapper_refusals():
    """What the kernel does not take raises (checked before any launch)."""
    _, tq = quantized((32, 64), 9)
    x = torch.zeros(4, 32)
    assert wm.check_args(x, tq.q, tq.s) == (1, 4, 32, 32)
    bad = [
        (x.half().to(torch.int32), tq.q, tq.s, "activation dtype"),
        (x, tq.q.to(torch.uint8), tq.s, "int8"),
        (x, tq.q.t().contiguous().t(), tq.s, "contiguous int8"),
        (x, tq.q, tq.s.double(), "float32 scales"),
        (x, tq.q, torch.ones(1, 128)[:, ::2], "float32 scales"),
        (torch.zeros(4, 31), tq.q, tq.s, "do not match"),
        (torch.zeros(2, 4, 32), tq.q, tq.s, "needs"),
    ]
    # an int8 (W8A16) weight is no packed int4 one: its scale is twice as
    # wide as the packed rows read
    i8 = tw.quantize_tensor(torch.ones(32, 64))
    bad.append((x, i8.q, torch.ones(1, 64), "do not match"))
    for xa, qa, sa, msg in bad:
        with pytest.raises(ValueError, match=msg):
            wm.check_args(xa, qa, sa)
    with pytest.raises(ValueError, match="unsupported device"):
        wm.w4a16_mm(x.to("meta"), tq.q.to("meta"), tq.s.to("meta"))


def test_cpu_calls_count_no_launch():
    _, tq = quantized((16, 32), 10)
    before = dict(wm.w4a16_mm.launches)
    for dt in (torch.float32, torch.bfloat16):
        y = wm.w4a16_mm(torch.ones(3, 16, dtype=dt), tq.q, tq.s)
        assert y.dtype == dt and y.shape == (3, 32)
    assert dict(wm.w4a16_mm.launches) == before


@pytest.mark.parametrize("M,K,half,batch,dtype,want", [
    # Llama-3-8B up / k / q / down / lm_head at decode, 132 SMs: splits up
    # to two CTAs an SM, 4 stages of 64 rows a split at least
    (8, 4096, 7168, 1, torch.bfloat16, (0, 8, 4)),
    (8, 4096, 512, 1, torch.bfloat16, (0, 8, 16)),
    (8, 4096, 2048, 1, torch.bfloat16, (0, 8, 16)),
    (8, 14336, 2048, 1, torch.bfloat16, (0, 8, 16)),
    (8, 4096, 64128, 1, torch.bfloat16, (0, 8, 1)),
    (1, 4096, 7168, 1, torch.bfloat16, (0, 8, 4)),
    (16, 4096, 7168, 1, torch.float16, (1, 16, 4)),
    (32, 4096, 7168, 1, torch.bfloat16, (2, 32, 4)),
    (40, 4096, 7168, 1, torch.bfloat16, (3, 48, 4)),
    (512, 4096, 7168, 1, torch.bfloat16, (4, 64, 1)),
    (40, 4096, 7168, 1, torch.float32, (5, 16, 1)),
    # an expert stack: enough tiles, no split
    (8, 2048, 384, 128, torch.bfloat16, (0, 8, 1)),
    # few k stages cap the split; tiny shapes split nothing
    (8, 300, 16, 1, torch.bfloat16, (0, 8, 1)),
    (3, 64, 20, 2, torch.float32, (5, 16, 1)),
])
def test_plan(M, K, half, batch, dtype, want):
    cfg, mb, splits = wm.plan(M, K, half, batch, dtype, 132)
    assert (cfg, mb, splits) == want
    assert (mb, cfg) == wm.block(M, dtype)
    tiles = batch * -(-half // wm.BP) * -(-M // mb)
    assert splits == 1 or (tiles * splits <= wm.SPLIT_CTAS_PER_SM * 132
                           and -(-K // wm.BK) >= splits
                           * wm.MIN_SPLIT_STAGES)


def test_sweep_variant_source_and_no_card():
    src = (CSRC / "w4a16_mm.cu").read_text()
    assert w4a16_sweep.variant_source(src, 4, 64) == src
    v = w4a16_sweep.variant_source(src, 3, 128)
    assert "constexpr int NSTAGE = 3;" in v and "constexpr int BK = 128;" in v
    with pytest.raises(ValueError, match="moved"):
        w4a16_sweep.variant_source("int x;", 3, 128)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA is not available"):
            w4a16_sweep.main(["--shapes", "k", "--rows", "1"])
