"""The W8A16 fused matmul's wrapper (`ops/w8a16_mm.py`) and its wiring into
`ops/wquant.py`, against the JAX package's `ops/wquant.py` at bits 8, on the
CPU at tiny sizes (the kernel itself runs only on the card:
tests/test_torch_kernels_cuda.py):

- `mm` / `qeinsum` at bits 8 within the 2e-4 of tests/test_torch_w4a16_mm.py
  (float32; the matmuls sum in other orders) at M in {1, 3, 8, 40}, for
  ragged widths, for both expert specs (also against one x expanded over
  the experts, the dense MoE mode's) and for the tied head through
  `QuantizedTensor.T`;
- the plain version bit-equal to the composition it replaces (the weight's
  copy in the activation dtype by `operand`, then the matmul or einsum,
  then the scale);
- `mm` / `qeinsum` route every int8 call through `w8a16_mm` and count it in
  `quantized_calls[8]`, the tied head as the embedding's own [V, H]
  storage; `operand` is not called; another einsum spec raises;
- the wrapper's refusals, its layouts, its plan (row block, split-K
  count), and no launch counted on the CPU;
- the sweep script's int8 arm: its weights, its variant source, its
  refusal without CUDA.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxl_speckv_tpu.ops import wquant as jw
from cxl_speckv_tpu_torch.ops import w8a16_mm as w8
from cxl_speckv_tpu_torch.ops import wquant as tw
from cxl_speckv_tpu_torch.ops.cuda_build import CSRC
from cxl_speckv_tpu_torch.scripts import w4a16_sweep

TOL = 2e-4                 # tests/test_torch_w4a16_mm.py: float32, sum order
SPECS = ("ech,ehi->eci", "eci,eih->ech")


def quantized(shape, seed, axis=-2):
    w = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return (jw.quantize_tensor(jnp.asarray(w), axis=axis),
            tw.quantize_tensor(torch.from_numpy(w), axis=axis))


@pytest.mark.parametrize("kn", [(24, 40), (37, 70), (64, 160)])
@pytest.mark.parametrize("M", [1, 3, 8, 40])
def test_mm_int8_matches_jax(M, kn):
    """Ragged K (37) and widths (70, 40: not multiples of 16 or 128), and x
    with leading dims that flatten into rows."""
    K, N = kn
    jq, tq = quantized((K, N), K + N)
    x = np.random.RandomState(M).randn(2, M, K).astype(np.float32)
    want = np.asarray(jw.mm(jnp.asarray(x), jq))
    got = tw.mm(torch.from_numpy(x), tq)
    assert got.shape == (2, M, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("C", [1, 8, 40])
def test_qeinsum_int8_matches_jax(spec, C):
    E, inn, out = 3, 24, 10
    jq, tq = quantized((E, inn, out), C)
    x = np.random.RandomState(C + 1).randn(E, C, inn).astype(np.float32)
    want = np.asarray(jw.qeinsum(spec, jnp.asarray(x), jq))
    got = tw.qeinsum(spec, torch.from_numpy(x), tq)
    assert got.shape == (E, C, out)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    # one x expanded over the experts (models/moe.py, dense mode)
    x1 = np.random.RandomState(C + 2).randn(C, inn).astype(np.float32)
    want = np.asarray(jw.qeinsum(
        spec, jnp.broadcast_to(jnp.asarray(x1), (E, C, inn)), jq))
    got = tw.qeinsum(spec, torch.from_numpy(x1)[None].expand(E, C, inn), tq)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("M", [1, 8, 40])
def test_tied_head_matches_jax(M):
    """The tied head: the per-row embedding [V, H] through `.T`, a ragged
    vocabulary (300)."""
    jq, tq = quantized((300, 48), M, axis=-1)
    x = np.random.RandomState(M + 7).randn(M, 48).astype(np.float32)
    want = np.asarray(jw.mm(jnp.asarray(x), jq.T))
    got = tw.mm(torch.from_numpy(x), tq.T)
    assert got.shape == (M, 300)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_bit_equal_to_the_composition(dtype):
    """The plain version is the composition the port ran before the fused
    kernel (`x @ operand(w) * s`, the expert einsum), to the bit: for a
    dense weight, the tied head and an expert stack."""
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(9, 48).astype(np.float32)).to(dtype)
    _, tq = quantized((48, 70), 5)
    old = (x @ tw.operand(tq, dtype)) * tq.s.to(dtype)
    assert torch.equal(w8.w8a16_mm_plain(x, tq.q, tq.s), old)
    _, te = quantized((70, 48), 9, axis=-1)
    head = te.T
    old = (x @ tw.operand(head, dtype)) * head.s.to(dtype)
    assert torch.equal(w8.w8a16_mm_plain(x, head.q, head.s), old)
    _, ts = quantized((3, 48, 22), 7)
    xe = torch.from_numpy(rng.randn(3, 5, 48).astype(np.float32)).to(dtype)
    old = (torch.einsum("ech,ehi->eci", xe, tw.operand(ts, dtype))
           * ts.s.squeeze(-2).to(dtype)[..., None, :])
    assert torch.equal(w8.w8a16_mm_plain(xe, ts.q, ts.s), old)


def test_mm_and_qeinsum_route_int8_through_the_wrapper(monkeypatch):
    seen = []

    def spy(x, q, s):
        seen.append((tuple(x.shape), tuple(q.shape), w8.is_tied(q),
                     q.data_ptr()))
        return w8.w8a16_mm_plain(x, q, s)

    monkeypatch.setattr(tw, "w8a16_mm", spy)
    _, tq = quantized((24, 40), 1)
    _, te = quantized((3, 24, 10), 2)
    _, td = quantized((3, 10, 24), 3)
    _, emb = quantized((50, 24), 4, axis=-1)
    calls, copies = tw.quantized_calls[8], tw.operand.calls
    four = tw.quantized_calls[4]
    tw.mm(torch.zeros(2, 5, 24), tq)
    tw.qeinsum(SPECS[0], torch.zeros(3, 4, 24), te)
    tw.qeinsum(SPECS[1], torch.zeros(3, 4, 10), td)
    tw.mm(torch.zeros(2, 24), emb.T)
    assert [c[:3] for c in seen] == [
        ((10, 24), (24, 40), False), ((3, 4, 24), (3, 24, 10), False),
        ((3, 4, 10), (3, 10, 24), False), ((2, 24), (24, 50), True)]
    # the tied head is the embedding's own storage, not a transposed copy
    assert seen[-1][3] == emb.q.data_ptr()
    assert tw.quantized_calls[8] == calls + 4
    assert tw.operand.calls == copies and tw.quantized_calls[4] == four


def test_qeinsum_int8_other_spec_raises():
    _, te = quantized((3, 24, 10), 4)
    calls = tw.quantized_calls[8]
    with pytest.raises(ValueError, match="int8 weight takes only"):
        tw.qeinsum("ech,ehi->ehc", torch.zeros(3, 4, 24), te)
    assert tw.quantized_calls[8] == calls


def test_layouts():
    q = torch.zeros(24, 40, dtype=torch.int8)
    assert not w8.is_tied(q) and w8.is_tied(q.t())
    assert not w8.is_tied(q[:, ::2]) and not w8.is_tied(q.t()[:, ::2])
    assert not w8.is_tied(torch.zeros(3, 24, 40, dtype=torch.int8))
    x = torch.zeros(5, 40)
    assert w8.check_args(x, q.t(), torch.ones(24, 1).t()) == (1, 5, 40, 24,
                                                             True)


def test_wrapper_refusals():
    """What the kernel does not take raises (checked before any launch)."""
    _, tq = quantized((32, 64), 9)
    x = torch.zeros(4, 32)
    assert w8.check_args(x, tq.q, tq.s) == (1, 4, 32, 64, False)
    bad = [
        (x.to(torch.int32), tq.q, tq.s, "activation dtype"),
        (x, tq.q.to(torch.uint8), tq.s, "int8 weight"),
        (x, tq.q[:, ::2], tq.s[:, ::2].contiguous(), "int8 weight"),
        (x, tq.q, tq.s.double(), "float32 scales"),
        (x, tq.q, torch.ones(1, 128)[:, ::2], "float32 scales"),
        (torch.zeros(4, 31), tq.q, tq.s, "do not match"),
        (x, tq.q, torch.ones(1, 32), "do not match"),
        (torch.zeros(2, 4, 32), tq.q, tq.s, "needs"),
        # a batch of tables read transposed is no layout of the kernel's
        (torch.zeros(2, 4, 32),
         torch.zeros(2, 64, 32, dtype=torch.int8).transpose(1, 2),
         torch.ones(2, 1, 64), "int8 weight"),
    ]
    for xa, qa, sa, msg in bad:
        with pytest.raises(ValueError, match=msg):
            w8.check_args(xa, qa, sa)
    with pytest.raises(ValueError, match="unsupported device"):
        w8.w8a16_mm(x.to("meta"), tq.q.to("meta"), tq.s.to("meta"))


def test_cpu_calls_count_no_launch():
    _, tq = quantized((16, 32), 10)
    _, emb = quantized((40, 16), 11, axis=-1)
    before = dict(w8.w8a16_mm.launches)
    tied = w8.w8a16_mm.tied_launches
    for dt in (torch.float32, torch.bfloat16):
        y = w8.w8a16_mm(torch.ones(3, 16, dtype=dt), tq.q, tq.s)
        assert y.dtype == dt and y.shape == (3, 32)
        y = w8.w8a16_mm(torch.ones(3, 16, dtype=dt), emb.T.q, emb.T.s)
        assert y.dtype == dt and y.shape == (3, 40)
    assert dict(w8.w8a16_mm.launches) == before
    assert w8.w8a16_mm.tied_launches == tied


@pytest.mark.parametrize("M,K,N,batch,dtype,want", [
    # Llama-3-8B up / q / k / down / lm_head at decode, 132 SMs: the int4
    # kernel's rule over 128-column strips
    (8, 4096, 14336, 1, torch.bfloat16, (0, 8, 2)),
    (8, 4096, 4096, 1, torch.bfloat16, (0, 8, 8)),
    (8, 4096, 1024, 1, torch.bfloat16, (0, 8, 16)),
    (8, 14336, 4096, 1, torch.bfloat16, (0, 8, 8)),
    (8, 4096, 128256, 1, torch.bfloat16, (0, 8, 1)),
    (1, 4096, 14336, 1, torch.float16, (0, 8, 2)),
    (40, 4096, 14336, 1, torch.bfloat16, (3, 48, 2)),
    (64, 4096, 14336, 1, torch.bfloat16, (4, 64, 2)),
    # prefill's 512 rows: 128-row blocks
    (512, 4096, 14336, 1, torch.bfloat16, (5, 128, 1)),
    (512, 4096, 4096, 1, torch.bfloat16, (5, 128, 2)),
    (100, 4096, 14336, 1, torch.bfloat16, (5, 128, 2)),
    (40, 4096, 14336, 1, torch.float32, (6, 16, 1)),
    # Gemma-2's tied head; Qwen3-30B-A3B's and Qwen2-57B-A14B's expert
    # stacks: enough tiles, no split
    (8, 3584, 256000, 1, torch.bfloat16, (0, 8, 1)),
    (8, 2048, 768, 128, torch.bfloat16, (0, 8, 1)),
    (8, 3584, 2560, 64, torch.bfloat16, (0, 8, 1)),
    # few k stages cap the split; tiny shapes split nothing
    (8, 300, 16, 1, torch.bfloat16, (0, 8, 1)),
    (3, 64, 20, 2, torch.float32, (6, 16, 1)),
])
def test_plan(M, K, N, batch, dtype, want):
    from cxl_speckv_tpu_torch.ops import w4a16_mm as w4

    cfg, mb, splits = w8.plan(M, K, N, batch, dtype, 132)
    assert (cfg, mb, splits) == want
    assert (mb, cfg) == w4.block(M, dtype, w8.MMA_BLOCKS, w8.FMA_BLOCK)
    tiles = batch * -(-N // w8.BN) * -(-M // mb)
    assert splits == 1 or (tiles * splits <= w4.SPLIT_CTAS_PER_SM * 132
                           and -(-K // w8.BK) >= splits
                           * w4.MIN_SPLIT_STAGES)


def test_sweep_int8_arm():
    """The sweep's int8 weights (a stack, the tied head's transposed
    table), its variant source and its refusal without CUDA."""
    gen = torch.Generator().manual_seed(0)
    w4a16_sweep.SHAPES_8["tiny tied"] = (1, 16, 48, True)
    w4a16_sweep.SHAPES_8["tiny stack"] = (3, 16, 24, False)
    try:
        mats, B, K, N = w4a16_sweep.weights("tiny tied", 8, gen, "cpu")
        assert (B, K, N) == (1, 16, 48) and len(mats) == w4a16_sweep.CALLS
        q, s = mats[0]
        assert w8.is_tied(q) and q.shape == (16, 48) and s.shape == (1, 48)
        mats, B, K, N = w4a16_sweep.weights("tiny stack", 8, gen, "cpu")
        q, s = mats[0]
        assert q.shape == (3, 16, 24) and s.shape == (3, 1, 24)
        mats, *_ = w4a16_sweep.weights("k", 4, gen, "cpu")
        assert mats[0][0].shape == (4096, 512)
    finally:
        del w4a16_sweep.SHAPES_8["tiny tied"], w4a16_sweep.SHAPES_8[
            "tiny stack"]
    src = (CSRC / "w8a16_mm.cu").read_text()
    assert w4a16_sweep.variant_source(src, 4, 64) == src
    v = w4a16_sweep.variant_source(src, 3, 128)
    assert "constexpr int NSTAGE = 3;" in v and "constexpr int BK = 128;" in v
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA is not available"):
            w4a16_sweep.main(["--bits", "8", "--shapes", "k", "--rows", "1"])
