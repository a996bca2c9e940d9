"""Weight-only quantization of the model's matmul weights (W8A16, W4A16).

Counterpart of `cxl_speckv_tpu/ops/wquant.py`; values and scales are
bit-exact with it (tests/test_torch_wquant.py, tests/test_torch_w4a16.py).
Weights are stored as int8 (bits 8) or int4 (bits 4) with a float32 scale
per output channel; the matmul runs in the activation dtype and the scale
multiplies the result:

    (x @ q) * s  ==  x @ (q * s)        exactly, when s is per-out-column

The embedding quantizes per ROW, so one table serves the gather and,
transposed, the tied lm_head matmul; it stays int8 at bits 4, as in the JAX
package. MoE expert weights [L, E, in, out] quantize per output channel of
each expert (s [L, E, 1, out]); the router, biases, sinks and norms stay in
full precision.

An int4 weight stores two signed nibbles a byte along its LAST (output)
axis, half-split (low nibble column j, high nibble column j + out/2, the
INT4 KV order of `ops/quant.py`): q is [..., in, out/2] int8, while the
scale [..., 1, out], leading-axis (layer / expert) indexing and layer
slicing are those of int8. The JAX package stores jnp.int4, which XLA
packs in HBM.

Every quantized call of `mm` and `qeinsum` is one launch of a fused
kernel that reads the stored weight once and converts its values to the
activation dtype in registers: `ops/w8a16_mm.w8a16_mm` at bits 8 (dense
weights, the tied head read from the embedding's [V, H] rows as they lie,
and the MoE expert stacks), `ops/w4a16_mm.w4a16_mm` at bits 4. `qeinsum`
takes the two MoE expert specs (`EXPERT_SPECS`) as the kernels' batched
form. The JAX package runs these products outside any Pallas kernel (XLA
fuses its convert). `operand` is the composition the int8 kernel
replaced, the weight's full-width copy in the activation dtype; nothing
on the model's path calls it.
"""

from __future__ import annotations

from collections import Counter

import torch

from cxl_speckv_tpu_torch.ops.quant import pack_int4, unpack_int4
from cxl_speckv_tpu_torch.ops.w4_unpack import w4_unpack
from cxl_speckv_tpu_torch.ops.w4a16_mm import w4a16_mm
from cxl_speckv_tpu_torch.ops.w8a16_mm import w8a16_mm

_QMAX = {8: 127, 4: 7}


class QuantizedTensor:
    """An int8 or int4 weight with a broadcastable per-channel scale.

    q: int8; the original weight's shape at bits 8, its last axis halved
       (two half-split nibbles a byte) at bits 4.
    s: float32, the logical shape's rank with `axis` reduced to size 1.
    axis: the reduced axis, negative. Matmul weights [..., in, out] use -2
       (per-output-channel); the embedding table [V, H] uses -1 (per-row).
    bits: 8 or 4.
    """

    __slots__ = ("q", "s", "axis", "bits")

    def __init__(self, q: torch.Tensor, s: torch.Tensor, axis: int,
                 bits: int = 8):
        if bits not in _QMAX:
            raise ValueError(f"bits must be 8 or 4, got {bits}")
        self.q = q
        self.s = s
        self.axis = axis
        self.bits = bits

    @property
    def shape(self):
        """The logical shape (an int4 weight's unpacked width)."""
        if self.bits == 4:
            return torch.Size((*self.q.shape[:-1], 2 * self.q.shape[-1]))
        return self.q.shape

    @property
    def T(self):
        """2-D transpose: a per-row embedding [V, H] becomes a per-out-column
        head weight [H, V]. int8 only: the nibbles pack along the last axis
        (the JAX package transposes only the embedding, which stays int8)."""
        if self.bits != 8:
            raise ValueError("QuantizedTensor.T of an int4 weight: its "
                             "nibbles pack along the last axis")
        if self.q.ndim != 2:
            raise ValueError("QuantizedTensor.T is 2-D only")
        return QuantizedTensor(self.q.T, self.s.T, -3 - self.axis)

    def __getitem__(self, idx):
        """Leading-axis indexing (layer slicing of stacked weights)."""
        return QuantizedTensor(self.q[idx], self.s[idx], self.axis, self.bits)

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        q = unpack_int4(self.q) if self.bits == 4 else self.q
        return (q.float() * self.s).to(dtype)

    def __repr__(self):
        return (f"QuantizedTensor(q={tuple(self.q.shape)}, "
                f"s={tuple(self.s.shape)}, axis={self.axis}, "
                f"bits={self.bits})")


def quantize_tensor(w: torch.Tensor, axis: int = -2,
                    bits: int = 8) -> QuantizedTensor:
    """Symmetric per-channel intN: s = max(amax, 1e-8) / qmax over `axis`
    (qmax 127 at bits 8, 7 at bits 4), q = round-half-even(w / s) clipped
    to [-qmax, qmax]; at bits 4 packed two nibbles a byte along the last
    axis (`pack_int4`; an odd last axis raises). The same bits on the card
    and on the CPU: qmax divides as a tensor, because CUDA turns a division
    by a Python scalar into a multiplication by its reciprocal, which can
    differ in the last bit."""
    if bits not in _QMAX:
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    qmax = _QMAX[bits]
    axis = axis if axis < 0 else axis - w.ndim
    wf = w.float()
    amax = wf.abs().amax(dim=axis, keepdim=True)
    s = torch.clamp_min(amax, 1e-8) / torch.full_like(amax, qmax)
    # rounded and clipped in place: one float32 temporary of w's size, not
    # three (a converter quantizes matrices of ~0.4 GB on the card)
    q = (wf / s).round_().clamp_(-qmax, qmax).to(torch.int8)
    if bits == 4:
        q = pack_int4(q)
    return QuantizedTensor(q, s, axis, bits)


# matmul weights of a layer (quantized per output channel)
LAYER_MM_KEYS = frozenset({"q", "k", "v", "o", "gate", "up", "down",
                           "shared_gate", "shared_up", "shared_down"})
# kept in full precision: the MoE router (routing runs in float32, and
# top-k ties depend on it), sinks and the shared expert's scalar gate
SKIP_LAYER_KEYS = frozenset({"router", "router_bias", "shared_expert_gate",
                             "sinks"})


def quantize_weights(params: dict, bits: int = 8) -> dict:
    """Quantize an `init_params`-layout tree to W8A16 (bits 8) or W4A16
    (bits 4): every layer matmul weight (dense and expert) and lm_head per
    output channel, the embedding per row and always at int8 (as in the JAX
    package: it is gathered, not streamed, and its tied head is the last
    projection before sampling); norms, biases and `SKIP_LAYER_KEYS` stay
    as they are. A layer leaf of 3 or more dimensions that is neither
    raises, as in the JAX package. Idempotent on already-quantized
    leaves."""
    out = dict(params)
    if not isinstance(params["embed"], QuantizedTensor):
        out["embed"] = quantize_tensor(params["embed"], axis=-1, bits=8)
    layers = dict(params["layers"])
    for k, w in layers.items():
        if isinstance(w, QuantizedTensor):
            continue
        if k in LAYER_MM_KEYS:
            layers[k] = quantize_tensor(w, axis=-2, bits=bits)
        elif (k not in SKIP_LAYER_KEYS and w.ndim >= 3
              and not k.endswith(("_norm", "_bias"))):
            raise ValueError(f"unclassified layer weight {k!r} (shape "
                             f"{tuple(w.shape)})")
    out["layers"] = layers
    if "lm_head" in params and not isinstance(params["lm_head"],
                                              QuantizedTensor):
        out["lm_head"] = quantize_tensor(params["lm_head"], axis=-2, bits=bits)
    return out


def is_quantized(params: dict) -> bool:
    return isinstance(params.get("embed"), QuantizedTensor)


def operand(w: QuantizedTensor, dtype: torch.dtype) -> torch.Tensor:
    """An int8 weight's values in the activation dtype, a full-width copy:
    the operand of the composition `w8a16_mm` replaced (a yardstick and a
    reference; no matmul of the port calls it). Counts its calls in
    `operand.calls`. An int4 weight has no operand: its matmuls run
    `w4a16_mm`."""
    if w.bits != 8:
        raise ValueError("operand: an int4 weight multiplies in w4a16_mm")
    operand.calls += 1
    return w.q.to(dtype)


operand.calls = 0

# quantized matmul calls (`mm`, `qeinsum`) by bits, on any device; on the
# card every one launches its fused kernel once (`w8a16_mm` at bits 8,
# `w4a16_mm` at bits 4)
quantized_calls: Counter = Counter()

# the einsums `qeinsum` runs on a quantized weight (the MoE expert
# products, models/moe.py): x [E, C, in] against a stack [E, in, out]
EXPERT_SPECS = frozenset({"ech,ehi->eci", "eci,eih->ech"})


def _fused(bits: int):
    return w8a16_mm if bits == 8 else w4a16_mm


def mm(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for a plain tensor or a per-out-column QuantizedTensor (x's
    leading dims flatten into rows). The tied head `embed.T` multiplies
    from the embedding's own [V, H] storage."""
    if isinstance(w, QuantizedTensor):
        if w.axis != -2:
            raise ValueError(f"mm needs per-out-column scales, axis={w.axis}")
        quantized_calls[w.bits] += 1
        y = _fused(w.bits)(x.reshape(-1, x.shape[-1]), w.q, w.s)
        return y.reshape(*x.shape[:-1], y.shape[-1])
    return x @ w


def qeinsum(spec: str, x: torch.Tensor, w) -> torch.Tensor:
    """einsum(spec, x, w) where w may be quantized. A quantized weight takes
    the MoE expert einsums (`EXPERT_SPECS`: x [E, C, in] against a stack
    [E, in, out] with scales [E, 1, out], as in the JAX package) as its
    fused kernel's batched form; another spec raises."""
    if isinstance(w, QuantizedTensor):
        if spec not in EXPERT_SPECS or w.axis != -2:
            raise ValueError(f"qeinsum: an int{w.bits} weight takes only "
                             f"{sorted(EXPERT_SPECS)} with per-out-column "
                             f"scales, got {spec!r} (axis {w.axis})")
        quantized_calls[w.bits] += 1
        return _fused(w.bits)(x, w.q, w.s)
    return torch.einsum(spec, x, w)


def take_rows(w, ids: torch.Tensor, dtype=None) -> torch.Tensor:
    """Embedding gather w[ids], dequantizing per row when quantized (to
    `dtype`, default bfloat16); plain tables gather uncast."""
    if isinstance(w, QuantizedTensor):
        if w.axis != -1:
            raise ValueError("take_rows needs per-row scales (axis=-1)")
        dt = dtype or torch.bfloat16
        rows = w.q[ids]
        vals = w4_unpack(rows, dt) if w.bits == 4 else rows.to(dt)
        return vals * w.s[ids].to(dt)
    return w[ids]
