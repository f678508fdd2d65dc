"""The reference's f32 arithmetic where the port's bits depend on it.

The JAX package computes on XLA, whose CPU code has its own ``exp`` (a
polynomial, not the C library's), rewrites long reductions into windows of
32 and fuses a product into the sum that follows it.  torch's ``exp``
differs from XLA's in the last bit for ~10% of f32 arguments, and its sums
run in other orders.  Where such a last bit reaches a bf16 rounding or an
FP4 re-quantization -- the moe router's gates, and the gradients of the
router and of the loss, whose stochastic re-quantization turns one moved
value into flipped codes, and whisper's tanh-GELU, whose bf16 output is
the next GEMM's FP4 input -- the port computes as the reference does, with
these helpers: on every device, but for the loss's gradient, which takes
the reference's order on the CPU only (``mean_nll``).
"""
from __future__ import annotations

import struct

import numpy as np
import torch


def _f32(v: float) -> float:
    return float(np.float32(v))


# XLA's f32 exp: clamp, n = floor(x log2(e) + 1/2), r = x - n ln2 in two
# fused steps, a degree-5 polynomial in fused multiply-adds, times 2^n;
# results below the smallest normal f32 flushed to 0
_EXP_LO, _EXP_HI = _f32(-88.3762626647949), _f32(88.72283935546875)
_LOG2E = _f32(1.44269504088896341)
_LN2_HI, _LN2_LO = 0.693359375, _f32(-2.12194440e-4)
_EXP_POLY = tuple(_f32(c) for c in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
    1.6666665459e-1, 5.0000001201e-1))
_F32_MIN_NORMAL = 1.1754943508222875e-38


def fma(a, b, c) -> torch.Tensor:
    """a * b + c in f32 through f64: the product of two f32 values is exact
    there, the sum rounds to f64 and the cast rounds again to f32.  That is
    a fused multiply-add's one rounding but where the f64 sum lands on an
    f32 halfway point and was itself inexact, about one sum in 2^29: there
    the result can be one f32 ulp from the reference's.  (An exact version,
    TwoSum and round-to-odd, takes four times the small kernels, and the
    router runs this in every moe layer of every decode step.)"""
    d = [v.to(torch.float64) if isinstance(v, torch.Tensor) else v
         for v in (a, b, c)]
    return (d[0] * d[1] + d[2]).to(torch.float32)


def exp(x: torch.Tensor) -> torch.Tensor:
    """f32 exp, bit for bit the reference's for arguments up to 88.37 (a
    softmax's are <= 0), but where an ``fma`` rounds twice."""
    x = torch.clamp(x, _EXP_LO, _EXP_HI)
    n = torch.floor(x * _LOG2E + 0.5)
    r = fma(n, -_LN2_HI, x)
    r = fma(n, -_LN2_LO, r)
    y = torch.full_like(r, _EXP_POLY[0])
    for c in _EXP_POLY[1:]:
        y = fma(y, r, c)
    y = fma(y, r * r, r) + 1.0
    y = torch.ldexp(y, n.to(torch.int32))
    return torch.where(y < _F32_MIN_NORMAL, torch.zeros_like(y), y)


def _hex(bits: str) -> float:
    """An f32 constant of XLA's LLVM IR, written there as a hex double."""
    return struct.unpack(">d", bytes.fromhex(bits))[0]


# XLA's f32 tanh (``EmitFastTanh`` with fused multiply-adds): x where |x| <
# 0.0004, else a 13/6-degree rational of x clamped to +-7.9988, whose
# polynomials in x^2 run in fused multiply-adds; +-1 from |x| >= 20
_TANH_CLAMP = _hex("401FFEC880000000")
_TANH_SMALL = _hex("3F3A36E2E0000000")
_TANH_NUM = tuple(_hex(b) for b in (
    "BCB3E4B800000000", "3D4C266FC0000000", "BDD7A6FFE0000000",
    "3E6B800820000000", "3EEF286940000000", "3F44E1BDA0000000",
    "3F740B3B80000000"))
_TANH_DEN = tuple(_hex(b) for b in (
    "3EB41A7B00000000", "3F1F12BAC0000000", "3F629540A0000000",
    "3F740B3BA0000000"))
# jax.nn.gelu(approximate=True)'s f32 constants: 0.044715, sqrt(2 / pi)
# and their product (its derivative's 3 * 0.044715 x^2 term)
_GELU_C = _hex("3FA6E4E260000000")
_GELU_S = _hex("3FE9884540000000")
_GELU_CS = _hex("3FA2444F20000000")


def tanh(x: torch.Tensor) -> torch.Tensor:
    """f32 tanh, bit for bit the reference's (but where an ``fma`` rounds
    twice)."""
    ax = torch.abs(x)
    xc = torch.clamp(x, -_TANH_CLAMP, _TANH_CLAMP)
    x2 = xc * xc
    p = torch.full_like(x2, _TANH_NUM[0])
    for c in _TANH_NUM[1:]:
        p = fma(x2, p, c)
    q = torch.full_like(x2, _TANH_DEN[0])
    for c in _TANH_DEN[1:]:
        q = fma(x2, q, c)
    y = torch.where(ax < _TANH_SMALL, x, (xc * p) / q)
    return torch.where(ax >= 20.0, torch.copysign(torch.ones_like(x), x), y)


class Gelu(torch.autograd.Function):
    """``jax.nn.gelu`` (the tanh approximation) of f32 x as XLA's CPU code
    computes it, forward and backward: x (x^3 * 0.044715 + x) sqrt(2 / pi)
    inside the reference's ``tanh``, each product feeding a sum fused into
    it.  torch's ``gelu(approximate="tanh")`` differs in the last f32 bit
    for ~23% of unit-scale bf16-valued arguments and in the bf16 rounding
    of 0.003% of them and of ~1.1% of N(0, 2) ones; the checks are in
    tests/test_torch_whisper.py.  Every device runs this order, the card
    too, so that whisper's card logits equal the CPU's."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        t = tanh(fma(x * x * x, _GELU_C, x) * _GELU_S)
        return x * ((t + 1.0) * 0.5)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        x2 = x * x
        t = tanh(fma(x2 * x, _GELU_C, x) * _GELU_S)
        a = (1.0 - t) * ((x * g) * 0.5)
        b = fma(t, a, a)
        e = fma((t + 1.0) * 0.5, g, b * _GELU_S)
        return fma(x2 * 3.0, b * _GELU_CS, e)


def row_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in v's dtype, in the reference's order: a row
    longer than 32 is cut into windows of 32 (zero-padded), each added one
    by one, and the window sums are reduced the same way; every add rounds
    to the dtype."""
    while v.shape[-1] > 1:
        n = v.shape[-1]
        w = 32 if n > 32 else n
        if n % w:
            v = torch.nn.functional.pad(v, (0, w - n % w))
        cols = v.reshape(v.shape[:-1] + (-1, w)).movedim(-1, 0).contiguous()
        acc = torch.zeros(cols.shape[1:], dtype=v.dtype, device=v.device)
        for j in range(w):
            acc = acc + cols[j]
        v = acc
    return v[..., 0]


def row_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b) over the last axis, each product added to the running sum
    in one fused multiply-add: the reference's fused multiply-reduce loop
    (checked on rows of up to 8, the routers of the tests)."""
    acc = torch.zeros(a.shape[:-1], dtype=a.dtype, device=a.device)
    for k in range(a.shape[-1]):
        acc = fma(a[..., k], b[..., k], acc)
    return acc


def div_sum_grad(g: torch.Tensor, v: torch.Tensor,
                 s: torch.Tensor) -> torch.Tensor:
    """The reference's gradient of v / s where s (..., 1) is the row sum of
    v: g / s, less the row sum of g (1 / (s s)) v, in its order of
    rounding."""
    return g / s - row_dot(g * (1.0 / (s * s)), v)[..., None]


class Softmax(torch.autograd.Function):
    """Softmax over the last axis of f32 logits as the reference computes
    it: e = exp(x - max) over its row sum, with its backward
    (``div_sum_grad``, then times e)."""

    @staticmethod
    def forward(ctx, x):
        e = exp(x - torch.amax(x, dim=-1, keepdim=True))
        s = row_sum(e)[..., None]
        ctx.save_for_backward(e, s)
        return e / s

    @staticmethod
    def backward(ctx, g):
        e, s = ctx.saved_tensors
        return div_sum_grad(g, e, s) * e


def _nll_value(logp, targets, count):
    nll = -torch.gather(logp, -1, targets[..., None])
    return torch.mean(nll) if count is None else torch.sum(nll) / count


class MeanNLL(torch.autograd.Function):
    """mean(-log_softmax(logits)[targets]) over every token, f32.  The
    value is torch's; the gradient is the reference's, in its order:
    ((g / N) / S) e - (g / N) at the targets, e = exp(x - max) and S its
    row sum, rounded once to the logits' dtype.  ``count``: N where these
    tokens are one rank's share of a larger batch (the sum of their nll
    over ``count``), else the number of targets."""

    @staticmethod
    def forward(ctx, logits, targets, count=None):
        lf = logits.to(torch.float32)
        logp = torch.log_softmax(lf, dim=-1)
        ctx.save_for_backward(logits, targets)
        ctx.count = targets.numel() if count is None else count
        return _nll_value(logp, targets, count)

    @staticmethod
    def backward(ctx, g):
        logits, targets = ctx.saved_tensors
        lf = logits.to(torch.float32)
        e = exp(lf - torch.amax(lf, dim=-1, keepdim=True))
        gn = g / ctx.count
        d = (gn / row_sum(e)[..., None]) * e
        d.scatter_add_(-1, targets[..., None],
                       (-gn).expand(targets.shape + (1,)).contiguous())
        return d.to(logits.dtype), None, None


def torch_nll(logits: torch.Tensor, targets: torch.Tensor,
              count=None) -> torch.Tensor:
    """``mean_nll`` through torch's own log_softmax and its backward: the
    loss of the card, whose logit gradient is ``MeanNLL``'s within one ulp
    of the logits' dtype (tests/test_torch_moe.py, test_torch_archs.py)."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return _nll_value(logp, targets, count)


def mean_nll(logits: torch.Tensor, targets: torch.Tensor,
             count=None) -> torch.Tensor:
    """The mean next-token nll of ``logits`` (..., V) at ``targets`` (with
    ``count``: their summed nll over ``count``, one rank's share of a
    larger batch's mean).  On the CPU, where the tests hold the port to
    the reference, its gradient is the reference's (``MeanNLL``); on CUDA
    it is ``torch_nll``: the exact-order one is f64 work over every logit,
    ~40 ms of a 4-layer llama2-7b train step on an H100 (a declared
    divergence of the card, as the embedding's backward)."""
    if logits.is_cuda:
        return torch_nll(logits, targets, count)
    return MeanNLL.apply(logits, targets, count)
