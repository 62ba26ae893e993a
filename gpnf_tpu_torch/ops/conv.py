"""Convolution primitives of the coupling networks.

Counterpart of gpnf_tpu/ops/conv.py: NCHW "SAME" convolutions with OIHW
weights; Glow's `Conv2d` (normal(0, 0.05) init with a fused actnorm) and
`Conv2dZeros` (zero init, learnable per-channel log-scale) of the affine
coupling; and the weight-normalised conv and dense layers (torch's
weight_norm: w = g * v / ||v||, the norm over every axis but the output
axis).

Under MarScfConfig(compute_dtype="bfloat16") the coupling nets run in
bfloat16 as the JAX package runs them: each weight-normalised layer rounds
v, g and b to bf16 first (its `_cast_params`), normalises in float32 and
casts the weight to bf16 (`effective_weight(dtype)`); a product
accumulates in float32 and is rounded once, and the bias is added after
it, in bf16 (two roundings, the JAX `conv2d`'s `y + b`).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def same_pad(k: int, dilation: int):
    """(low, high) padding that keeps a stride-1 output the input's size."""
    total = dilation * (k - 1)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, w: torch.Tensor, b=None, *,
           dilation: int = 1) -> torch.Tensor:
    """Stride-1 "SAME" 2-D convolution, x (B, C, H, W), w (O, I, kh, kw).
    A bf16 x takes w and b in bf16, the bias added after the product."""
    if x.dtype == torch.bfloat16:
        y = _conv2d(x, w.to(x.dtype), None, dilation)
        return y if b is None else y + b.to(x.dtype).reshape(1, -1, 1, 1)
    return _conv2d(x, w, b, dilation)


def _conv2d(x, w, b, dilation):
    (ph0, ph1), (pw0, pw1) = (same_pad(w.shape[2], dilation),
                              same_pad(w.shape[3], dilation))
    if ph0 == ph1 and pw0 == pw1:
        return F.conv2d(x, w, b, padding=(ph0, pw0), dilation=dilation)
    x = F.pad(x, (pw0, pw1, ph0, ph1))
    return F.conv2d(x, w, b, dilation=dilation)


def uniform_(shape, bound: float, generator=None) -> torch.Tensor:
    """U(-bound, bound) on the CPU, drawn from `generator`."""
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


class Conv2d(nn.Module):
    """Conv with normal(0, 0.05) weights and a fused actnorm:
    (conv(x) + an_bias) * exp(an_logs)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, *,
                 generator=None):
        super().__init__()
        self.w = nn.Parameter(torch.randn(
            (out_ch, in_ch, kernel_size, kernel_size),
            generator=generator) * 0.05)
        self.an_bias = nn.Parameter(torch.zeros(out_ch))
        self.an_logs = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x):
        return (conv2d(x, self.w) + self.an_bias.reshape(1, -1, 1, 1)) * \
            torch.exp(self.an_logs).reshape(1, -1, 1, 1)

    @torch.no_grad()
    def ddi(self, x, eps: float = 1e-6):
        """Set the fused actnorm from the batch `x` in place (zero mean,
        unit std per output channel); return forward(x)."""
        y = conv2d(x, self.w)
        mean = torch.mean(y, dim=(0, 2, 3))
        var = torch.mean((y - mean.reshape(1, -1, 1, 1)) ** 2, dim=(0, 2, 3))
        self.an_bias.copy_(-mean)
        self.an_logs.copy_(torch.log(1.0 / (torch.sqrt(var) + eps)))
        return self(x)


class Conv2dZeros(nn.Module):
    """Zero-initialised conv whose output is scaled per channel by
    exp(3 * logs)."""

    LOGSCALE_FACTOR = 3.0

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3):
        super().__init__()
        self.w = nn.Parameter(torch.zeros((out_ch, in_ch, kernel_size,
                                           kernel_size)))
        self.b = nn.Parameter(torch.zeros(out_ch))
        self.logs = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x):
        return conv2d(x, self.w, self.b) * torch.exp(
            self.logs * self.LOGSCALE_FACTOR).reshape(1, -1, 1, 1)


class WNConv2d(nn.Module):
    """Weight-normalised conv with torch's default Conv2d init."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, *,
                 generator=None):
        super().__init__()
        bound = 1.0 / math.sqrt(in_ch * kernel_size * kernel_size)
        v = uniform_((out_ch, in_ch, kernel_size, kernel_size), bound,
                     generator)
        self.v = nn.Parameter(v)
        self.g = nn.Parameter(torch.sqrt(torch.sum(v.reshape(out_ch, -1) ** 2,
                                                   dim=-1)))
        self.b = nn.Parameter(uniform_((out_ch,), bound, generator))

    def effective_weight(self, dtype=None) -> torch.Tensor:
        """g v / ||v||; with a dtype, v and g rounded to it first, the norm
        taken in float32 and the weight cast to it."""
        v, g = _rounded(self.v, self.g, dtype)
        norm = torch.sqrt(torch.sum(v.reshape(v.shape[0], -1) ** 2, dim=-1))
        w = v * (g / norm).reshape(-1, 1, 1, 1)
        return w if dtype is None else w.to(dtype)

    def forward(self, x):
        if x.dtype == torch.bfloat16:
            return conv2d(x, self.effective_weight(x.dtype), self.b)
        return conv2d(x, self.effective_weight(), self.b)


class WNDense(nn.Module):
    """Weight-normalised linear layer on the last axis."""

    def __init__(self, in_f: int, out_f: int, *, bias: bool = True,
                 generator=None):
        super().__init__()
        bound = 1.0 / math.sqrt(in_f)
        v = uniform_((out_f, in_f), bound, generator)
        self.v = nn.Parameter(v)
        self.g = nn.Parameter(torch.sqrt(torch.sum(v ** 2, dim=-1)))
        self.b = (nn.Parameter(uniform_((out_f,), bound, generator))
                  if bias else None)

    def effective_weight(self, dtype=None) -> torch.Tensor:
        """As WNConv2d's."""
        v, g = _rounded(self.v, self.g, dtype)
        w = v * (g / torch.sqrt(torch.sum(v ** 2, dim=-1)))[:, None]
        return w if dtype is None else w.to(dtype)

    def forward(self, x):
        if x.dtype != torch.bfloat16:
            return F.linear(x, self.effective_weight(), self.b)
        y = F.linear(x, self.effective_weight(x.dtype))
        return y if self.b is None else y + self.b.to(x.dtype)


def _rounded(v, g, dtype):
    """v and g rounded to dtype and back to float32 (JAX's `_cast_params`,
    then `effective_weight`'s upcast), or as they are."""
    if dtype is None:
        return v, g
    return v.to(dtype).float(), g.to(dtype).float()
