"""MixLogCDF (Flow++) coupling and its gated conv/attention network.

Counterpart of gpnf_tpu/ops/mixlogcdf.py. In training mode
(`nn.Module.train()`, the JAX package's `train=True`) the blocks drop out
with rate `drop_prob`: GatedConv drops whole (sample, channel) maps after
its second concat-ELU (torch's Dropout2d), and GatedAttn drops attention
weights. The unfused GatedConv draws its mask with torch.rand from the
`generator` passed to forward (the device's default generator when None);
GatedAttn and the fused GatedConv draw a (1,) int32 seed on the device from
that generator, and their kernels (or plain versions) turn it into a
Philox mask. JAX's keys give other numbers, so the port matches the JAX
package bit for bit only in eval mode or at rate 0. The JAX modules'
default drop_prob of the coupling (0.2) is MarScfConfig's here: the modules
default to 0.

Forward:  u = logit(MixLogCDF(x_change)); y = (u + b) * exp(a)
Inverse:  u = y*exp(-a) - b; x = MixLogCDF^{-1}(sigmoid(u).clip(1e-5, 1-1e-5))

The gated convs run NCHW; the layer norms and the attention run
channel-last, as the JAX package's NCHW layout does. With `fused_gconv`
(MarScfConfig.fused_gated_conv) each block's GatedConv and its residual are
one `fused_gated_conv` kernel on channel-last x, whose output goes straight
into the first layer norm. The mixture transform and the mixture inverse
are kernels of `ops.kernels`, and every GatedAttn is an attention kernel:
the fused-projection one where `attention_route` says it fits (S <= 512,
a head width it is built for, a block's shared memory: the flagship's C =
96 at every level but the 64-px level 0), else the wide route, the
long-sequence entry with its heads zero-padded to a built width (S = 1024
at 64 px, as the JAX package dispatches; and C = 8, 48, 160, 256, 512 at
any S, where the JAX package runs its jnp reference).

`compute_dtype=torch.bfloat16` (MarScfConfig's "bfloat16", the JAX
package's `compute_dtype`) runs in_conv, the blocks and out_conv in bf16
at the JAX package's rounding points: the net's input cast once, weights
rounded before the weight norm (ops/conv.py), the layer norms' statistics
in float32, GatedAttn's positions added in bf16, its qkv projection and
attention in the bf16 kernels (q * Dh^-1/2 rounded to bf16, the scores and
softmax in float32, P rounded for PV), out_conv's output cast back to
float32. `rescale`, the mixture head and its kernels and every log-det
stay float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import logistic
from .basic import sigmoid, split_channels, sum_except_batch
from .conv import WNConv2d, WNDense
from .kernels import (attention_route, fused_attention_long,
                      fused_attention_proj, fused_gated_conv, mixlogcdf_forward,
                      mixture_inverse)


def concat_elu(x, dim=1):
    return F.elu(torch.cat([x, -x], dim=dim))


def channel_dropout(x, rate: float, generator=None):
    """Dropout2d on NCHW: one keep per (sample, channel), kept maps scaled
    by 1 / (1 - rate)."""
    keep = torch.rand((x.shape[0], x.shape[1], 1, 1), generator=generator,
                      device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


class LayerNorm(nn.Module):
    """nn.LayerNorm(C) on channel-last tensors, parameters gamma/beta."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(dim))
        self.beta = nn.Parameter(torch.zeros(dim))

    def forward(self, x, residual=None):
        """LayerNorm(x + residual). In bf16 the sum is taken in float32 and
        not rounded: XLA, which runs the JAX package, drops the rounding of
        a bf16 sum that is upcast at once (its excess precision), and the
        JAX LayerNorm upcasts its input to float32 first."""
        if x.dtype != torch.bfloat16:
            return F.layer_norm(x if residual is None else x + residual,
                                (x.shape[-1],), self.gamma, self.beta,
                                self.eps)
        # the JAX LayerNorm under bf16: statistics in float32, xn rounded,
        # then xn * gamma + beta in bf16 (two more roundings)
        xf = x.float() if residual is None else x.float() + residual.float()
        mean = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean((xf - mean) ** 2, dim=-1, keepdim=True)
        xn = ((xf - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)
        return xn * self.gamma.to(x.dtype) + self.beta.to(x.dtype)


class GatedConv(nn.Module):
    """PixelCNN++ gated residual conv: concat-ELU -> 3x3 -> concat-ELU
    [-> Dropout2d in training] -> 1x1 GLU."""

    def __init__(self, num_ch: int, drop_prob: float = 0.0, *, generator=None):
        super().__init__()
        self.drop_prob = drop_prob
        self.conv = WNConv2d(2 * num_ch, num_ch, 3, generator=generator)
        self.gate = WNConv2d(2 * num_ch, 2 * num_ch, 1, generator=generator)

    def forward(self, x, generator=None):
        h = concat_elu(self.conv(concat_elu(x)))
        if self.training and self.drop_prob > 0.0:
            h = channel_dropout(h, self.drop_prob, generator)
        a, b = torch.chunk(self.gate(h), 2, dim=1)
        return a * sigmoid(b)

    def apply_fused(self, x, generator=None):
        """The block + x in one `fused_gated_conv` call, x (B, H, W, C)
        channel-last and contiguous -> (B, H, W, C): the JAX package's
        `GatedConv.apply_fused`. Gradients reach v, g and b through the
        effective weights. On bf16 x the weights and biases are bf16, as the
        JAX package's `_cast_params` leaves them: the weights rounded as
        the unfused layers round theirs (`effective_weight(dtype)`), the
        biases rounded once."""
        dtype = x.dtype if x.dtype == torch.bfloat16 else None
        w1 = self.conv.effective_weight(dtype).permute(2, 3, 1,
                                                       0).contiguous()
        wg = self.gate.effective_weight(dtype)[:, :, 0, 0].t().contiguous()
        b1, bg = self.conv.b, self.gate.b
        if dtype is not None:
            b1, bg = b1.to(dtype), bg.to(dtype)
        rate, seed = 0.0, None
        if self.training and self.drop_prob > 0.0:
            # drawn on the device: no host sync per call
            rate = self.drop_prob
            seed = torch.randint(0, 2 ** 30, (1,), generator=generator,
                                 dtype=torch.int32, device=x.device)
        return fused_gated_conv(x, w1, b1, wg, bg, rate, seed)


def sinusoidal_pos_enc(seq_len: int, num_channels: int, device=None):
    """Transformer sinusoidal positions, (1, seq_len, num_channels)."""
    position = torch.arange(seq_len, dtype=torch.float32, device=device)
    num_timescales = num_channels // 2
    log_inc = math.log(10000.0) / max(num_timescales - 1, 1)
    inv_timescales = torch.exp(
        torch.arange(num_timescales, dtype=torch.float32, device=device)
        * -log_inc)
    scaled = position[:, None] * inv_timescales[None, :]
    enc = torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)
    if num_channels % 2:
        enc = F.pad(enc, (0, 1))
    return enc[None]


class GatedAttn(nn.Module):
    """Gated multi-head self-attention over the flattened spatial axis;
    attention dropout inside the kernel in training."""

    def __init__(self, d_model: int, num_heads: int = 4,
                 drop_prob: float = 0.0, *, generator=None):
        super().__init__()
        self.d_model = d_model
        self.num_heads = num_heads
        self.drop_prob = drop_prob
        self.in_proj = WNDense(d_model, 3 * d_model, bias=False,
                               generator=generator)
        self.gate = WNDense(d_model, 2 * d_model, generator=generator)

    def route(self, seq_len: int):
        """The attention entry for S = seq_len (`attention_route`): "proj"
        or "wide", and the head width the kernels run."""
        return attention_route(seq_len, self.d_model, self.num_heads)

    def forward(self, x, generator=None):
        """x (B, H, W, C) channel-last."""
        b, h, w, c = x.shape
        seq = x.reshape(b, h * w, c) + sinusoidal_pos_enc(
            h * w, c, x.device).to(x.dtype)
        rate, seed = 0.0, None
        if self.training and self.drop_prob > 0.0:
            # drawn on the device: no host sync per call
            rate = self.drop_prob
            seed = torch.randint(0, 2 ** 30, (1,), generator=generator,
                                 dtype=torch.int32, device=x.device)
        fused = (fused_attention_proj if self.route(h * w).entry == "proj"
                 else fused_attention_long)
        # in bf16 the weight is rounded once: the JAX package's `_proj`
        # casts its in_proj weight to the input's dtype for the product
        dtype = x.dtype if x.dtype == torch.bfloat16 else None
        attn = fused(seq.contiguous(),
                     self.in_proj.effective_weight(dtype).contiguous(),
                     self.num_heads, rate, seed)
        a, g = torch.chunk(self.gate(attn.reshape(b, h, w, c)), 2, dim=-1)
        return a * sigmoid(g)


class ConvAttnBlock(nn.Module):
    def __init__(self, num_ch: int, use_attn: bool, drop_prob: float = 0.0, *,
                 generator=None, fused_gconv: bool = False):
        super().__init__()
        self.conv = GatedConv(num_ch, drop_prob, generator=generator)
        self.norm1 = LayerNorm(num_ch)
        self.use_attn = use_attn
        self.fused_gconv = fused_gconv
        if use_attn:
            self.attn = GatedAttn(num_ch, drop_prob=drop_prob,
                                  generator=generator)
            self.norm2 = LayerNorm(num_ch)

    def forward(self, x, generator=None):
        """x (B, C, H, W) -> (B, C, H, W)."""
        if self.fused_gconv:
            x = self.norm1(self.conv.apply_fused(
                x.permute(0, 2, 3, 1).contiguous(), generator))
        else:
            x = self.norm1(self.conv(x, generator).permute(0, 2, 3, 1),
                           x.permute(0, 2, 3, 1))
        if self.use_attn:
            x = self.norm2(self.attn(x, generator), x)
        return x.permute(0, 3, 1, 2)


class MixLogCDFNet(nn.Module):
    """Produces (a, b, pi, mu, scales) with K mixture components per element."""

    def __init__(self, in_ch: int, num_ch: int, num_blocks: int,
                 num_components: int, use_attn: bool = True,
                 drop_prob: float = 0.0, *, generator=None,
                 fused_gconv: bool = False, compute_dtype=None):
        super().__init__()
        self.k = num_components
        self.compute_dtype = compute_dtype
        self.in_conv = WNConv2d(in_ch, num_ch, 3, generator=generator)
        self.blocks = nn.ModuleList(
            ConvAttnBlock(num_ch, use_attn, drop_prob, generator=generator,
                          fused_gconv=fused_gconv)
            for _ in range(num_blocks))
        self.out_conv = WNConv2d(num_ch, in_ch * (2 + 3 * num_components), 3,
                                 generator=generator)
        self.rescale = nn.Parameter(torch.ones(in_ch, 1, 1))

    def forward(self, x, generator=None):
        b, c, h, w = x.shape
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        y = self.in_conv(x)
        for blk in self.blocks:
            y = blk(y, generator)
        y = self.out_conv(y)
        if self.compute_dtype is not None:
            y = y.float()  # the mixture head stays float32
        y = y.reshape(b, 2 + 3 * self.k, c, h, w)
        a, t = y[:, 0], y[:, 1]
        pi = y[:, 2: 2 + self.k]
        mu = y[:, 2 + self.k: 2 + 2 * self.k]
        scales = torch.clamp(y[:, 2 + 2 * self.k:], min=-7.0)  # Flow++ clamp
        return self.rescale[None] * torch.tanh(a), t, pi, mu, scales


class MixLogCDFCoupling(nn.Module):
    def __init__(self, in_ch: int, mid_ch: int, num_blocks: int = 10,
                 num_components: int = 32, use_attn: bool = True,
                 drop_prob: float = 0.0, *, generator=None,
                 fused_gconv: bool = False, compute_dtype=None):
        super().__init__()
        self.net = MixLogCDFNet(in_ch // 2, mid_ch, num_blocks, num_components,
                                use_attn, drop_prob, generator=generator,
                                fused_gconv=fused_gconv,
                                compute_dtype=compute_dtype)

    def forward(self, x, logdet, generator=None):
        x_change, x_id = split_channels(x)
        a, b, pi, mu, s = self.net(x_id, generator)
        bsz, k = x_change.shape[0], pi.shape[1]
        flat = lambda t: t.reshape(bsz, -1).contiguous()
        mix = lambda t: t.reshape(bsz, k, -1).contiguous()
        y, ldj = mixlogcdf_forward(flat(x_change), flat(a), flat(b), mix(pi),
                                   mix(mu), mix(s))
        out = torch.cat([y.reshape(x_change.shape), x_id], dim=1)
        return out, logdet + torch.sum(ldj, dim=-1)

    def inverse(self, y, logdet):
        x_change, x_id = split_channels(y)
        a, b, pi, mu, s = self.net(x_id)
        out, scale_ldj = logistic.logit_transform(x_change * torch.exp(-a) - b,
                                                  reverse=True)
        out = torch.clamp(out, 1e-5, 1.0 - 1e-5)
        bsz, k = out.shape[0], pi.shape[1]
        mix = lambda t: t.reshape(bsz, k, -1).contiguous()
        out = mixture_inverse(out.reshape(bsz, -1).contiguous(), mix(pi),
                              mix(mu), mix(s)).reshape(x_change.shape)
        logistic_ldj = logistic.mixture_log_pdf(out, pi, mu, s)
        logdet = logdet - sum_except_batch(a + scale_ldj + logistic_ldj)
        return torch.cat([out, x_id], dim=1), logdet
