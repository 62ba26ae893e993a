"""MixLogCDF (Flow++) coupling and its gated conv/attention network.

Counterpart of gpnf_tpu/ops/mixlogcdf.py, in eval mode (no dropout: the
training slice adds it).

Forward:  u = logit(MixLogCDF(x_change)); y = (u + b) * exp(a)
Inverse:  u = y*exp(-a) - b; x = MixLogCDF^{-1}(sigmoid(u).clip(1e-5, 1-1e-5))

The gated convs run NCHW; the layer norms and the attention run
channel-last, as the JAX package's NCHW layout does. The mixture transform
and the mixture inverse are the two kernels of `ops.kernels`, and every
GatedAttn is the fused-projection attention kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import logistic
from .basic import split_channels, sum_except_batch
from .conv import WNConv2d, WNDense
from .kernels import fused_attention_proj, mixlogcdf_forward, mixture_inverse


def concat_elu(x, dim=1):
    return F.elu(torch.cat([x, -x], dim=dim))


class LayerNorm(nn.Module):
    """nn.LayerNorm(C) on channel-last tensors, parameters gamma/beta."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(dim))
        self.beta = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return F.layer_norm(x, (x.shape[-1],), self.gamma, self.beta, self.eps)


class GatedConv(nn.Module):
    """PixelCNN++ gated residual conv: concat-ELU -> 3x3 -> concat-ELU -> 1x1 GLU."""

    def __init__(self, num_ch: int, *, generator=None):
        super().__init__()
        self.conv = WNConv2d(2 * num_ch, num_ch, 3, generator=generator)
        self.gate = WNConv2d(2 * num_ch, 2 * num_ch, 1, generator=generator)

    def forward(self, x):
        h = concat_elu(self.conv(concat_elu(x)))
        a, b = torch.chunk(self.gate(h), 2, dim=1)
        return a * torch.sigmoid(b)


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
    """Gated multi-head self-attention over the flattened spatial axis."""

    def __init__(self, d_model: int, num_heads: int = 4, *, generator=None):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj = WNDense(d_model, 3 * d_model, bias=False,
                               generator=generator)
        self.gate = WNDense(d_model, 2 * d_model, generator=generator)

    def forward(self, x):
        """x (B, H, W, C) channel-last."""
        b, h, w, c = x.shape
        seq = x.reshape(b, h * w, c) + sinusoidal_pos_enc(h * w, c, x.device)
        attn = fused_attention_proj(seq.contiguous(),
                                    self.in_proj.effective_weight().contiguous(),
                                    self.num_heads)
        a, g = torch.chunk(self.gate(attn.reshape(b, h, w, c)), 2, dim=-1)
        return a * torch.sigmoid(g)


class ConvAttnBlock(nn.Module):
    def __init__(self, num_ch: int, use_attn: bool, *, generator=None):
        super().__init__()
        self.conv = GatedConv(num_ch, generator=generator)
        self.norm1 = LayerNorm(num_ch)
        self.use_attn = use_attn
        if use_attn:
            self.attn = GatedAttn(num_ch, generator=generator)
            self.norm2 = LayerNorm(num_ch)

    def forward(self, x):
        """x (B, C, H, W) -> (B, C, H, W)."""
        x = (self.conv(x) + x).permute(0, 2, 3, 1)
        x = self.norm1(x)
        if self.use_attn:
            x = self.norm2(self.attn(x) + x)
        return x.permute(0, 3, 1, 2)


class MixLogCDFNet(nn.Module):
    """Produces (a, b, pi, mu, scales) with K mixture components per element."""

    def __init__(self, in_ch: int, num_ch: int, num_blocks: int,
                 num_components: int, use_attn: bool = True, *, generator=None):
        super().__init__()
        self.k = num_components
        self.in_conv = WNConv2d(in_ch, num_ch, 3, generator=generator)
        self.blocks = nn.ModuleList(
            ConvAttnBlock(num_ch, use_attn, generator=generator)
            for _ in range(num_blocks))
        self.out_conv = WNConv2d(num_ch, in_ch * (2 + 3 * num_components), 3,
                                 generator=generator)
        self.rescale = nn.Parameter(torch.ones(in_ch, 1, 1))

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.in_conv(x)
        for blk in self.blocks:
            y = blk(y)
        y = self.out_conv(y).reshape(b, 2 + 3 * self.k, c, h, w)
        a, t = y[:, 0], y[:, 1]
        pi = y[:, 2: 2 + self.k]
        mu = y[:, 2 + self.k: 2 + 2 * self.k]
        scales = torch.clamp(y[:, 2 + 2 * self.k:], min=-7.0)  # Flow++ clamp
        return self.rescale[None] * torch.tanh(a), t, pi, mu, scales


class MixLogCDFCoupling(nn.Module):
    def __init__(self, in_ch: int, mid_ch: int, num_blocks: int = 10,
                 num_components: int = 32, use_attn: bool = True, *,
                 generator=None):
        super().__init__()
        self.net = MixLogCDFNet(in_ch // 2, mid_ch, num_blocks, num_components,
                                use_attn, generator=generator)

    def forward(self, x, logdet):
        x_change, x_id = split_channels(x)
        a, b, pi, mu, s = self.net(x_id)
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
