"""Glow-style affine coupling and the learned-Gaussian split.

Counterpart of gpnf_tpu/ops/coupling.py. The coupling's scale is
sigmoid(raw + 2) and its log-det the sum of log scale; the forward runs
through the `fused_affine_forward` kernel (CUDA on the card, its plain
version on the CPU), the inverse in plain torch, as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .basic import GaussianDiag, split_channels, sum_except_batch
from .conv import Conv2d, Conv2dZeros
from .kernels.fused_coupling import fused_affine_forward


class NNNet(nn.Module):
    """conv3x3(+actnorm) -> relu -> conv1x1(+actnorm) -> relu -> zero-init
    conv3x3."""

    def __init__(self, in_ch: int, out_ch: int, hidden_ch: int, *,
                 generator=None):
        super().__init__()
        self.conv1 = Conv2d(in_ch, hidden_ch, 3, generator=generator)
        self.conv2 = Conv2d(hidden_ch, hidden_ch, 1, generator=generator)
        self.conv3 = Conv2dZeros(hidden_ch, out_ch, 3)

    def forward(self, x):
        return self.conv3(F.relu(self.conv2(F.relu(self.conv1(x)))))

    @torch.no_grad()
    def ddi(self, x):
        """Initialise the fused actnorms of conv1 and conv2 from `x`."""
        h = F.relu(self.conv1.ddi(x))
        return self.conv3(F.relu(self.conv2.ddi(h)))


class AffineCoupling(nn.Module):
    """z2' = sigmoid(raw + 2) * z2 + shift, (shift, raw) = cross split of
    NN(z1)."""

    def __init__(self, in_ch: int, out_ch: int, hidden_ch: int, *,
                 generator=None):
        super().__init__()
        self.net = NNNet(in_ch // 2, out_ch, hidden_ch, generator=generator)

    def forward(self, x, logdet, generator=None):
        z1, z2 = split_channels(x)
        shift, raw = split_channels(self.net(z1), "cross")
        b = z2.shape[0]
        flat = lambda t: t.reshape(b, -1).contiguous()
        y, ldj = fused_affine_forward(flat(z2), flat(shift), flat(raw))
        return torch.cat([z1, y.reshape(z2.shape)], dim=1), logdet + ldj

    def inverse(self, y, logdet):
        z1, z2 = split_channels(y)
        shift, raw = split_channels(self.net(z1), "cross")
        scale = torch.sigmoid(raw + 2.0)
        z2 = (z2 - shift) / scale
        return (torch.cat([z1, z2], dim=1),
                logdet - sum_except_batch(torch.log(scale)))

    @torch.no_grad()
    def ddi(self, x, logdet):
        """Initialise the network's actnorms from `x`; return forward(x)."""
        self.net.ddi(split_channels(x)[0])
        return self(x, logdet)


class Split2dGaussian(nn.Module):
    """Glow split whose z2 is scored by a conditional diagonal Gaussian,
    mean and log-std from a zero-init conv of z1."""

    def __init__(self, num_channels: int):
        super().__init__()
        self.conv = Conv2dZeros(num_channels // 2, num_channels, 3)

    def _prior(self, z1):
        return split_channels(self.conv(z1), "cross")

    def forward(self, x, logdet):
        z1, z2 = split_channels(x)
        mean, logs = self._prior(z1)
        return z1, logdet + GaussianDiag.logp(mean, logs, z2)

    def inverse(self, z1, logdet, eps_std=None, generator=None):
        mean, logs = self._prior(z1)
        z2 = GaussianDiag.sample(mean, logs, eps_std, generator)
        return torch.cat([z1, z2], dim=1), logdet
