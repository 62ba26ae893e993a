"""ActNorm: per-channel affine with a data-dependent initialisation.

Counterpart of gpnf_tpu/ops/actnorm.py. logdet = sum(logs) * H * W, added
on forward and subtracted on inverse. `ddi` sets the parameters in place
from a batch (zero mean, `scale` std per channel after the transform).
`MaskedActNorm` is not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn as nn


class ActNorm(nn.Module):
    def __init__(self, num_channels: int, scale: float = 1.0,
                 eps: float = 1e-6):
        super().__init__()
        self.scale = float(scale)
        self.eps = eps
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.logs = nn.Parameter(torch.zeros(num_channels))

    def _ldj(self, x):
        return torch.sum(self.logs) * (x.shape[2] * x.shape[3])

    def forward(self, x, logdet):
        y = (x + self.bias.reshape(1, -1, 1, 1)) * torch.exp(
            self.logs.reshape(1, -1, 1, 1))
        return y, logdet + self._ldj(x)

    def inverse(self, y, logdet):
        x = y * torch.exp(-self.logs.reshape(1, -1, 1, 1)) - self.bias.reshape(
            1, -1, 1, 1)
        return x, logdet - self._ldj(y)

    @torch.no_grad()
    def ddi(self, x, logdet):
        """Set bias/logs from the batch `x` in place; return forward(x)."""
        mean = torch.mean(x, dim=(0, 2, 3))
        var = torch.mean((x - mean.reshape(1, -1, 1, 1)) ** 2, dim=(0, 2, 3))
        self.bias.copy_(-mean)
        self.logs.copy_(torch.log(self.scale / (torch.sqrt(var) + self.eps)))
        return self.forward(x, logdet)
