"""Invertible 1x1 convolution with a PLU parameterisation.

Counterpart of gpnf_tpu/ops/invconv.py. `p` and `sign_s` are buffers,
never trained. logdet = sum(log|s|) * H * W (the correct pixel count, not
the W*W of the original torch code). The inverse weight comes from two
triangular solves against the identity.
"""
from __future__ import annotations

import numpy as np
import scipy.linalg
import torch
import torch.nn as nn

from .conv import conv2d


class InvConv1x1(nn.Module):
    def __init__(self, num_channels: int, *, generator=None):
        super().__init__()
        # a random orthogonal matrix, factored P L U (init-time only)
        a = torch.randn((num_channels, num_channels), generator=generator,
                        dtype=torch.float64).numpy()
        w = np.linalg.qr(a)[0].astype(np.float32)
        p, lower, upper = scipy.linalg.lu(w)
        s = np.diag(upper)
        f32 = lambda t: torch.from_numpy(np.ascontiguousarray(t, np.float32))
        self.register_buffer("p", f32(p))
        self.register_buffer("sign_s", f32(np.sign(s)))
        self.l = nn.Parameter(f32(np.tril(lower, -1)))
        self.u = nn.Parameter(f32(np.triu(upper, 1)))
        self.log_s = nn.Parameter(f32(np.log(np.abs(s))))

    def _factors(self):
        eye = torch.eye(self.l.shape[0], dtype=self.l.dtype, device=self.l.device)
        lower = torch.tril(self.l, -1) + eye
        upper = torch.triu(self.u, 1) + torch.diag(self.sign_s * torch.exp(self.log_s))
        return self.p, lower, upper, eye

    def _ldj(self, x):
        return torch.sum(self.log_s) * (x.shape[2] * x.shape[3])

    def forward(self, x, logdet):
        p, lower, upper, _ = self._factors()
        w = p @ lower @ upper
        return conv2d(x, w[:, :, None, None]), logdet + self._ldj(x)

    def inverse(self, y, logdet):
        p, lower, upper, eye = self._factors()
        l_inv = torch.linalg.solve_triangular(lower, eye, upper=False,
                                              unitriangular=True)
        u_inv = torch.linalg.solve_triangular(upper, eye, upper=True)
        w_inv = u_inv @ l_inv @ p.t()
        return conv2d(y, w_inv[:, :, None, None]), logdet - self._ldj(y)
