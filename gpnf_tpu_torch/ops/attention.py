"""Invertible checkerboard patch attention (exact log-det, exact inverse).

Counterpart of gpnf_tpu/ops/attention.py; the math is set out in that
module's docstring. The input is cut into N = (H/p)(W/p) patches of
p = W//2; queries and keys are 1x1 convs of the masked input; the score
matrix A = sigmoid(S/scale + offset2) + offset3 mixes same-parity patches
through m1 = A[E,E] + offset*I and m2 = A[O,O] + offset*I, and
logdet = (log|det m1| + log|det m2|) * D/2.

Square inputs give n = 4 patches and 2x2 parity blocks: the quadrant path
works on image quadrants with closed-form 2x2 determinants and solves. The
general patch path serves every other shape; the tests pin the two equal.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn as nn

from .conv import conv2d, uniform_


def checkerboard(shape) -> np.ndarray:
    """1 where the index sum is even."""
    return (1 - np.indices(shape).sum(axis=0) % 2).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _image_mask(c: int, h: int, w: int, p: int, permute: bool) -> np.ndarray:
    """The (n, d) patch checkerboard rendered into image space (c, h, w)."""
    hh, ww = h // p, w // p
    m = checkerboard((hh * ww, c * p * p))
    if permute:
        m = 1.0 - m
    m = m.reshape(hh, ww, c, p, p).transpose(2, 0, 3, 1, 4)
    return np.ascontiguousarray(m.reshape(c, h, w))


def to_patches(x: torch.Tensor, p: int) -> torch.Tensor:
    """(B,C,H,W) -> (B, N, C*p*p), patches in row-major grid order."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // p, p, w // p, p).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, (h // p) * (w // p), c * p * p)


def from_patches(x: torch.Tensor, p: int, shape) -> torch.Tensor:
    b, c, h, w = shape
    x = x.reshape(b, h // p, w // p, c, p, p).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(b, c, h, w)


def _quads(t):
    ph, pw = t.shape[2] // 2, t.shape[3] // 2
    return (t[:, :, :ph, :pw], t[:, :, :ph, pw:],
            t[:, :, ph:, :pw], t[:, :, ph:, pw:])


def _from_quads(q00, q01, q10, q11):
    return torch.cat([torch.cat([q00, q01], dim=3),
                      torch.cat([q10, q11], dim=3)], dim=2)


def _det2(m):
    return m[:, 0, 0] * m[:, 1, 1] - m[:, 0, 1] * m[:, 1, 0]


def _slogabsdet(m):
    """log|det| of batched (B, n, n); closed form for n = 2."""
    if m.shape[-1] == 2:
        return torch.log(torch.abs(_det2(m)))
    return torch.linalg.slogdet(m)[1]


def _solve(m, u):
    """Batched solve m x = u for u (B, n, d); closed-form 2x2 adjugate."""
    if m.shape[-1] == 2:
        det = _det2(m)[:, None]
        a, b = m[:, 0, 0][:, None], m[:, 0, 1][:, None]
        c, d = m[:, 1, 0][:, None], m[:, 1, 1][:, None]
        x0 = (d * u[:, 0] - b * u[:, 1]) / det
        x1 = (-c * u[:, 0] + a * u[:, 1]) / det
        return torch.stack([x0, x1], dim=1)
    return torch.linalg.solve(m, u)


class InvertibleAttention(nn.Module):
    def __init__(self, num_channels: int, num_heads: int = 3, *,
                 offset_init: float = 0.99, offset2_init: float = 0.65,
                 offset3_init: float = -0.6, scale_init: float = 100.0,
                 generator=None):
        super().__init__()
        self.nc, self.num_heads = num_channels, num_heads
        bound = math.sqrt(1.0 / (3.0 * num_channels))
        shape = (num_heads, num_channels, num_channels)  # (heads, out, in)
        self.wq = nn.Parameter(uniform_(shape, bound, generator))
        self.wk = nn.Parameter(uniform_(shape, bound, generator))
        self.offset = nn.Parameter(torch.full((1,), offset_init))
        self.offset2 = nn.Parameter(torch.full((1,), offset2_init))
        self.offset3 = nn.Parameter(torch.full((1,), offset3_init))
        self.scale = nn.Parameter(torch.full((1,), scale_init))
        # the quadrant path for square inputs (n == 4); tests switch it off
        # to pin it against the general patch path
        self.use_quad_path = True

    @staticmethod
    def _geometry(shape):
        _, c, h, w = shape
        p = w // 2
        return p, (h // p) * (w // p), c * p * p

    def _qk(self, x_masked):
        """All heads in one conv each: (B, heads*C, H, W)."""
        wq = self.wq.reshape(self.num_heads * self.nc, self.nc, 1, 1)
        wk = self.wk.reshape(self.num_heads * self.nc, self.nc, 1, 1)
        return conv2d(x_masked, wq), conv2d(x_masked, wk)

    def _mix(self, scores, n):
        """Parity blocks m1 (even patches) and m2 (odd patches) from scores."""
        a = torch.sigmoid(scores / self.scale + self.offset2) + self.offset3
        eye = torch.eye(n // 2, dtype=a.dtype, device=a.device) * self.offset
        return a[:, 0::2, 0::2] + eye, a[:, 1::2, 1::2] + eye

    def _blocks_quad(self, x_masked):
        q, k = self._qk(x_masked)
        b = q.shape[0]
        qs = torch.stack([t.reshape(b, -1) for t in _quads(q)], dim=1)
        ks = torch.stack([t.reshape(b, -1) for t in _quads(k)], dim=1)
        # scores[b, i, j] = <quadrant_i(q), quadrant_j(k)> over heads and dims
        return self._mix(torch.bmm(qs, ks.transpose(1, 2)), 4)

    def _blocks(self, x_masked, p, n):
        q, k = self._qk(x_masked)
        b, _, h, w = q.shape

        def head_patches(t):
            t = to_patches(t.reshape(b * self.num_heads, self.nc, h, w), p)
            return t.reshape(b, self.num_heads, n, -1)

        scores = torch.einsum("bhnd,bhmd->bnm", head_patches(q), head_patches(k))
        return self._mix(scores, n)

    @staticmethod
    def _mix_quads(m1, m2, u):
        u00, u01, u10, u11 = _quads(u)
        c = lambda m, i, j: m[:, i, j][:, None, None, None]
        return _from_quads(c(m1, 0, 0) * u00 + c(m1, 0, 1) * u10,
                           c(m2, 0, 0) * u01 + c(m2, 0, 1) * u11,
                           c(m1, 1, 0) * u00 + c(m1, 1, 1) * u10,
                           c(m2, 1, 0) * u01 + c(m2, 1, 1) * u11)

    @staticmethod
    def _solve_quads(m1, m2, u):
        u00, u01, u10, u11 = _quads(u)
        c = lambda v: v[:, None, None, None]
        det1, det2 = c(_det2(m1)), c(_det2(m2))
        return _from_quads(
            (c(m1[:, 1, 1]) * u00 - c(m1[:, 0, 1]) * u10) / det1,
            (c(m2[:, 1, 1]) * u01 - c(m2[:, 0, 1]) * u11) / det2,
            (-c(m1[:, 1, 0]) * u00 + c(m1[:, 0, 0]) * u10) / det1,
            (-c(m2[:, 1, 0]) * u01 + c(m2[:, 0, 0]) * u11) / det2)

    def _ldj(self, m1, m2, d):
        return (_slogabsdet(m1) + _slogabsdet(m2)) * (d // 2)

    def _mask(self, shape, permute, device, dtype):
        _, c, h, w = shape
        p = w // 2
        return torch.as_tensor(_image_mask(c, h, w, p, permute), dtype=dtype,
                               device=device)

    def forward(self, x, logdet, *, permute: bool = False):
        p, n, d = self._geometry(x.shape)
        if n == 4 and self.use_quad_path:
            mask = self._mask(x.shape, permute, x.device, x.dtype)
            x_masked = x * mask
            m1, m2 = self._blocks_quad(x_masked)
            yu = self._mix_quads(m1, m2, x * (1.0 - mask))
            return yu * (1.0 - mask) + x_masked, logdet + self._ldj(m1, m2, d)
        mask = torch.as_tensor(checkerboard((n, d)), device=x.device)
        if permute:
            mask = 1.0 - mask
        xp = to_patches(x, p)
        x_masked = xp * mask
        m1, m2 = self._blocks(from_patches(x_masked, p, x.shape), p, n)
        u = xp * (1.0 - mask)
        y_even = torch.bmm(m1, u[:, 0::2])
        y_odd = torch.bmm(m2, u[:, 1::2])
        yu = torch.stack([y_even, y_odd], dim=2).reshape(xp.shape)
        yp = yu * (1.0 - mask) + x_masked
        return from_patches(yp, p, x.shape), logdet + self._ldj(m1, m2, d)

    def inverse(self, y, logdet, *, permute: bool = False):
        p, n, d = self._geometry(y.shape)
        if n == 4 and self.use_quad_path:
            mask = self._mask(y.shape, permute, y.device, y.dtype)
            y_masked = y * mask
            m1, m2 = self._blocks_quad(y_masked)
            xu = self._solve_quads(m1, m2, y * (1.0 - mask))
            return xu * (1.0 - mask) + y_masked, logdet - self._ldj(m1, m2, d)
        mask = torch.as_tensor(checkerboard((n, d)), device=y.device)
        if permute:
            mask = 1.0 - mask
        yp = to_patches(y, p)
        y_masked = yp * mask
        m1, m2 = self._blocks(from_patches(y_masked, p, y.shape), p, n)
        u = yp * (1.0 - mask)
        xu = torch.stack([_solve(m1, u[:, 0::2]), _solve(m2, u[:, 1::2])],
                         dim=2).reshape(yp.shape)
        xp = xu * (1.0 - mask) + y_masked
        return from_patches(xp, p, y.shape), logdet - self._ldj(m1, m2, d)
