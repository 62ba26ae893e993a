"""Shape-shuffling bijectors and the diagonal-Gaussian density.

Counterpart of gpnf_tpu/ops/basic.py. Bijectors without parameters are
plain functions on NCHW tensors: `forward`/`inverse` return (y, logdet).
"""
from __future__ import annotations

import math

import torch

LOG2PI = math.log(2.0 * math.pi)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """torch.sigmoid; on bf16, 1 / (1 + exp(-x)) with every step rounded to
    bf16, which is how the JAX package's jax.nn.sigmoid computes in bf16."""
    if x.dtype == torch.bfloat16:
        return 1.0 / (1.0 + torch.exp(-x))
    return torch.sigmoid(x)


def sum_except_batch(x: torch.Tensor) -> torch.Tensor:
    """Reduce all axes but the leading batch axis -> (B,)."""
    return torch.sum(x.reshape(x.shape[0], -1), dim=-1)


def split_channels(x: torch.Tensor, kind: str = "split"):
    """Channel split along axis 1: "split" = halves, "cross" = even/odd."""
    c = x.shape[1]
    if kind == "split":
        return x[:, : c // 2], x[:, c // 2:]
    if kind == "cross":
        return x[:, 0::2], x[:, 1::2]
    raise ValueError(f"unknown split kind {kind!r}")


def squeeze2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Space-to-depth with the Glow channel order (c, fh, fw)."""
    if factor == 1:
        return x
    b, c, h, w = x.shape
    if h % factor or w % factor:
        raise ValueError(f"squeeze2d: {h}x{w} not divisible by {factor}")
    x = x.reshape(b, c, h // factor, factor, w // factor, factor)
    x = x.permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, c * factor * factor, h // factor, w // factor)


def unsqueeze2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Inverse of squeeze2d."""
    if factor == 1:
        return x
    b, c, h, w = x.shape
    f2 = factor * factor
    if c % f2:
        raise ValueError(f"unsqueeze2d: {c} channels not divisible by {f2}")
    x = x.reshape(b, c // f2, factor, factor, h, w)
    x = x.permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, c // f2, h * factor, w * factor)


class Squeeze:
    """Zero-parameter, zero-logdet space-to-depth bijector."""

    def __init__(self, factor: int = 2):
        self.factor = factor

    def forward(self, x, logdet):
        return squeeze2d(x, self.factor), logdet

    def inverse(self, y, logdet):
        return unsqueeze2d(y, self.factor), logdet


class TupleFlip:
    """Swap the channel halves; its own inverse for equal halves."""

    @staticmethod
    def _flip(x):
        z1, z2 = torch.chunk(x, 2, dim=1)
        return torch.cat([z2, z1], dim=1)

    def forward(self, x, logdet):
        return self._flip(x), logdet

    def inverse(self, y, logdet):
        return self._flip(y), logdet


class GaussianDiag:
    """Diagonal Gaussian log-density and sampling; the noise comes from the
    caller's torch.Generator (the JAX package's from a key)."""

    @staticmethod
    def likelihood(mean, logs, x):
        if mean is None:
            return -0.5 * (x ** 2 + LOG2PI)
        return -0.5 * (logs * 2.0 + ((x - mean) ** 2) * torch.exp(-2.0 * logs)
                       + LOG2PI)

    @staticmethod
    def logp(mean, logs, x):
        return sum_except_batch(GaussianDiag.likelihood(mean, logs, x))

    @staticmethod
    def sample(mean, logs, eps_std=None, generator=None):
        eps_std = 1.0 if eps_std is None else eps_std
        eps = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                          device=mean.device) * eps_std
        return mean + torch.exp(logs) * eps

    @staticmethod
    def sample_eps(shape, eps_std=None, generator=None, dtype=torch.float32,
                   device=None):
        eps_std = 1.0 if eps_std is None else eps_std
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device) * eps_std
