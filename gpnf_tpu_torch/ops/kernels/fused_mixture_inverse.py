"""Inverse of the logistic-mixture CDF: bisection, then clipped Newton.

Counterpart of gpnf_tpu/ops/pallas/fused_mixture_inverse.py
`mixture_inverse`. The CUDA kernel is gpnf_tpu_torch/csrc/mixture_inverse.cu
on the lane groups of csrc/mixture_lanes.cuh; their headers say what bounds
it on the H100 and how it is laid out. `mixture_inverse_plain` is the same
fixed schedule in plain PyTorch (the JAX package's `_inv_body`), summing over
the components in the kernel's order: the wrapper runs it for CPU tensors,
and the tests and chip_smoke.py hold the kernel to it bit for bit. The
backward is the JAX package's implicit-function VJP in plain PyTorch: at
CDF(x; theta) = y, dx/dy = 1 / pdf(x) and dx/dtheta = -(dCDF/dtheta) /
pdf(x).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import logistic
from . import _native

BISECT_ITERS = 26
NEWTON_ITERS = 4
GROUP = 4             # kGroup of csrc/mixture_lanes.cuh: lanes an element's
                      # components spread over
MAX_COMPONENTS = 128  # kMaxK of csrc/mixture_lanes.cuh
# operations per (element, component), each fp32 add/mul/compare and each
# exp/log/log1p counted once (a floor for the bound, since the accurate
# transcendentals take several instructions each): 26 bisection evaluations
# x 13 (z 2, log-sigmoid 6, term 1, max-then-sum logsumexp 4) + 4 Newton x
# 23 (the log-CDF terms 13; the log-PDF terms on the same z and log1p 6,
# their logsumexp 4) + setup 8
OPS_PER_COMPONENT = 438


def _sum_k(t, group=GROUP):
    """Sum over the component axis of (B, K, D) in the kernel's order: lane
    j of a group of `group` adds its components k = j, j + group, ... in k
    order, then the lanes' sums meet in a butterfly, lane j + lane j + h
    for h = group / 2, ..., 1 (missing components add 0, exactly). The
    fixed schedule magnifies a last-bit difference in log CDF where the CDF
    is flat, so the plain version rounds as the kernel does. group=1 is the
    k order of one thread an element."""
    bsz, k, d = t.shape
    slots = -(-k // group)
    lanes = F.pad(t, (0, 0, 0, slots * group - k)).view(bsz, slots, group, d)
    acc = lanes[:, 0]
    for i in range(1, slots):
        acc = acc + lanes[:, i]
    while acc.shape[1] > 1:
        h = acc.shape[1] // 2
        acc = acc[:, :h] + acc[:, h:]
    return acc[:, 0]


def _logsumexp_k(t, group):
    m = torch.amax(t, dim=1)
    return torch.log(_sum_k(torch.exp(t - m[:, None]), group)) + m


def mixture_inverse_plain(y, pi, mu, s, group=GROUP):
    """y (B, D) in (0, 1); pi/mu/s (B, K, D) -> x (B, D) with CDF(x) = y,
    summed over k in the order of a kernel built with `group` lanes."""
    pmax = torch.amax(pi, dim=1, keepdim=True)
    log_pi = (pi - pmax) - torch.log(
        _sum_k(torch.exp(pi - pmax), group))[:, None]
    inv_s = torch.exp(-s)

    def terms(x):
        z = (x[:, None, :] - mu) * inv_s
        l1p = torch.log1p(torch.exp(-torch.abs(z)))
        return z, l1p, log_pi + (torch.clamp(z, max=0.0) - l1p)

    def log_pdf(z, l1p):
        return _logsumexp_k(log_pi + z - s - 2.0 * (torch.clamp(z, min=0.0)
                                                    + l1p), group)

    scale_sum = _sum_k(torch.exp(s), group)
    lb = torch.amin(mu, dim=1) - 20.0 * scale_sum
    ub = torch.amax(mu, dim=1) + 20.0 * scale_sum
    log_y = torch.log(y)
    x = torch.zeros_like(y)
    for _ in range(BISECT_ITERS):
        gt = _logsumexp_k(terms(x)[2], group) > log_y
        x, lb, ub = (torch.where(gt, (x + lb) * 0.5, (x + ub) * 0.5),
                     torch.where(gt, lb, x), torch.where(gt, x, ub))
    for _ in range(NEWTON_ITERS):
        z, l1p, t_cdf = terms(x)
        log_cdf = _logsumexp_k(t_cdf, group)
        step = (log_cdf - log_y) * torch.exp(log_cdf - log_pdf(z, l1p))
        x = torch.minimum(torch.maximum(x - step, lb), ub)
    return x


def _forward(y, pi, mu, s):
    bsz, k, d = pi.shape
    if all(t.device.type == "cpu" for t in (y, pi, mu, s)):
        return mixture_inverse_plain(y, pi, mu, s)
    if k > MAX_COMPONENTS:
        raise ValueError(f"mixture_inverse: K={k} components, the kernel "
                         f"takes at most {MAX_COMPONENTS}")
    device = _native.check_cuda_inputs("mixture_inverse", y=y, pi=pi, mu=mu,
                                       s=s)
    group = _native.load("mixture_inverse").gpnf_mixture_group()
    if group != GROUP:
        raise RuntimeError(f"mixture_inverse: the kernel was built with "
                           f"{group} lanes an element, the plain version "
                           f"sums in groups of {GROUP}")
    x = torch.empty_like(y)
    _native.launch("mixture_inverse", "gpnf_mixture_inverse", device,
                   *(t.data_ptr() for t in (y, pi, mu, s, x)), bsz, k, d)
    mixture_inverse.launches += 1
    return x


class _MixtureInverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, pi, mu, s):
        x = _forward(y, pi, mu, s)
        ctx.save_for_backward(x, pi, mu, s)
        return x

    @staticmethod
    def backward(ctx, g):
        x, *theta = ctx.saved_tensors
        gx = g / torch.exp(logistic.mixture_log_pdf(x, *theta))
        theta = [t.detach().requires_grad_() for t in theta]
        with torch.enable_grad():
            cdf = torch.exp(logistic.mixture_log_cdf(x, *theta))
        return (gx, *torch.autograd.grad(cdf, theta, -gx))


def mixture_inverse(y, pi, mu, s):
    """x with mixture CDF(x) = y, differentiable in every input. CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    if y.dim() != 2 or pi.dim() != 3:
        raise ValueError(f"mixture_inverse: y {tuple(y.shape)} and pi "
                         f"{tuple(pi.shape)} are not (B, D) and (B, K, D)")
    bsz, k, d = pi.shape
    if y.shape != (bsz, d):
        raise ValueError(f"mixture_inverse: 'y' has shape {tuple(y.shape)}, "
                         f"expected {(bsz, d)}")
    for name, t in (("mu", mu), ("s", s)):
        if t.shape != pi.shape:
            raise ValueError(f"mixture_inverse: '{name}' has shape "
                             f"{tuple(t.shape)}, expected {tuple(pi.shape)}")
    return _MixtureInverse.apply(y, pi, mu, s)


mixture_inverse.launches = 0
