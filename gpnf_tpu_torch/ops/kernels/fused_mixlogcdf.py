"""MixLogCDF coupling forward transform and its per-element log-det.

Counterpart of gpnf_tpu/ops/pallas/fused_mixlogcdf.py `mixlogcdf_forward`.
The CUDA kernel is gpnf_tpu_torch/csrc/mixlogcdf_forward.cu on the lane
groups of csrc/mixture_lanes.cuh; their headers say what bounds it on the
H100 and how it is laid out. `mixlogcdf_plain` is the
same function in plain PyTorch (the JAX package's `_reference`): the wrapper
runs it for CPU tensors, and the tests and chip_smoke.py hold the kernel
against it. The backward is autograd of the plain version on the saved
inputs, as the JAX package's `_bwd` differentiates its jnp reference: the
Pallas kernel has no backward kernel either.
"""
from __future__ import annotations

import torch

from .. import logistic
from . import _native
from .fused_mixture_inverse import MAX_COMPONENTS  # the kernels share it
# operations per (element, component), each fp32 add/mul/compare and each
# exp/log/log1p counted once: log-softmax 5, z 4, log-sigmoid/softplus 8,
# terms 5, two max-then-sum logsumexps 8
OPS_PER_COMPONENT = 30


def mixlogcdf_plain(x, a, b, pi, mu, s):
    """x/a/b (B, D); pi/mu/s (B, K, D) -> (y, elementwise ldj), both (B, D)."""
    u = torch.exp(logistic.mixture_log_cdf(x, pi, mu, s))
    u, scale_ldj = logistic.logit_transform(u)
    y = (u + b) * torch.exp(a)
    ldj = logistic.mixture_log_pdf(x, pi, mu, s) + scale_ldj + a
    return y, ldj


def _forward(x, a, b, pi, mu, s):
    bsz, k, d = pi.shape
    if all(t.device.type == "cpu" for t in (x, a, b, pi, mu, s)):
        return mixlogcdf_plain(x, a, b, pi, mu, s)
    if k > MAX_COMPONENTS:
        raise ValueError(f"mixlogcdf_forward: K={k} components, the kernel "
                         f"takes at most {MAX_COMPONENTS}")
    device = _native.check_cuda_inputs("mixlogcdf_forward", x=x, a=a, b=b,
                                       pi=pi, mu=mu, s=s)
    y = torch.empty_like(x)
    ldj = torch.empty_like(x)
    _native.launch("mixlogcdf_forward", "gpnf_mixlogcdf_forward", device,
                   *(t.data_ptr() for t in (x, a, b, pi, mu, s, y, ldj)),
                   bsz, k, d)
    mixlogcdf_forward.launches += 1
    return y, ldj


class _MixLogCDF(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, b, pi, mu, s):
        ctx.save_for_backward(x, a, b, pi, mu, s)
        return _forward(x, a, b, pi, mu, s)

    @staticmethod
    def backward(ctx, gy, gldj):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = mixlogcdf_plain(*inputs)
        pairs = [(o, g) for o, g in zip(outs, (gy, gldj)) if g is not None]
        return torch.autograd.grad([o for o, _ in pairs],
                                   inputs, [g for _, g in pairs])


def mixlogcdf_forward(x, a, b, pi, mu, s):
    """(y, ldj) of the MixLogCDF transform, differentiable in every input.
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if x.dim() != 2 or pi.dim() != 3:
        raise ValueError(f"mixlogcdf_forward: x {tuple(x.shape)} and pi "
                         f"{tuple(pi.shape)} are not (B, D) and (B, K, D)")
    bsz, k, d = pi.shape
    for name, t in (("x", x), ("a", a), ("b", b)):
        if t.shape != (bsz, d):
            raise ValueError(f"mixlogcdf_forward: '{name}' has shape "
                             f"{tuple(t.shape)}, expected {(bsz, d)}")
    for name, t in (("mu", mu), ("s", s)):
        if t.shape != pi.shape:
            raise ValueError(f"mixlogcdf_forward: '{name}' has shape "
                             f"{tuple(t.shape)}, expected {tuple(pi.shape)}")
    return _MixLogCDF.apply(x, a, b, pi, mu, s)


mixlogcdf_forward.launches = 0
