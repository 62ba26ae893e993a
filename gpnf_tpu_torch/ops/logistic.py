"""Logistic-mixture math for MixLogCDF (Flow++) couplings.

Counterpart of gpnf_tpu/ops/logistic.py. Mixture tensors carry the
component axis at dim 1: x is (B, ...), pi/mu/s are (B, K, ...).
`mixture_inv_cdf` is not ported yet: the coupling inverse uses
`ops.kernels.fused_mixture_inverse`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def safe_log(x):
    return torch.log(torch.clamp(x, min=1e-22))


def _log_pdf(x, mean, log_scale):
    z = (x - mean) * torch.exp(-log_scale)
    return z - log_scale - 2.0 * F.softplus(z)


def _log_cdf(x, mean, log_scale):
    z = (x - mean) * torch.exp(-log_scale)
    return F.logsigmoid(z)


def mixture_log_pdf(x, prior_logits, means, log_scales):
    log_ps = torch.log_softmax(prior_logits, dim=1) + _log_pdf(
        x[:, None], means, log_scales)
    return torch.logsumexp(log_ps, dim=1)


def mixture_log_cdf(x, prior_logits, means, log_scales):
    log_ps = torch.log_softmax(prior_logits, dim=1) + _log_cdf(
        x[:, None], means, log_scales)
    return torch.logsumexp(log_ps, dim=1)


def logit_transform(x, reverse=False):
    """Logit (forward) / sigmoid (reverse) with the elementwise log |d/dx|."""
    if reverse:
        return torch.sigmoid(x), F.softplus(x) + F.softplus(-x)
    z = -safe_log(1.0 / x - 1.0)
    ldj = -safe_log(x) - safe_log(1.0 - x)
    return z, ldj
