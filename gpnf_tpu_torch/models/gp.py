"""Exact Gaussian-process regression, alone or on flow-warped features.

Counterpart of gpnf_tpu/models/gp.py: stationary kernels, the jittered
Cholesky factorisation of the Gram matrix, the negative log marginal
likelihood (NLML) and the posterior through triangular solves, and type-II
maximum likelihood by Adam. The factorisation and the solves are the
port's kernels (`ops/kernels/cholesky.py`, `ops/kernels/trisolve.py`):
CUDA on the card, their plain versions on the CPU, with the JAX package's
two-solve gradients. The Gram matrix's cross product is a plain product
(TF32 off on the card, as the JAX package's HIGHEST precision).

The hyperparameters are the module's parameters (`log_lengthscale`,
`log_variance`, `log_noise`, the JAX package's names and shapes) instead of
a params dict; `FlowGP` holds the flow and the GP as submodules `flow` and
`gp`, so a JAX joint tree {"gp": ..., "flow": ...} loads whole with
`convert.load_jax_params`. `fit` returns the loss before each update, as
the JAX package's `lax.scan`, kept on the device and read once at the end.
The JAX package's `use_pallas_cholesky`/`use_pallas_trisolve` have no
counterpart: the kernels always run on the card.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from ..ops.kernels.cholesky import cholesky
from ..ops.kernels.trisolve import tril_solve
from ..utils.device import resolve_device

LOG2PI = math.log(2.0 * math.pi)


# -- kernels --------------------------------------------------------------------
def _sqdist(x1, x2, lengthscale):
    a = x1 / lengthscale
    b = x2 / lengthscale
    a2 = torch.sum(a * a, dim=-1, keepdim=True)
    b2 = torch.sum(b * b, dim=-1, keepdim=True)
    return torch.clamp(a2 - 2.0 * (a @ b.T) + b2.T, min=0.0)


def rbf_kernel(x1, x2, *, lengthscale, variance):
    return variance * torch.exp(-0.5 * _sqdist(x1, x2, lengthscale))


def matern12_kernel(x1, x2, *, lengthscale, variance):
    r = torch.sqrt(_sqdist(x1, x2, lengthscale) + 1e-12)
    return variance * torch.exp(-r)


def matern32_kernel(x1, x2, *, lengthscale, variance):
    s = math.sqrt(3.0) * torch.sqrt(_sqdist(x1, x2, lengthscale) + 1e-12)
    return variance * (1.0 + s) * torch.exp(-s)


def matern52_kernel(x1, x2, *, lengthscale, variance):
    r2 = _sqdist(x1, x2, lengthscale)
    s = math.sqrt(5.0) * torch.sqrt(r2 + 1e-12)
    return variance * (1.0 + s + 5.0 * r2 / 3.0) * torch.exp(-s)


KERNELS = {"rbf": rbf_kernel, "matern12": matern12_kernel,
           "matern32": matern32_kernel, "matern52": matern52_kernel}


def _adam(groups):
    """optax.adam's update: torch Adam with the same betas and eps."""
    return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)


# -- exact GP regression ----------------------------------------------------------
@dataclass(frozen=True)
class GPConfig:
    kernel: str = "rbf"
    ard: bool = True  # per-dimension lengthscales
    jitter: float = 1e-6


class GPRegression(nn.Module):
    """Exact GP with learnable log lengthscale(s), log variance and log
    noise. `device` defaults to CUDA and raises on a host without a card."""

    def __init__(self, cfg: GPConfig, input_dim: int, *, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.kernel_fn = KERNELS[cfg.kernel]
        self.input_dim = input_dim
        shape = (input_dim,) if cfg.ard else (1,)
        kw = dict(dtype=dtype, device=resolve_device(device))
        self.log_lengthscale = nn.Parameter(torch.zeros(shape, **kw))
        self.log_variance = nn.Parameter(torch.zeros((), **kw))
        self.log_noise = nn.Parameter(torch.full((), -2.0, **kw))

    @torch.no_grad()
    def init_from_data(self, x, y):
        """Median heuristic, in place: lengthscale from the median pairwise
        distance of x (the mean of the two middle values for an even count,
        as jnp.median), variance from var(y) and noise from a tenth of it."""
        d2 = _sqdist(x, x, torch.ones((1,), dtype=x.dtype, device=x.device))
        n = x.shape[0]
        iu = torch.triu_indices(n, n, offset=1, device=x.device)
        off = torch.sort(d2[iu[0], iu[1]]).values
        m = off.numel()
        med = off[m // 2] if m % 2 else 0.5 * (off[m // 2 - 1] + off[m // 2])
        self.log_lengthscale.fill_(
            0.5 * torch.log(torch.clamp(med / 2.0, min=1e-12)))
        var_y = torch.clamp(torch.var(y, correction=0), min=1e-8)
        self.log_variance.copy_(torch.log(var_y))
        self.log_noise.copy_(torch.log(0.1 * var_y))
        return self

    def _hyper(self):
        return (torch.exp(self.log_lengthscale), torch.exp(self.log_variance),
                torch.exp(self.log_noise))

    def gram(self, x1, x2=None):
        ls, var, _ = self._hyper()
        return self.kernel_fn(x1, x1 if x2 is None else x2, lengthscale=ls,
                              variance=var)

    def _factorize(self, x):
        _, _, noise = self._hyper()
        n = x.shape[0]
        k = self.gram(x) + (noise + self.cfg.jitter) * torch.eye(
            n, dtype=x.dtype, device=x.device)
        return cholesky(k)

    def neg_log_marginal_likelihood(self, x, y):
        """-log p(y | X) / N; y (N,) or (N, P) independent outputs."""
        y2d = y[:, None] if y.dim() == 1 else y
        n, p = y2d.shape
        l = self._factorize(x)
        a = tril_solve(l, y2d)
        quad = torch.sum(a * a)
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(l)))
        mll = -0.5 * quad - 0.5 * p * logdet - 0.5 * n * p * LOG2PI
        return -mll / (n * p)

    def posterior(self, x_train, y_train, x_test):
        """Predictive mean and marginal variance (noise included) at x_test."""
        y2d = y_train[:, None] if y_train.dim() == 1 else y_train
        l = self._factorize(x_train)
        k_star = self.gram(x_train, x_test)  # (N, M)
        alpha = tril_solve(l, tril_solve(l, y2d), trans=True)
        mean = k_star.T @ alpha
        v = tril_solve(l, k_star)
        _, var, noise = self._hyper()
        post_var = torch.clamp(var - torch.sum(v * v, dim=0), min=1e-12) + noise
        return (mean[:, 0] if y_train.dim() == 1 else mean), post_var

    def fit(self, x, y, *, steps: int = 200, lr: float = 0.05) -> np.ndarray:
        """Type-II maximum likelihood by Adam on the NLML, in place; the
        NLML before each update, read back once at the end."""
        opt = _adam([{"params": list(self.parameters()), "lr": lr}])
        losses = []
        for _ in range(steps):
            opt.zero_grad(set_to_none=True)
            loss = self.neg_log_marginal_likelihood(x, y)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        return torch.stack(losses).cpu().numpy()


# -- GP on flow features ---------------------------------------------------------
def flow_feature_fn(model):
    """Features from a MarScfFlow: encode with a zero log-det in x's dtype
    and no dequantisation, the final z flattened to (N, D)."""

    def feature_fn(x):
        logdet = torch.zeros((x.shape[0],), dtype=x.dtype, device=x.device)
        z, _ = model.encode(x, logdet)
        return z.reshape(z.shape[0], -1)

    return feature_fn


class FlowGP(nn.Module):
    """GP regression on flow-warped features: z = flow.encode(x) -> GP(z, y).

    The flow runs without dropout (the JAX package's encode with
    train=False): `fit` puts the module in eval mode."""

    def __init__(self, flow: nn.Module, gp: GPRegression):
        super().__init__()
        self.flow = flow
        self.gp = gp
        self.feature_fn = flow_feature_fn(flow)

    def joint_nlml(self, x, y):
        """The NLML as a function of the GP hyperparameters and every flow
        parameter: one backward gives the gradients of both."""
        return self.gp.neg_log_marginal_likelihood(self.feature_fn(x), y)

    def posterior(self, x_train, y_train, x_test):
        return self.gp.posterior(self.feature_fn(x_train), y_train,
                                 self.feature_fn(x_test))

    def fit(self, x, y, *, steps: int = 100, lr: float = 0.02,
            flow_lr: Optional[float] = None,
            train_flow: bool = True) -> np.ndarray:
        """Joint type-II maximum likelihood: Adam on the NLML through the GP
        hyperparameters (lr) and the flow parameters (flow_lr, default lr),
        in place. With train_flow=False the flow is left bit for bit as it
        was and its features, the same at every step, are computed once.
        Returns the NLML before each update."""
        self.eval()
        groups = [{"params": list(self.gp.parameters()), "lr": lr}]
        if train_flow:
            groups.append({"params": list(self.flow.parameters()),
                           "lr": lr if flow_lr is None else flow_lr})
        else:
            with torch.no_grad():
                z = self.feature_fn(x)
        opt = _adam(groups)
        losses = []
        for _ in range(steps):
            opt.zero_grad(set_to_none=True)
            loss = (self.joint_nlml(x, y) if train_flow
                    else self.gp.neg_log_marginal_likelihood(z, y))
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        return torch.stack(losses).cpu().numpy()
