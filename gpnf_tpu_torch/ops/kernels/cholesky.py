"""Blocked lower Cholesky factorization with its two-solve gradient.

Counterpart of gpnf_tpu/ops/pallas/cholesky.py `cholesky_blocked`, which
dispatches to the Pallas kernels `_chol_kernel` and `_hbm_chol_kernel`. On
the card one set of CUDA kernels (gpnf_tpu_torch/csrc/cholesky.cu, float32
and float64; its header says what bounds them and how they are laid out)
serves every n, in `cholesky_device_launches(n)` launches. `cholesky_plain`
is the JAX package's CPU path (`_blocked_cholesky_xla`: 128-wide panels
factored by fused rank-2 steps, the trailing update as a product) in plain
PyTorch: the wrapper runs it for CPU tensors, and the tests and
chip_smoke.py hold the kernels against it.
Both leave the upper triangle zero and give NaN, without raising, for a
matrix that is not positive definite. Only the lower triangle of A is read.

The gradient is the JAX package's `_chol_bwd`: w = phi(L^T L_bar) as a
plain product, then two `tril_solve` calls with an n x n right-hand side
(kernel launches on the card), then the symmetrisation.
"""
from __future__ import annotations

import torch

from . import _native
from .trisolve import KERNEL_BS, _pad_identity, _solve

DTYPES = (torch.float32, torch.float64)
BLK = 128  # the plain version's panel width (the JAX package's BLK)


def _panel_cholesky(p):
    """Right-looking factorization of an (m, b) panel whose top b x b block
    is the symmetric diagonal block; columns advance in pairs (one fused
    rank-2 step each), as the JAX package's `_panel_cholesky`."""
    m, b = p.shape
    ridx = torch.arange(m, device=p.device)[:, None]
    cidx = torch.arange(b, device=p.device)[None, :]
    zero = p.new_zeros(())
    for k in range(0, b, 2):
        c0, c1 = p[:, k:k + 1], p[:, k + 1:k + 2]
        a, bb, cc = p[k, k], p[k + 1, k], p[k + 1, k + 1]
        p0 = torch.sqrt(a)
        i0 = 1.0 / p0
        l0 = torch.where(ridx > k, c0 * i0, zero)
        u0 = torch.where(cidx > k, p[k:k + 1] * i0, zero)
        u0k1 = bb * i0
        c1p = c1 - l0 * u0k1
        p1 = torch.sqrt(cc - u0k1 * u0k1)
        i1 = 1.0 / p1
        l1 = torch.where(ridx > k + 1, c1p * i1, zero)
        u1 = torch.where(cidx > k + 1, (p[k + 1:k + 2] - u0k1 * u0) * i1, zero)
        lcol0 = l0 + torch.where(ridx == k, p0, zero)
        lcol1 = l1 + torch.where(ridx == k + 1, p1, zero)
        p = p - l0 * u0 - l1 * u1
        p = torch.where(cidx == k, lcol0, torch.where(cidx == k + 1, lcol1, p))
    return p


def cholesky_plain(a):
    """Lower Cholesky factor of the symmetric (n, n) `a` (lower triangle
    read), padded to a multiple of 128 with an identity block."""
    n = a.shape[-1]
    n_p = -(-n // BLK) * BLK
    a = torch.tril(a)
    a = _pad_identity(a + torch.tril(a, -1).T, n_p)
    for j in range(n_p // BLK):
        s = j * BLK
        panel = torch.tril(_panel_cholesky(a[s:, s:s + BLK]))
        a = a.clone()
        a[s:, s:s + BLK] = panel
        if s + BLK < n_p:
            l21 = panel[BLK:]
            a[s + BLK:, s + BLK:] = a[s + BLK:, s + BLK:] - l21 @ l21.T
    return torch.tril(a)[:n, :n]


def cholesky_device_launches(n):
    """Kernel launches of one factorization of an (n, n) matrix on the
    card: the first diagonal step, then for each later 64-wide panel the
    panel product and the trailing update, which runs the next panel's
    diagonal step in one of its blocks (csrc/cholesky.cu)."""
    return 2 * -(-n // KERNEL_BS) - 1


def _phi(x):
    """tril with a halved diagonal: the Cholesky-VJP projection."""
    return torch.tril(x) - 0.5 * torch.diag(torch.diagonal(x))


def _forward(a):
    if a.device.type == "cpu":
        return cholesky_plain(a)
    device = _native.check_cuda_inputs("cholesky", dtypes=DTYPES, a=a)
    out = a.clone()
    inv = torch.empty((KERNEL_BS, KERNEL_BS), dtype=a.dtype, device=device)
    _native.launch("cholesky", f"gpnf_cholesky_{_native.SUFFIX[a.dtype]}",
                   device, out.data_ptr(), inv.data_ptr(), a.shape[0])
    cholesky.launches += 1
    return out


class _Cholesky(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a):
        l = _forward(a)
        ctx.save_for_backward(l)
        return l

    @staticmethod
    def backward(ctx, l_bar):
        (l,) = ctx.saved_tensors
        w = _phi(l.T @ l_bar)
        t = _solve(l, w, True)                    # L^-T w
        a_bar = _solve(l, t.T.contiguous(), True).T  # (L^-T t^T)^T = t L^-1
        return 0.5 * (a_bar + a_bar.T)


def cholesky(a):
    """Lower Cholesky factor of an SPD (n, n) matrix, differentiable. CPU
    tensors take the plain version; CUDA tensors launch the kernels or
    raise."""
    if a.dim() != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"cholesky: {tuple(a.shape)} is not a square matrix")
    return _Cholesky.apply(a)


cholesky.launches = 0
