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

`trailing_precision="high"` is `pallas_cholesky_hbm`'s mode of the same
name (`_hbm_chol_kernel`, its trailing GEMM as `_dot_bf16x3`): the
contribution of a factor column to an entry is three bf16 products, hi hi
+ hi lo + lo hi summed in float32 (`bf16x3_plain`), exactly where the
column's P-block precedes the entry's column's (P = `panel_width`, by
default `hbm_panel_width(n)`, as in the JAX package), and full precision
everywhere else: over the port's 64-wide panels, panel j's update of tile
column J is bf16x3 iff floor(64 j / P) < floor(64 J / P). On the card the
kernels of "highest" with a bf16x3 branch on the tensor cores in the
trailing launch (csrc/cholesky.cu, `cholesky_high` counts the calls); on
the CPU the plain version of that rule (`cholesky_plain(a, "high", P)`,
right-looking over 64-wide panels). The GP paths keep the default.

The gradient is the JAX package's `_chol_bwd`: w = phi(L^T L_bar) as a
plain product, then two `tril_solve` calls with an n x n right-hand side
(kernel launches on the card), then the symmetrisation; the same for both
precisions.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _native
from .fused_attention import LaunchCount
from .trisolve import KERNEL_BS, _pad_identity, _solve

DTYPES = (torch.float32, torch.float64)
BLK = 128  # the plain version's panel width (the JAX package's BLK)
TRAILING_PRECISIONS = ("highest", "high")


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


def hbm_panel_width(n):
    """The JAX package's `_hbm_panel_width`: the "high" mode's default P."""
    if n <= 4096:
        return 256
    if n <= 8192:
        return 128
    return 64


def _panel_width(trailing_precision, panel_width, n):
    """P of the "high" mode (`panel_width`, or `hbm_panel_width(n)` where it
    is None), None for "highest"; raises for any other precision, for a P
    that is not a positive multiple of 64, and for a panel width given to
    "highest", whose factorization has none."""
    if trailing_precision not in TRAILING_PRECISIONS:
        raise ValueError(f"cholesky: trailing_precision "
                         f"{trailing_precision!r} is not one of "
                         f"{TRAILING_PRECISIONS}")
    if trailing_precision == "highest":
        if panel_width is not None:
            raise ValueError("cholesky: panel_width is the \"high\" "
                             "mode's; \"highest\" takes none")
        return None
    p = hbm_panel_width(n) if panel_width is None else panel_width
    if not isinstance(p, int) or p <= 0 or p % KERNEL_BS:
        raise ValueError(f"cholesky: panel width {p!r} is not a positive "
                         f"multiple of {KERNEL_BS}")
    return p


def bf16_split(x):
    """(hi, lo) bf16 halves of x as the JAX package's `_dot_bf16x3` splits
    it: hi = bf16(x), lo = bf16(x - hi), both rounded to nearest even, x -
    hi taken in x's dtype; float64 goes to bf16 through float32, as the JAX
    and torch casts do (1 + 2^-8 + 2^-30 becomes 1, not 1 + 2^-7)."""
    hi = x.float().to(torch.bfloat16)
    return hi, (x - hi.to(x.dtype)).float().to(torch.bfloat16)


def bf16x3_plain(x, y):
    """x @ y as the JAX package's `_dot_bf16x3`: the three bf16 products
    hi hi, hi lo and lo hi, each exact and summed in float32, added as
    (hh + hl) + lh; float32 whatever x's dtype."""
    (xh, xl), (yh, yl) = bf16_split(x), bf16_split(y)

    def dot(u, v):
        return torch.matmul(u.float(), v.float())

    return (dot(xh, yh) + dot(xh, yl)) + dot(xl, yh)


def _factor_tile(d):
    """The lower factor of the (b, b) tile whose lower triangle is d's
    (upper triangle zero), b <= 64: `_panel_cholesky` on the symmetric
    tile padded to 64 with an identity block."""
    b = d.shape[0]
    sym = _pad_identity(torch.tril(d) + torch.tril(d, -1).T, KERNEL_BS)
    return torch.tril(_panel_cholesky(sym))[:b, :b]


def _trailing_high(a, panel, s, p):
    """In place: the lower part of a[s:, s:] -= panel[s:] panel[s:]^T, the
    columns before the end of the P-block of `panel`'s columns (those of
    the panel that ends at s) as plain products, the later ones as
    `bf16x3_plain`, subtracted in a's dtype."""
    n = a.shape[0]
    mid = min(n, ((s - KERNEL_BS) // p + 1) * p)
    if s < mid:
        a[s:, s:mid] -= panel[s:] @ panel[s:mid].T
    if mid < n:
        a[mid:, mid:] -= bf16x3_plain(panel[mid:], panel[mid:].T).to(a.dtype)


def _cholesky_high_plain(a, p):
    """The "high" factorization: right-looking over 64-wide panels of the
    lower triangle, padded to a multiple of 64 with an identity block, each
    panel factored by `_panel_cholesky` (its diagonal tile symmetrised from
    the lower triangle), then the trailing update of `_trailing_high`."""
    n = a.shape[-1]
    n_p = -(-n // KERNEL_BS) * KERNEL_BS
    a = _pad_identity(torch.tril(a), n_p)
    for s in range(0, n_p, KERNEL_BS):
        e = s + KERNEL_BS
        d = a[s:e, s:e]
        a[s:, s:e] = torch.tril(_panel_cholesky(torch.cat(
            [torch.tril(d) + torch.tril(d, -1).T, a[e:, s:e]])))
        if e < n_p:
            _trailing_high(a, a[:, s:e], e, p)
    return torch.tril(a)[:n, :n]


def cholesky_plain(a, trailing_precision="highest", panel_width=None):
    """Lower Cholesky factor of the symmetric (n, n) `a` (lower triangle
    read). "highest": 128-wide panels, `a` padded to a multiple of 128 with
    an identity block (the JAX package's `_blocked_cholesky_xla`); "high":
    `_cholesky_high_plain` at P = `panel_width` (`_panel_width`)."""
    p = _panel_width(trailing_precision, panel_width, a.shape[-1])
    if p is not None:
        return _cholesky_high_plain(a, p)
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


def cholesky_high_flops(n, p):
    """(bf16x3, other): the FLOPs of one "high" factorization at panel
    width p whose trailing products run in bf16x3 (each counted once, as
    the float32 product it stands for: the tensor cores run three), and
    the rest of the n^3 / 3, on the SIMT units. A tile column's product
    counts the lower entries it needs, 2 x 64 FLOPs each."""
    nb = -(-n // KERNEL_BS)
    cross = 0
    for j in range(nb - 1):
        for big_j in range(j + 1, nb):
            if (j * KERNEL_BS) // p < (big_j * KERNEL_BS) // p:
                rows = n - big_j * KERNEL_BS
                cols = min(KERNEL_BS, rows)
                cross += 2 * KERNEL_BS * (cols * rows - cols * (cols - 1) // 2)
    return cross, n ** 3 / 3 - cross


def _phi(x):
    """tril with a halved diagonal: the Cholesky-VJP projection."""
    return torch.tril(x) - 0.5 * torch.diag(torch.diagonal(x))


def _forward(a, p):
    if a.device.type == "cpu":
        return (cholesky_plain(a) if p is None
                else _cholesky_high_plain(a, p))
    device = _native.check_cuda_inputs("cholesky", dtypes=DTYPES, a=a)
    out = a.clone()
    inv = torch.empty((KERNEL_BS, KERNEL_BS), dtype=a.dtype, device=device)
    suffix = _native.SUFFIX[a.dtype]
    if p is None:
        _native.launch("cholesky", f"gpnf_cholesky_{suffix}", device,
                       out.data_ptr(), inv.data_ptr(), a.shape[0])
    else:
        _native.launch("cholesky", f"gpnf_cholesky_high_{suffix}", device,
                       out.data_ptr(), inv.data_ptr(), a.shape[0], p)
        cholesky_high.launches += 1
    cholesky.launches += 1
    return out


class _Cholesky(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, p):
        l = _forward(a, p)
        ctx.save_for_backward(l)
        return l

    @staticmethod
    def backward(ctx, l_bar):
        (l,) = ctx.saved_tensors
        w = _phi(l.T @ l_bar)
        t = _solve(l, w, True)                    # L^-T w
        a_bar = _solve(l, t.T.contiguous(), True).T  # (L^-T t^T)^T = t L^-1
        return 0.5 * (a_bar + a_bar.T), None


def _check_square(kernel, a):
    if a.dim() != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"{kernel}: {tuple(a.shape)} is not a square matrix")


def cholesky(a, trailing_precision="highest",
             panel_width: Optional[int] = None):
    """Lower Cholesky factor of an SPD (n, n) matrix, differentiable;
    `trailing_precision` "highest" or "high" at `panel_width`
    (`_panel_width`), as `pallas_cholesky_hbm`'s keywords. CPU tensors
    take the plain version; CUDA tensors launch the kernels or raise."""
    _check_square("cholesky", a)
    return _Cholesky.apply(a, _panel_width(trailing_precision, panel_width,
                                           a.shape[0]))


def trailing_high_plain(a, j, panel_width):
    """The plain version of `trailing_high`: a copy of `a` whose lower part
    of rows and columns from s = 64 (j + 1) takes the "high" update of
    panel j (columns 64 j .. 64 j + 63 of `a`, rows from s), then whose
    tile at (s, s) is replaced by its lower factor."""
    n = a.shape[0]
    s = KERNEL_BS * (j + 1)
    out = a.clone()
    _trailing_high(out, a[:, s - KERNEL_BS:s], s, panel_width)
    e = min(n, s + KERNEL_BS)
    out[s:e, s:e] = _factor_tile(out[s:e, s:e])
    return out


def trailing_high(a, j, panel_width):
    """One launch of the "high" trailing kernel for panel j on a copy of
    the (n, n) `a` (0 <= j, 64 (j + 1) < n, panel_width a positive multiple
    of 64): the bf16x3 products of the trailing update alone, held against
    `trailing_high_plain`. A test entry, on no path of the system and
    counted on no wrapper; CPU tensors take the plain version."""
    _check_square("cholesky_trailing_high", a)
    n = a.shape[0]
    _panel_width("high", panel_width, n)
    if not 0 <= j or KERNEL_BS * (j + 1) >= n:
        raise ValueError(f"cholesky_trailing_high: panel {j} has no "
                         f"trailing matrix at n={n}")
    if a.device.type == "cpu":
        return trailing_high_plain(a, j, panel_width)
    device = _native.check_cuda_inputs("cholesky_trailing_high",
                                       dtypes=DTYPES, a=a)
    out = a.clone()
    inv = torch.empty((KERNEL_BS, KERNEL_BS), dtype=a.dtype, device=device)
    _native.launch("cholesky",
                   f"gpnf_cholesky_trailing_high_{_native.SUFFIX[a.dtype]}",
                   device, out.data_ptr(), inv.data_ptr(), n, j, panel_width)
    return out


cholesky.launches = 0
# the calls of `cholesky` with trailing_precision="high" on the card (each
# also counted on `cholesky`): no path of the system makes one
cholesky_high = LaunchCount("cholesky_high")
