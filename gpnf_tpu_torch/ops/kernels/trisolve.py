"""Blocked lower-triangular solve, L x = b or L^T x = b.

Counterpart of gpnf_tpu/ops/pallas/trisolve.py `tril_solve`. The CUDA
kernels are gpnf_tpu_torch/csrc/tril_solve.cu (float32 and float64); its
header says what bounds them on the H100 and how they are laid out. A
solve on the card is `tril_solve_device_launches(n, p)` device launches.
`tril_solve_plain` is the JAX package's CPU path (`_xla_tril_solve`:
128-row block substitution, each diagonal block inverted by Newton
doubling) in plain PyTorch: the wrapper runs it for CPU tensors, and the
tests and chip_smoke.py hold the kernels against it. The gradient is the
JAX package's `_solve_bwd`: one more solve (a kernel launch on the card)
for b_bar, and L_bar = -tril(b_bar x^T) (or -tril(x b_bar^T)) as a plain
product. Only the lower triangle of L is read.
"""
from __future__ import annotations

import torch

from . import _native

DTYPES = (torch.float32, torch.float64)
BLK = 128  # the plain version's block (the JAX package's BLK)
KERNEL_BS = 64  # the CUDA kernels' block (BS in csrc/tril_solve.cu)


def _newton_tril_inv(d):
    """Exact inverse of a lower-triangular (b, b) block by Newton doubling:
    the residual I - X L is nilpotent, so ceil(log2 b) steps end at zero."""
    b = d.shape[0]
    eye = torch.eye(b, dtype=d.dtype, device=d.device)
    x = torch.diag(1.0 / torch.diagonal(d))
    for _ in range(max((b - 1).bit_length(), 1)):
        x = x @ (2.0 * eye - d @ x)
    return x


def _pad_identity(l, n_to):
    """l (n, n) -> (n_to, n_to) with an identity block below-right."""
    n = l.shape[0]
    if n_to == n:
        return l
    out = torch.zeros((n_to, n_to), dtype=l.dtype, device=l.device)
    out[:n, :n] = l
    idx = torch.arange(n, n_to, device=l.device)
    out[idx, idx] = 1.0
    return out


def tril_solve_plain(l, b, *, trans: bool = False):
    """x with L x = b (or L^T x = b), b (n,) or (n, p), L lower-triangular:
    block substitution over 128-row blocks, padded with an identity."""
    n = l.shape[-1]
    vec = b.dim() == 1
    b2 = b[:, None] if vec else b
    n_p = -(-n // BLK) * BLK
    l = _pad_identity(torch.tril(l), n_p)
    if n_p != n:
        b2 = torch.cat([b2, b2.new_zeros((n_p - n, b2.shape[1]))])
    nb = n_p // BLK
    get = lambda i, j: l[i * BLK:(i + 1) * BLK, j * BLK:(j + 1) * BLK]
    blocks = [None] * nb
    for j in (range(nb) if not trans else range(nb - 1, -1, -1)):
        acc = b2[j * BLK:(j + 1) * BLK]
        inv = _newton_tril_inv(get(j, j))
        if not trans:
            for i in range(j):
                acc = acc - get(j, i) @ blocks[i]
            blocks[j] = inv @ acc
        else:
            for i in range(j + 1, nb):
                acc = acc - get(i, j).T @ blocks[i]
            blocks[j] = inv.T @ acc
    x = torch.cat(blocks)[:n]
    return x[:, 0] if vec else x


def tril_solve_device_launches(n, p):
    """Device launches of one solve on the card at any (n, p), the copy of
    b left out: the zero fill of the scratch and one sweep launch."""
    return 2


def tril_solve_scratch_words(n, p):
    """int32 words of the scratch of one solve, zeroed before the launch:
    the ticket counter and one ready flag per (64-row block, column tile);
    column tiles are 4 wide when p < 32, else 64."""
    return 1 + -(-n // KERNEL_BS) * -(-p // (4 if p < 32 else 64))


def _solve(l, b, trans: bool):
    """One solve with a 2-D right-hand side: the plain version for CPU
    tensors, else one kernel launch (counted)."""
    if l.device.type == "cpu" and b.device.type == "cpu":
        return tril_solve_plain(l, b, trans=trans)
    b = b.contiguous()
    device = _native.check_cuda_inputs("tril_solve", dtypes=DTYPES, l=l, b=b)
    n, p = b.shape
    x = b.clone()
    scratch = torch.zeros(tril_solve_scratch_words(n, p), dtype=torch.int32,
                          device=device)
    _native.launch("tril_solve", f"gpnf_tril_solve_{_native.SUFFIX[b.dtype]}",
                   device, l.data_ptr(), x.data_ptr(), scratch.data_ptr(), n,
                   p, int(trans))
    tril_solve.launches += 1
    return x


class _TrilSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, l, b, trans):
        x = _solve(l, b, trans)
        ctx.trans = trans
        ctx.save_for_backward(l, x)
        return x

    @staticmethod
    def backward(ctx, x_bar):
        l, x = ctx.saved_tensors
        b_bar = _solve(l, x_bar, not ctx.trans)
        l_bar = None
        if ctx.needs_input_grad[0]:
            l_bar = -torch.tril(b_bar @ x.T if not ctx.trans else x @ b_bar.T)
        return l_bar, b_bar, None


def tril_solve(l, b, *, trans: bool = False):
    """Solve L x = b (or L^T x = b) for lower-triangular L (n, n) and b (n,)
    or (n, p); differentiable in L and b. CPU tensors take the plain
    version; CUDA tensors launch the kernels or raise."""
    if l.dim() != 2 or l.shape[0] != l.shape[1]:
        raise ValueError(f"tril_solve: L {tuple(l.shape)} is not square")
    if b.dim() not in (1, 2) or b.shape[0] != l.shape[0]:
        raise ValueError(f"tril_solve: b {tuple(b.shape)} does not match L "
                         f"{tuple(l.shape)}")
    vec = b.dim() == 1
    x = _TrilSolve.apply(l, b[:, None] if vec else b, trans)
    return x[:, 0] if vec else x


tril_solve.launches = 0
