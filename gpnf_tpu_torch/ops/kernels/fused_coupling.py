"""Affine coupling transform fused with its log-det reduction.

Counterpart of gpnf_tpu/ops/pallas/fused_coupling.py `fused_affine_forward`.
The CUDA kernel is gpnf_tpu_torch/csrc/fused_affine.cu (float32 and
float64); its header says what bounds it on the H100 and how it is laid
out. `fused_affine_plain` is the same function in plain PyTorch (the JAX
package's `_reference`, with log sigmoid as `F.logsigmoid`): the wrapper
runs it for CPU tensors, and the tests and chip_smoke.py hold the kernel
against it. The backward is the JAX package's closed form (`_bwd`), in
plain torch: the Pallas kernel has no backward kernel either.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _native

DTYPES = (torch.float32, torch.float64)


def fused_affine_plain(x2, shift, raw):
    """x2/shift/raw (B, D) -> (y, ldj) with y = shift + x2 * sigmoid(raw + 2)
    and ldj[b] = sum_d log sigmoid(raw[b, d] + 2)."""
    t = raw + 2.0
    return shift + x2 * torch.sigmoid(t), torch.sum(F.logsigmoid(t), dim=-1)


def _forward(x2, shift, raw):
    if all(t.device.type == "cpu" for t in (x2, shift, raw)):
        return fused_affine_plain(x2, shift, raw)
    device = _native.check_cuda_inputs("fused_affine_forward", dtypes=DTYPES,
                                       x2=x2, shift=shift, raw=raw)
    bsz, d = x2.shape
    y = torch.empty_like(x2)
    ldj = torch.empty((bsz,), dtype=x2.dtype, device=device)
    _native.launch("fused_affine", f"gpnf_fused_affine_{_native.SUFFIX[x2.dtype]}",
                   device, *(t.data_ptr() for t in (x2, shift, raw, y, ldj)),
                   bsz, d)
    fused_affine_forward.launches += 1
    return y, ldj


class _FusedAffine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, shift, raw):
        ctx.save_for_backward(x2, raw)
        return _forward(x2, shift, raw)

    @staticmethod
    def backward(ctx, gy, gldj):
        x2, raw = ctx.saved_tensors
        scale = torch.sigmoid(raw + 2.0)
        one_minus = 1.0 - scale
        gy = torch.zeros_like(x2) if gy is None else gy
        graw = gy * x2 * scale * one_minus
        if gldj is not None:
            graw = graw + gldj[:, None] * one_minus
        return gy * scale, gy, graw


def fused_affine_forward(x2, shift, raw):
    """(y, ldj) of the affine coupling, differentiable in every input. CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if x2.dim() != 2:
        raise ValueError(f"fused_affine_forward: x2 {tuple(x2.shape)} is not "
                         f"(B, D)")
    for name, t in (("shift", shift), ("raw", raw)):
        if t.shape != x2.shape:
            raise ValueError(f"fused_affine_forward: '{name}' has shape "
                             f"{tuple(t.shape)}, expected {tuple(x2.shape)}")
    return _FusedAffine.apply(x2, shift, raw)


fused_affine_forward.launches = 0
