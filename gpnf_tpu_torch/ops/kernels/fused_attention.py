"""Multi-head attention with the qkv projection inside the kernel.

Counterpart of gpnf_tpu/ops/pallas/fused_attention.py `fused_attention_proj`
(forward, dropout rate 0). The CUDA kernel is
gpnf_tpu_torch/csrc/fused_attention_proj.cu; its header says what bounds it
on the H100 and how it is laid out. `attention_proj_plain` is the same
function in plain PyTorch: the wrapper runs it for CPU tensors, and the
tests and chip_smoke.py hold the kernel against it.

Not yet ported: dropout inside the kernel (rate > 0, training) and
`fused_attention_long` (S > 512, the 64-px path).
"""
from __future__ import annotations

import torch

from . import _native

MAX_S = 512  # above this the JAX package switches to fused_attention_long
HEAD_DIMS = (4, 8, 16, 24, 32, 48, 64)  # Dh values the kernel is built for


def attention_proj_plain(seq: torch.Tensor, w: torch.Tensor,
                         num_heads: int) -> torch.Tensor:
    """seq (B, S, C), w (3C, C) with rows [k | v | q] -> (B, S, C)."""
    b, s, c = seq.shape
    dh = c // num_heads
    qkv = torch.matmul(seq, w.t())

    def heads(t):
        return t.reshape(b, s, num_heads, dh).transpose(1, 2)

    k, v, q = (heads(t) for t in qkv.split(c, dim=-1))
    p = torch.softmax(torch.matmul(q * dh ** -0.5, k.transpose(-1, -2)), -1)
    return torch.matmul(p, v).transpose(1, 2).reshape(b, s, c)


def fused_attention_proj(seq: torch.Tensor, w: torch.Tensor, num_heads: int,
                         rate: float = 0.0) -> torch.Tensor:
    """softmax(q k^T / sqrt(Dh)) v over `num_heads` heads, [k|v|q] = seq w^T.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if rate > 0.0:
        raise NotImplementedError(
            "fused_attention_proj: dropout (rate > 0) is not ported yet")
    if seq.dim() != 3 or w.shape != (3 * seq.shape[2], seq.shape[2]):
        raise ValueError(f"fused_attention_proj: seq {tuple(seq.shape)} and "
                         f"w {tuple(w.shape)} are not (B, S, C) and (3C, C)")
    b, s, c = seq.shape
    if c % num_heads:
        raise ValueError(f"fused_attention_proj: C={c} is not a multiple of "
                         f"{num_heads} heads")
    if seq.device.type == "cpu" and w.device.type == "cpu":
        return attention_proj_plain(seq, w, num_heads)
    device = _native.check_cuda_inputs("fused_attention_proj", seq=seq, w=w)
    if s > MAX_S:
        raise NotImplementedError(
            f"fused_attention_proj: S={s} > {MAX_S} is fused_attention_long's "
            f"range, not ported yet")
    if c // num_heads not in HEAD_DIMS:
        raise ValueError(f"fused_attention_proj: head width {c // num_heads} "
                         f"not in {HEAD_DIMS}")
    out = torch.empty_like(seq)
    _native.launch("fused_attention_proj", "gpnf_attention_proj_fwd", device,
                   seq.data_ptr(), w.data_ptr(), out.data_ptr(), b, s, c,
                   num_heads)
    fused_attention_proj.launches += 1
    return out


fused_attention_proj.launches = 0
