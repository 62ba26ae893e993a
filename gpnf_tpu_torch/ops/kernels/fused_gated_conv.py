"""The fused GatedConv block of the coupling networks: concat-ELU -> 3x3
conv -> concat-ELU -> Dropout2d -> 1x1 GLU gate -> + x, as a chain of
tensor-core kernels.

Counterpart of gpnf_tpu/ops/pallas/fused_gated_conv.py (`_fwd_kernel`,
`_bwd_kernel`): gpnf_tpu_torch/csrc/fused_gated_conv.cu, whose header says
what bounds the kernels on the H100 and how they are laid out: every
product of the block (the conv, the gate, and in the backward dh, dx and
the two weight gradients) is one 3xTF32 implicit GEMM of one kernel
template, at any C. The public functions keep the JAX layout: x (B, H, W,
C) channel-last, w1 (3, 3, 2C, C) the 3x3 taps input-major, b1 (C,), wg
(2C, 2C) the gate input-major, bg (2C,), then the dropout rate and a (1,)
int32 seed on x's device. `gated_conv_plain` and `gated_conv_plain_bwd` are
the plain PyTorch versions, with the kernel's ELU (exp(z) - 1, as the
Pallas `_elu`; the unfused chain's F.elu uses expm1). The wrappers run them
for CPU tensors; CUDA tensors launch the kernels or raise.

Dropout2d: channel j (of 2C) of batch row b is kept when word (j & 3) of
Philox4x32-10 at counter (j >> 2, b, 0, 0) and key (seed, 1) is
`>= rate * 2^32`, and kept channels are scaled by 1 / (1 - rate): one keep
per (b, channel), constant over space, a pure function of the seed, so the
backward regenerates the forward's mask. `gated_conv_keep_plain` computes
the same bits in torch integer arithmetic. The JAX package's masks come
from the TPU's generator (or jax.random off the TPU) and cannot match.

Each product's tiles and splits of K are pure functions of the shape (the
source's `pick_tile` and `product_splits`), and split partials are added
in split order, so two calls give the same bits; `gated_conv_plan` asks
the source for a call's scratch and device launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _native
from .fused_attention import keep_threshold, philox4x32_10

# the pixels a call may take (fused_gated_conv.cu's kMaxPixels: pixel
# indices exact in a float)
GATED_CONV_MAX_PIXELS = 1 << 24


def gated_conv_plan(batch: int, height: int, width: int, c: int,
                    dropout: bool, backward: bool = False,
                    vec: bool = True):
    """(scratch floats, device launches) of one call, as the source's
    `gpnf_gated_conv_plan` computes them from the shape: the forward's
    scratch (h2, the dropout scales, the split products' partials) or the
    backward's `partial` (the scales, the partials); the launches are each
    product, a sum of each one whose K is split, and the table of dropout
    scales at rate > 0. Builds the library on first use."""
    floats, launches = ctypes.c_longlong(), ctypes.c_int()
    err = _native.load("fused_gated_conv").gpnf_gated_conv_plan(
        batch, height, width, c, int(dropout), int(vec), int(backward),
        ctypes.byref(floats), ctypes.byref(launches))
    if err != 0:
        raise ValueError(f"gpnf_gated_conv_plan: shape "
                         f"{(batch, height, width, c)} refused (CUDA error "
                         f"{err})")
    return floats.value, launches.value


def gated_conv_work(pixels: int, c: int, backward: bool = False):
    """(bytes, FLOP) of one call, the work its bound is taken from: x and
    out once (the backward also g and dx), the weights and biases once (the
    backward reads them and writes their gradients); 2 (9 2C C + 2C 2C)
    FLOP a pixel forward (the conv, the gate), three times that
    backward."""
    weights = 22 * c * c + 3 * c  # w1, b1, wg, bg
    ops = 2 * pixels * (9 * 2 * c * c + 4 * c * c)
    if backward:
        return 4 * (3 * pixels * c + 2 * weights), 3 * ops
    return 4 * (2 * pixels * c + weights), ops


def _vec(c: int, *tensors) -> bool:
    """The kernels' 16-byte path: C a multiple of 4 and every operand they
    copy on a 16-byte boundary (fresh scratch always is)."""
    return c % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def gated_conv_keep_plain(seed: torch.Tensor, batch: int, channels2: int,
                          rate: float) -> torch.Tensor:
    """Keep mask (B, 2C) of the kernels, on the seed's device."""
    dev = seed.device
    j = torch.arange(channels2, dtype=torch.int64, device=dev)
    b = torch.arange(batch, dtype=torch.int64, device=dev)[:, None]
    key = seed.to(torch.int64) & 0xFFFFFFFF
    words = torch.stack(torch.broadcast_tensors(
        *philox4x32_10(j >> 2, b, 0, 0, key, 1)), dim=-1)
    bits = torch.gather(words, -1, (j & 3).expand(batch, -1)[..., None])[..., 0]
    return bits >= keep_threshold(rate)


def _elu(z):
    return torch.where(z > 0, z, torch.exp(z) - 1.0)


def _delu(z):
    """elu'(z) = 1 for z > 0, else exp(z)."""
    return torch.where(z > 0, torch.ones_like(z), torch.exp(z))


def _concat_elu(x):
    return _elu(torch.cat([x, -x], dim=-1))


def _drop_scale(x, rate, seed):
    """(B, 1, 1, 2C) Dropout2d scale, 0 or 1 / (1 - rate); None at rate 0."""
    if rate == 0.0:
        return None
    keep = gated_conv_keep_plain(seed, x.shape[0], 2 * x.shape[3], rate)
    return torch.where(keep, 1.0 / (1.0 - rate), 0.0).to(x.dtype)[:, None,
                                                                 None, :]


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


def _forward_math(x, w1, b1, wg, bg, scale):
    """(h1, h, h2 dropped, a, sigmoid(g), out) of the block."""
    h1 = _concat_elu(x)
    w_oihw = w1.permute(3, 2, 0, 1)  # (C, 2C, 3, 3)
    h = _nhwc(F.conv2d(_nchw(h1), w_oihw, padding=1)) + b1
    h2 = _concat_elu(h)
    if scale is not None:
        h2 = h2 * scale
    a, g = torch.chunk(torch.matmul(h2, wg) + bg, 2, dim=-1)
    sig = torch.sigmoid(g)
    return h1, h, h2, a, sig, a * sig + x


def gated_conv_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                     wg: torch.Tensor, bg: torch.Tensor, rate: float = 0.0,
                     seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The block + residual, x (B, H, W, C) -> (B, H, W, C): the JAX
    `_reference` with the kernels' mask."""
    return _forward_math(x, w1, b1, wg, bg, _drop_scale(x, rate, seed))[-1]


def gated_conv_plain_bwd(x, w1, b1, wg, bg, g, rate: float = 0.0,
                         seed: Optional[torch.Tensor] = None):
    """(dx, dw1, db1, dwg, dbg) of `gated_conv_plain` for the cotangent g,
    by the formulas of the Pallas `_bwd_kernel`."""
    scale = _drop_scale(x, rate, seed)
    h1, h, h2, a, sig, _ = _forward_math(x, w1, b1, wg, bg, scale)
    c = x.shape[3]
    dg2 = torch.cat([g * sig, g * a * sig * (1.0 - sig)], dim=-1)
    flat = lambda t: t.reshape(-1, t.shape[-1])
    dwg = flat(h2).t() @ flat(dg2)
    dbg = flat(dg2).sum(0)
    dh2 = torch.matmul(dg2, wg.t())
    if scale is not None:
        dh2 = dh2 * scale
    dh = dh2[..., :c] * _delu(h) - dh2[..., c:] * _delu(-h)
    db1 = flat(dh).sum(0)
    w_oihw = w1.permute(3, 2, 0, 1)
    dw1 = torch.nn.grad.conv2d_weight(_nchw(h1), w_oihw.shape, _nchw(dh),
                                      padding=1).permute(2, 3, 1, 0)
    dh1 = _nhwc(F.conv_transpose2d(_nchw(dh), w_oihw, padding=1))
    dx = dh1[..., :c] * _delu(x) - dh1[..., c:] * _delu(-x) + g
    return dx, dw1, db1, dwg, dbg


def _validate(kernel, x, w1, b1, wg, bg, rate, seed):
    if x.dim() != 4:
        raise ValueError(f"{kernel}: x {tuple(x.shape)} is not (B, H, W, C)")
    c = x.shape[3]
    want = {"w1": (3, 3, 2 * c, c), "b1": (c,), "wg": (2 * c, 2 * c),
            "bg": (2 * c,)}
    for arg, t in (("w1", w1), ("b1", b1), ("wg", wg), ("bg", bg)):
        if tuple(t.shape) != want[arg]:
            raise ValueError(f"{kernel}: {arg} {tuple(t.shape)} is not "
                             f"{want[arg]} for C={c}")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"{kernel}: dropout rate {rate} is not in [0, 1)")
    if rate > 0.0 and (seed is None or tuple(seed.shape) != (1,)
                       or seed.dtype != torch.int32):
        raise ValueError(f"{kernel}: dropout needs a (1,) int32 seed tensor")


def _cuda_args(kernel, rate, seed, **tensors):
    """The kernels' own limits (float32, pixels), then device and layout;
    returns (device, seed pointer or None, threshold, keep scale)."""
    for arg, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{kernel}: '{arg}' has dtype {t.dtype}, the "
                            f"kernel takes float32 only")
    b, h, w, _ = tensors["x"].shape
    if b * h * w >= GATED_CONV_MAX_PIXELS:
        raise ValueError(f"{kernel}: {b * h * w} pixels, the kernels take "
                         f"fewer than {GATED_CONV_MAX_PIXELS}")
    device = _native.check_cuda_inputs(kernel, **tensors)
    if rate == 0.0:
        return device, None, 0, 1.0
    if seed.device != device:
        raise ValueError(f"{kernel}: seed is on {seed.device}, expected "
                         f"{device}")
    return device, seed.data_ptr(), keep_threshold(rate), 1.0 / (1.0 - rate)


def _on_cpu(*tensors):
    return all(t.device.type == "cpu" for t in tensors)


def _forward(x, w1, b1, wg, bg, rate, seed):
    if _on_cpu(x, w1, b1, wg, bg):
        return gated_conv_plain(x, w1, b1, wg, bg, rate, seed)
    device, seed_ptr, threshold, scale = _cuda_args(
        "fused_gated_conv", rate, seed, x=x, w1=w1, b1=b1, wg=wg, bg=bg)
    out = torch.empty_like(x)
    b, h, w, c = x.shape
    # h2 (B, H, W, 2C) between the conv and the gate, the dropout scales,
    # the split products' partials
    floats, _ = gated_conv_plan(b, h, w, c, rate > 0.0, False,
                                _vec(c, x, w1, wg))
    scratch = torch.empty(floats, dtype=x.dtype, device=device)
    _native.launch("fused_gated_conv", "gpnf_gated_conv_fwd", device,
                   seed_ptr, x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                   wg.data_ptr(), bg.data_ptr(), out.data_ptr(),
                   scratch.data_ptr(), b, h, w, c, threshold, scale, floats)
    fused_gated_conv.launches += 1
    return out


def fused_gated_conv_bwd(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                         wg: torch.Tensor, bg: torch.Tensor, g: torch.Tensor,
                         rate: float = 0.0,
                         seed: Optional[torch.Tensor] = None):
    """(dx, dw1, db1, dwg, dbg) of `fused_gated_conv` for the cotangent g,
    the forward's mask regenerated from `seed`. CPU tensors take the plain
    version; CUDA tensors launch the kernels (one call, several launches) or
    raise."""
    _validate("fused_gated_conv_bwd", x, w1, b1, wg, bg, rate, seed)
    if g.shape != x.shape:
        raise ValueError(f"fused_gated_conv_bwd: g {tuple(g.shape)} is not "
                         f"x's {tuple(x.shape)}")
    if _on_cpu(x, w1, b1, wg, bg, g):
        return gated_conv_plain_bwd(x, w1, b1, wg, bg, g, rate, seed)
    device, seed_ptr, threshold, scale = _cuda_args(
        "fused_gated_conv_bwd", rate, seed, x=x, w1=w1, b1=b1, wg=wg, bg=bg,
        g=g)
    b, h, w, c = x.shape
    empty = lambda *shape: torch.empty(shape, dtype=x.dtype, device=device)
    dx, dw1, db1, dwg, dbg = (torch.empty_like(t) for t in (x, w1, b1, wg, bg))
    # h, then dh over it; dG2; h2; the dropout scales and the partials
    hdh, dg2, h2 = empty(b, h, w, c), empty(b, h, w, 2 * c), empty(b, h, w,
                                                                   2 * c)
    floats, _ = gated_conv_plan(b, h, w, c, rate > 0.0, True,
                                _vec(c, x, w1, wg))
    partial = empty(floats)
    _native.launch("fused_gated_conv", "gpnf_gated_conv_bwd", device,
                   seed_ptr, *(t.data_ptr() for t in (
                       x, w1, b1, wg, bg, g, dx, dw1, db1, dwg, dbg, hdh, dg2,
                       h2, partial)), b, h, w, c, threshold, scale, floats)
    fused_gated_conv_bwd.launches += 1
    return dx, dw1, db1, dwg, dbg


class _GatedConv(torch.autograd.Function):
    """Saves (x, w1, b1, wg, bg, seed), the residuals of the JAX package's
    custom VJP: the chain and the mask are recomputed in the backward."""

    @staticmethod
    def forward(ctx, x, w1, b1, wg, bg, seed, rate):
        ctx.save_for_backward(x, w1, b1, wg, bg, seed)
        ctx.rate = rate
        return _forward(x, w1, b1, wg, bg, rate, seed)

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, wg, bg, seed = ctx.saved_tensors
        grads = fused_gated_conv_bwd(x, w1, b1, wg, bg, g.contiguous(),
                                     ctx.rate, seed)
        return (*grads, None, None)


def fused_gated_conv(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                     wg: torch.Tensor, bg: torch.Tensor, rate: float = 0.0,
                     seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GatedConv block + residual, x (B, H, W, C) -> (B, H, W, C), with
    Dropout2d at `rate` from `seed` (a (1,) int32 tensor on x's device,
    read only when rate > 0). Differentiable in x and every weight and
    bias. CPU tensors take the plain versions; CUDA tensors launch the
    kernels or raise (anything but float32)."""
    _validate("fused_gated_conv", x, w1, b1, wg, bg, rate, seed)
    return _GatedConv.apply(x, w1, b1, wg, bg, seed, rate)


fused_gated_conv.launches = 0
fused_gated_conv_bwd.launches = 0
