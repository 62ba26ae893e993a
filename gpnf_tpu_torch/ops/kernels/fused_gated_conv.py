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

bfloat16 (MarScfConfig(compute_dtype="bfloat16", fused_gated_conv=True)):
every operand bf16, the same six products with bf16 operands and float32
sums, rounded where the Pallas `_forward_math` and `_bwd_kernel` round on
bf16 (the source's header lists the points); the weight and bias
gradients are float32, as `_bwd_kernel` writes them, and the autograd
function rounds them to the weights' dtype, as `_vjp_bwd` does. The plain
bf16 versions take each product in float32 on the bf16 values and round
it where the Pallas source does. A bf16 call also counts a launch on
`fused_gated_conv_bf16` / `fused_gated_conv_bwd_bf16`, so that a step can
show it ran no float32 gated-conv kernel.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import _native
from .fused_attention import (LaunchCount, bf16_scale, keep_threshold,
                              philox4x32_10)

BF16 = torch.bfloat16

# the pixels a call may take (fused_gated_conv.cu's kMaxPixels: pixel
# indices exact in a float)
GATED_CONV_MAX_PIXELS = 1 << 24


def gated_conv_plan(batch: int, height: int, width: int, c: int,
                    dropout: bool, backward: bool = False,
                    vec: bool = True, dtype: torch.dtype = torch.float32):
    """(scratch floats, device launches) of one call, as the source's
    `gpnf_gated_conv_plan` computes them from the shape: the forward's
    scratch (h2, the dropout scales, the split products' partials) or the
    backward's `partial` (the scales, the partials; in bf16 also db1's
    row-range sums), in 4-byte words (a bf16 h2 takes half as many); the
    launches are each product, a sum of each one whose K is split, the
    table of dropout scales at rate > 0, and in a bf16 backward db1's two.
    Builds the library on first use."""
    floats, launches = ctypes.c_longlong(), ctypes.c_int()
    err = _native.load("fused_gated_conv").gpnf_gated_conv_plan(
        batch, height, width, c, int(dropout), int(vec), int(backward),
        int(dtype == BF16), ctypes.byref(floats), ctypes.byref(launches))
    if err != 0:
        raise ValueError(f"gpnf_gated_conv_plan: shape "
                         f"{(batch, height, width, c)} refused (CUDA error "
                         f"{err})")
    return floats.value, launches.value


def gated_conv_work(pixels: int, c: int, backward: bool = False,
                    dtype: torch.dtype = torch.float32):
    """(bytes, FLOP) of one call, the work its bound is taken from: x and
    out once (the backward also g and dx), the weights and biases once (the
    backward reads them and writes their gradients, in float32), in the
    call's dtype; 2 (9 2C C + 2C 2C) FLOP a pixel forward (the conv, the
    gate), three times that backward."""
    size = torch.empty((), dtype=dtype).element_size()
    weights = 22 * c * c + 3 * c  # w1, b1, wg, bg
    ops = 2 * pixels * (9 * 2 * c * c + 4 * c * c)
    if backward:
        return size * (3 * pixels * c + weights) + 4 * weights, 3 * ops
    return size * (2 * pixels * c + weights), ops


def _vec(c: int, *tensors) -> bool:
    """The kernels' 16-byte path: C a multiple of 4 (bf16: 8) and every
    operand they copy on a 16-byte boundary (fresh scratch always is)."""
    per = 8 if tensors[0].dtype == BF16 else 4
    return c % per == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


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


def _concat_elu_bf16(x, rounded=True):
    """The Pallas `_elu` on bf16: in float32, rounded to bf16."""
    z = torch.cat([x, -x], dim=-1).float()
    e = torch.where(z > 0, z, torch.exp(z) - 1.0)
    return e.to(BF16) if rounded else e


def _forward_math_bf16(x, w1, b1, wg, bg, scale, moved=()):
    """`_forward_math` on bf16 operands, rounded where the Pallas
    `_forward_math` rounds: h1 and h2 (the concat-ELUs), the conv's float32
    sums then + b1 (twice), the dropped h2 (a bf16 product), the gate's
    float32 sums then + bg (twice); sigmoid and a sig + x in float32, out
    rounded once. Each product is float32 on the bf16 values. `moved`
    (GATED_CONV_MOVED) leaves h1 unrounded or rounds h once."""
    h1 = _concat_elu_bf16(x, "h1_unrounded" not in moved)
    w_oihw = w1.float().permute(3, 2, 0, 1)
    h = _nhwc(F.conv2d(_nchw(h1.float()), w_oihw, padding=1))
    h = ((h + b1.float()).to(BF16) if "h_rounded_once" in moved
         else h.to(BF16) + b1)
    h2 = _concat_elu_bf16(h)
    if scale is not None:
        h2 = h2 * scale
    g = torch.matmul(h2.float(), wg.float()).to(BF16) + bg
    a, b = torch.chunk(g, 2, dim=-1)
    sig = torch.sigmoid(b.float())
    return h1, h, h2, a, sig, (a.float() * sig + x.float()).to(BF16)


def gated_conv_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                     wg: torch.Tensor, bg: torch.Tensor, rate: float = 0.0,
                     seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The block + residual, x (B, H, W, C) -> (B, H, W, C): the JAX
    `_reference` with the kernels' mask; on bf16 the Pallas `_fwd_kernel`'s
    roundings."""
    math_ = _forward_math_bf16 if x.dtype == BF16 else _forward_math
    return math_(x, w1, b1, wg, bg, _drop_scale(x, rate, seed))[-1]


# The plain bf16 versions with one rounding point moved, or one split's
# pixels left out of the weight and bias gradients (`moved=`): faults that
# the bars must catch (`gated_conv_bf16_readings`).
GATED_CONV_MOVED = ("h1_unrounded", "h_rounded_once", "dh2_unrounded",
                    "db1_from_rounded_dh", "split_dropped")
GATED_CONV_RESULTS = ("out", "dx", "dw1", "db1", "dwg", "dbg")
# The weight and bias gradients' bars, in units of the root sum of squares
# of their P terms' largest bf16 rounding errors, 2^-8 (sum_p (a_p
# b_p)^2)^1/2: each element within GATED_CONV_WGRAD_BAR units, and the
# root mean square over each gradient within GATED_CONV_WGRAD_RMS. A term
# moves where a bf16 operand of it rounds the other way after a float32
# sum in another order, a few terms in a thousand: on an H100 the sound
# kernels read up to 1.6 units in one element (C 512) and at most 0.09 in
# rms. A rounding point moved at every pixel moves each term by about a
# third of its largest error: 0.36 or more in rms, while one element may
# read under 1. A split's partial dropped reads hundreds. Set from those
# readings (PERF.md §6).
GATED_CONV_WGRAD_BAR = 4.0
GATED_CONV_WGRAD_RMS = 0.18
# The share of out's and of dx's bf16 values that may differ from the
# plain version's: out the bf16 training tests' 5% (`_held`); dx 10%, since
# each dx sums 9C values of bf16(dh), any of which may round the other way
# (at C 512 the sound kernels differ in up to 5.9% of dx on an H100, the
# kernel's tile order emulated on the CPU in 4.9%; a moved rounding point
# in 11% or more). PERF.md §6.
GATED_CONV_BF16_SHARE = {"out": 0.05, "dx": 0.10}


def _bwd_terms_bf16(x, w1, b1, wg, bg, g, scale, moved=()):
    """The bf16 backward's operands and results: `_bwd_kernel` on bf16
    operands, dG2 rounded, dh2 = (dG2 wg^T) s rounded, dh in float32 (db1
    its unrounded sum), bf16(dh) into dw1 and the transposed conv, dx in
    float32 rounded once; the weight and bias gradients float32. `moved`:
    GATED_CONV_MOVED (split_dropped: the weight and bias gradients without
    the last eighth of the pixels)."""
    h1, h, h2, a, sig, out = _forward_math_bf16(x, w1, b1, wg, bg, scale,
                                                moved)
    c = x.shape[3]
    gf = g.float()
    dg2 = torch.cat([gf * sig, gf * a.float() * sig * (1.0 - sig)],
                    dim=-1).to(BF16)
    flat = lambda t: t.reshape(-1, t.shape[-1]).float()
    dh2 = torch.matmul(dg2.float(), wg.float().t())
    if scale is not None:
        dh2 = dh2 * scale.float()
    if "dh2_unrounded" not in moved:
        dh2 = dh2.to(BF16).float()
    hf = h.float()
    dh = dh2[..., :c] * _delu(hf) - dh2[..., c:] * _delu(-hf)
    dh_c = dh.to(BF16).float()
    w_oihw = w1.float().permute(3, 2, 0, 1)
    dh1 = _nhwc(F.conv_transpose2d(_nchw(dh_c), w_oihw, padding=1))
    xf = x.float()
    dx = dh1[..., :c] * _delu(xf) - dh1[..., c:] * _delu(-xf) + gf
    dh_b = dh_c if "db1_from_rounded_dh" in moved else dh
    wdh, wdg = dh_c, dg2.float()
    if "split_dropped" in moved:
        pixels = x.numel() // c
        keep = (torch.arange(pixels, device=x.device) < pixels - pixels // 8
                ).reshape(*x.shape[:3], 1)
        wdh, wdg, dh_b = wdh * keep, wdg * keep, dh_b * keep
    dw1 = torch.nn.grad.conv2d_weight(_nchw(h1.float()), w_oihw.shape,
                                      _nchw(wdh), padding=1).permute(
                                          2, 3, 1, 0)
    return dict(out=out, h1=h1, h2=h2, dg2=dg2, dh=dh, dh_c=dh_c,
                dx=dx.to(BF16), dw1=dw1, db1=flat(dh_b).sum(0),
                dwg=flat(h2).t() @ flat(wdg), dbg=flat(wdg).sum(0))


def _bf16_bars(t, x, w1, wg):
    """(bars, norms) from the sound plain bf16 terms t. bars {out, dx, dw1,
    db1, dwg, dbg}: out and dx one bf16 ulp of the largest |plain| plus the
    float32 spread of their last product (K 2^-24 max sum_k |a_k b_k|: the
    gate's, K = 2C; the transposed conv's, K = 9C); each weight and bias
    gradient, element by element, GATED_CONV_WGRAD_BAR 2^-8 (sum_p (a_p
    b_p)^2)^1/2 over its P terms (and GATED_CONV_WGRAD_RMS in root mean
    square, which `gated_conv_bf16_readings` checks). norms {dw1, db1, dwg, dbg: (sum_p |a_p
    b_p|, (sum_p (a_p b_p)^2)^1/2)} (a: h1, 1, h2, 1; b: bf16(dh), dh, dG2,
    dG2)."""
    c = x.shape[3]
    top_ulp = lambda v: 2.0 ** (math.floor(math.log2(max(
        float(v.float().abs().max()), 2.0 ** -126))) - 7)
    flat = lambda v: v.reshape(-1, v.shape[-1]).float().abs()
    w_oihw = w1.float().abs().permute(3, 2, 0, 1)
    gate_mass = float((flat(t["h2"]) @ wg.float().abs()).max())
    dx_mass = float(F.conv_transpose2d(_nchw(t["dh_c"].abs()), w_oihw,
                                       padding=1).max())
    sums = {}
    for p in (1, 2):
        h1, dh_c = (_nchw(v.float().abs() ** p) for v in (t["h1"],
                                                          t["dh_c"]))
        h2, dg2 = flat(t["h2"]) ** p, flat(t["dg2"]) ** p
        sums[p] = {"dw1": torch.nn.grad.conv2d_weight(
                       h1, w_oihw.shape, dh_c, padding=1).permute(2, 3, 1, 0),
                   "db1": (flat(t["dh"]) ** p).sum(0), "dwg": h2.t() @ dg2,
                   "dbg": dg2.sum(0)}
    norms = {k: (sums[1][k], sums[2][k].sqrt()) for k in sums[1]}
    bars = {"out": top_ulp(t["out"]) + 2 * c * 2.0 ** -24 * gate_mass,
            "dx": top_ulp(t["dx"]) + 9 * c * 2.0 ** -24 * dx_mass,
            **{k: GATED_CONV_WGRAD_BAR * 2.0 ** -8 * rss
               for k, (_, rss) in norms.items()}}
    return bars, norms


def gated_conv_bf16_readings(got, x, w1, b1, wg, bg, g, rate: float = 0.0,
                             seed: Optional[torch.Tensor] = None,
                             moved=()):
    """How far a bf16 kernel's results `got` (GATED_CONV_RESULTS) are from
    the plain bf16 versions on the same inputs, those with `moved`
    (GATED_CONV_MOVED) if given: {"held": every result within its bar
    (`_bf16_bars`, from the sound plain versions), at most the share
    GATED_CONV_BF16_SHARE of out's and of dx's values differing, and each
    weight gradient's "rms_over_rss" within GATED_CONV_WGRAD_RMS; and for
    each result "max_abs", "over_bar" (the worst |diff| / bar); for out
    and dx "share", the share of values that differ; for the weight and
    bias gradients the worst |diff| over P 2^-24 sum_p |a_p b_p| (their
    sums' spread, "over_spread"), over sum_p |a_p b_p| ("over_mass"), over
    2^-8 (sum_p (a_p b_p)^2)^1/2 ("over_rss") and that ratio's root mean
    square over the gradient ("rms_over_rss")}."""
    scale = _drop_scale(x, rate, seed)
    sound = _bwd_terms_bf16(x, w1, b1, wg, bg, g, scale)
    want = (_bwd_terms_bf16(x, w1, b1, wg, bg, g, scale, moved) if moved
            else sound)
    bars, norms = _bf16_bars(sound, x, w1, wg)
    pixels = x.numel() // x.shape[3]
    tiny = 2.0 ** -126
    worst = lambda d, unit: float((d / torch.as_tensor(unit).clamp_min(
        tiny)).max())
    out = {}
    for name, a in zip(GATED_CONV_RESULTS, got):
        diff = (a.float() - want[name].float()).abs()
        r = {"max_abs": float(diff.max()), "over_bar": worst(diff,
                                                             bars[name])}
        if name in ("out", "dx"):
            r["share"] = float((diff > 0).float().mean())
        else:
            mass, rss = norms[name]
            unit = (2.0 ** -8 * rss).clamp_min(tiny)
            r.update(over_spread=worst(diff, pixels * 2.0 ** -24 * mass),
                     over_mass=worst(diff, mass), over_rss=worst(diff, unit),
                     rms_over_rss=float((diff / unit).square().mean().sqrt()))
        out[name] = r
    held = (all(r["over_bar"] <= 1.0 for r in out.values())
            and all(out[n]["share"] <= share
                    for n, share in GATED_CONV_BF16_SHARE.items())
            and all(out[n]["rms_over_rss"] <= GATED_CONV_WGRAD_RMS
                    for n in GATED_CONV_RESULTS[2:]))
    return {"held": held, **out}


def gated_conv_plain_bwd(x, w1, b1, wg, bg, g, rate: float = 0.0,
                         seed: Optional[torch.Tensor] = None):
    """(dx, dw1, db1, dwg, dbg) of `gated_conv_plain` for the cotangent g,
    by the formulas of the Pallas `_bwd_kernel` (on bf16: its roundings,
    dx bf16 and the rest float32)."""
    scale = _drop_scale(x, rate, seed)
    if x.dtype == BF16:
        t = _bwd_terms_bf16(x, w1, b1, wg, bg, g, scale)
        return tuple(t[k] for k in ("dx", "dw1", "db1", "dwg", "dbg"))
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
    """The kernels' own limits (float32 or bf16, one dtype for every
    operand; pixels), then device and layout; returns (device, seed pointer
    or None, threshold, keep scale: a bf16 value for bf16)."""
    dtype = tensors["x"].dtype
    for arg, t in tensors.items():
        if t.dtype not in (torch.float32, BF16) or t.dtype != dtype:
            raise TypeError(f"{kernel}: '{arg}' has dtype {t.dtype}, the "
                            f"kernels take float32 or bfloat16, the same "
                            f"for every operand (x is {dtype})")
    b, h, w, _ = tensors["x"].shape
    if b * h * w >= GATED_CONV_MAX_PIXELS:
        raise ValueError(f"{kernel}: {b * h * w} pixels, the kernels take "
                         f"fewer than {GATED_CONV_MAX_PIXELS}")
    device = _native.check_cuda_inputs(kernel, dtypes=(dtype,), **tensors)
    if rate == 0.0:
        return device, None, 0, 1.0
    if seed.device != device:
        raise ValueError(f"{kernel}: seed is on {seed.device}, expected "
                         f"{device}")
    scale = 1.0 / (1.0 - rate)
    if dtype == BF16:  # the Pallas kernels' mask is x's dtype
        scale = bf16_scale(scale)
    return device, seed.data_ptr(), keep_threshold(rate), scale


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
                                _vec(c, x, w1, wg), x.dtype)
    scratch = torch.empty(floats, dtype=torch.float32, device=device)
    entry = "gpnf_gated_conv_fwd" + ("_bf16" if x.dtype == BF16 else "")
    _native.launch("fused_gated_conv", entry, device,
                   seed_ptr, x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                   wg.data_ptr(), bg.data_ptr(), out.data_ptr(),
                   scratch.data_ptr(), b, h, w, c, threshold, scale, floats)
    fused_gated_conv.launches += 1
    if x.dtype == BF16:
        fused_gated_conv_bf16.launches += 1
    return out


def fused_gated_conv_bwd(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                         wg: torch.Tensor, bg: torch.Tensor, g: torch.Tensor,
                         rate: float = 0.0,
                         seed: Optional[torch.Tensor] = None):
    """(dx, dw1, db1, dwg, dbg) of `fused_gated_conv` for the cotangent g,
    the forward's mask regenerated from `seed` (bf16 operands: dx bf16, the
    rest float32, as the Pallas `_bwd_kernel` writes them). CPU tensors
    take the plain version; CUDA tensors launch the kernels (one call,
    several launches) or raise."""
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
    bf16 = x.dtype == BF16
    empty = lambda *shape, dtype=x.dtype: torch.empty(shape, dtype=dtype,
                                                      device=device)
    dx = torch.empty_like(x)
    dw1, db1, dwg, dbg = (torch.empty_like(t, dtype=torch.float32)
                          for t in (w1, b1, wg, bg))
    # h, then dh over it (bf16: bf16(dh), and dh in float32 beside it for
    # db1); dG2; h2; the dropout scales and the partials
    hdh, dg2, h2 = empty(b, h, w, c), empty(b, h, w, 2 * c), empty(b, h, w,
                                                                   2 * c)
    floats, _ = gated_conv_plan(b, h, w, c, rate > 0.0, True,
                                _vec(c, x, w1, wg), x.dtype)
    partial = empty(floats, dtype=torch.float32)
    dh32 = (empty(b, h, w, c, dtype=torch.float32),) if bf16 else ()
    _native.launch("fused_gated_conv",
                   "gpnf_gated_conv_bwd" + ("_bf16" if bf16 else ""), device,
                   seed_ptr, *(t.data_ptr() for t in (
                       x, w1, b1, wg, bg, g, dx, dw1, db1, dwg, dbg, hdh,
                       *dh32, dg2, h2, partial)), b, h, w, c, threshold,
                   scale, floats)
    fused_gated_conv_bwd.launches += 1
    if bf16:
        fused_gated_conv_bwd_bf16.launches += 1
    return dx, dw1, db1, dwg, dbg


class _GatedConv(torch.autograd.Function):
    """Saves (x, w1, b1, wg, bg, seed), the residuals of the JAX package's
    custom VJP: the chain and the mask are recomputed in the backward. The
    weight and bias gradients are rounded to their tensors' dtype, as
    `_vjp_bwd` rounds the Pallas kernel's float32 ones."""

    @staticmethod
    def forward(ctx, x, w1, b1, wg, bg, seed, rate):
        ctx.save_for_backward(x, w1, b1, wg, bg, seed)
        ctx.rate = rate
        return _forward(x, w1, b1, wg, bg, rate, seed)

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, wg, bg, seed = ctx.saved_tensors
        dx, *grads = fused_gated_conv_bwd(x, w1, b1, wg, bg, g.contiguous(),
                                          ctx.rate, seed)
        return (dx, *(d.to(t.dtype) for d, t in zip(grads, (w1, b1, wg, bg))),
                None, None)


def fused_gated_conv(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                     wg: torch.Tensor, bg: torch.Tensor, rate: float = 0.0,
                     seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GatedConv block + residual, x (B, H, W, C) -> (B, H, W, C), with
    Dropout2d at `rate` from `seed` (a (1,) int32 tensor on x's device,
    read only when rate > 0). Differentiable in x and every weight and
    bias. CPU tensors take the plain versions; CUDA tensors launch the
    kernels (float32, or bf16 for every operand) or raise."""
    _validate("fused_gated_conv", x, w1, b1, wg, bg, rate, seed)
    return _GatedConv.apply(x, w1, b1, wg, bg, seed, rate)


fused_gated_conv.launches = 0
fused_gated_conv_bwd.launches = 0
# the bf16 kernels' launches, counted also by the entry that launches them
fused_gated_conv_bf16 = LaunchCount("fused_gated_conv_bf16")
fused_gated_conv_bwd_bf16 = LaunchCount("fused_gated_conv_bwd_bf16")
