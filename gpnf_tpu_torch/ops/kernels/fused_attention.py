"""Multi-head self-attention kernels: the fused-projection entry, the
long (or wide) entry for what the proj entry does not take, and the core
entries on separate q, k, v or a packed qkv.

Counterpart of gpnf_tpu/ops/pallas/fused_attention.py:
- `fused_attention_proj` (forward and backward, dropout inside both), at
  the shapes `attention_route` names "proj": each as stages of kernels
  that fill the card, across the whole batch. The forward
  (`_fwd_kernel_proj`): qkv = seq w^T by the GEMM kernel, then out by the
  long entry's key-tiled forward (`_proj_fwd_stages`). The backward
  (`_bwd_kernel_proj`): the projection recomputed by the GEMM kernel, dqkv
  by the long entry's key-tiled kernels, dseq and dW by the GEMM kernel
  with a split K (`fused_attention_proj_bwd`). Both use the q scale
  1.f / sqrtf(Dh), so the backward's scores and mask are the forward's.
  `attention_proj_plain` and `attention_proj_plain_bwd` are its plain
  PyTorch versions.
- `fused_attention_long` (`_fwd_kernel_bh`, `_bwd_kernel_bh`): the
  kernels take the packed qkv (B, S, 3C) and tile the key axis:
  gpnf_tpu_torch/csrc/fused_attention_long.cu. `attention_long_plain` and
  `attention_long_plain_bwd` are its plain versions at the kernels' own
  boundary (qkv in, out or dqkv out). For S > 512 the projection and
  dseq/dW are torch.matmul outside the kernels, as the JAX package leaves
  them to XLA there. It is also GatedAttn's wide route: every S up to
  MAX_S_LONG (the 48-px level 0's 2304 among them, where the JAX package
  computes its jnp reference) and every head width up to 256, a width
  the kernels are not built for zero-padded to the next one that is (q
  scaled by the true Dh^-1/2), the outputs sliced back. At S <= 512, where the JAX package computes the
  projection and dseq/dW inside `_fwd_kernel_proj` and `_bwd_kernel_proj`
  at every width, the wide route runs them in the GEMM kernels of
  gpnf_tpu_torch/csrc/attention_gemm.cu (`attention_qkv_gemm`,
  `attention_dseq_gemm`, `attention_dw_gemm`; plain versions torch.matmul
  and torch.einsum), as the proj backward does. Where few output tiles
  meet a long K the GEMM splits K (`gemm_splits`) and sums the splits in a
  fixed order.
- `fused_attention` (`_fwd_kernel`, `_bwd_kernel`): q, k, v (B, H, S, Dh),
  q already scaled; `attention_plain` and `attention_plain_bwd` are its
  plain versions. `fused_attention_qkv` (`_fwd_kernel_qkv`,
  `_bwd_kernel_qkv`): packed qkv (B, S, 3C) in, (B, S, C) out; its plain
  versions are the long entry's, which compute the same function. Both
  run the long entry's key-tiled kernels (csrc/attention_tiled.cuh) from
  gpnf_tpu_torch/csrc/fused_attention.cu (on bf16 operands from
  fused_attention_bf16.cu), at every S and head width the long entry
  takes: S up to MAX_S_LONG (above 512 the JAX package computes its jnp
  reference, even on a TPU) and any Dh up to 256, zero-padded to the next
  built width as the long entry pads it (`_split_padded`; the packed
  entry scales q by the true Dh^-1/2). On
  bf16 operands (`_fwd_kernel` and the others on bf16) the packed entry
  runs the long entry's bf16 kernels (the TMA + wgmma forward, the bf16
  dq and dK/dV pair, dq scaled in float32 and rounded once, as
  `_bwd_kernel_qkv`), its autograd keeping the forward's (m, 1/l); the
  split entry's forward is the same TMA + wgmma kernel on three tensor
  maps (Dh, S, H, B), no scale, and its backward the float32 entry's
  3xTF32 dq and dK/dV pair on the bf16 values widened inside the kernels
  (`_bwd_kernel`: every product in float32 from unrounded P, Pd, dP and
  dS, only dq, dk and dv rounded). `fused_attention_bf16`,
  `fused_attention_bwd_bf16`, `fused_attention_qkv_bf16` and
  `fused_attention_qkv_bwd_bf16` count those launches; Dh 4, whose 8-byte
  rows neither TMA nor the 16-byte copies take, runs 8 wide through a
  zero-padded copy (`core_bf16_padded` counts the calls).
The key-tiled kernels are built for the head widths HEAD_DIMS. The
forward and the backward run on the tensor cores at every width (3xTF32
mma.sync tiles, csrc/mma_tf32.cuh: one forward kernel, and the dq and
dK/dV kernels). Launches at Dh = 128 and 256, by any entry, are also
counted by `attention_lanes` and `attention_lanes_bwd` (the names of the
lane-split kernels those widths once ran); every entry counts its own
calls at every width. `attention_route(S, C, heads)` says which entry
GatedAttn takes: the proj entry at the shapes its fused forward kernel
once held, the wide route everywhere else. Each source's
header says what bounds its kernels on the H100 and how they are laid
out. The wrappers run the plain versions for CPU tensors, and the tests
and chip_smoke.py hold the kernels against them.

bfloat16 (MarScfConfig(compute_dtype="bfloat16"), serving and training):
the proj and long entries, their forward and backward, take bf16 operands
at every head width in HEAD_DIMS and run bf16 kernels: one GEMM for qkv,
dseq and dW on TMA and wgmma (`attention_qkv_gemm_bf16`,
`attention_dseq_gemm_bf16`, `attention_dw_gemm_bf16` count its launches;
`gemm_bf16_plan` routes each call), the attention forward on TMA and
wgmma too (`attention_fwd_bf16`), and on bf16 mma.sync the dq and dK/dV
pair (`attention_bwd_bf16`), built at the widths BF16_HEAD_DIMS (the
flagship's 24, the CLIs' --C 512's 128, and 256); every other width is
zero-padded to the next of them (`padded_head_dim`), q scaled by the
true width's constant. They round where the JAX package's bf16 kernels
round: qkv = seq w^T summed in float32 and rounded once; q * Dh^-1/2
rounded to bf16, the scale itself a bf16 constant, as in the JAX package's
bf16 `q * dh ** -0.5`; scores, softmax and dropout in float32; P rounded to
bf16 for PV, summed in float32; the output rounded once. Backward
(`_bwd_kernel_proj`, `_bwd_kernel_bh`): Pd rounded for dV, dS rounded for
dq and dK, dK from the rounded, scaled q, dqkv written in bf16; dq scaled
by Dh^-1/2 in float32 and rounded once on the proj entry, rounded and then
scaled in bf16 on the long one (`_vjp_bwd_long`); dseq the float32 sums of
dqkv w rounded once, dW summed in float32 and rounded to w's dtype. The
plain versions round at the JAX package's points (`bf16_matmul`: the
float32 product of the bf16 values, rounded once, whatever cuBLAS's
reduction switches say); the forward kernel rounds the unnormalised
exp(s - m) where the JAX package rounds the normalised p. No bf16 path
detours through float32 kernels. A
bf16 forward with a backward to come (`_keeps_stats`) also keeps each
query row's softmax statistics (m, 1/l), float32 (B, H, S, 2), and the
autograd functions save them beside (seq, w, seed), the JAX package's
residuals: the backward's dq kernel needs no online rescale, and computes
D = sum_j P dP in a pass of its own (rowsum(g * out) from the bf16 output
misses the kernels' bar, tests/test_torch_bf16_mma.py). The pair draws
each dropout bit once (the dq kernel) into a scratch of one bit a score
(`keep_bits_scratch`) that both kernels read.

Dropout: the keep bit of score (b, h, i, j) is word (j & 3) of
Philox4x32-10 at counter (j >> 2, i, h, b) and key (seed, 0), kept when
`bits >= rate * 2^32`; kept weights are scaled by 1 / (1 - rate). The bits
are a pure function of (seed, b, h, i, j), never of Dh, so the backward
regenerates the forward's mask in any order. `dropout_keep_plain` computes
the same bits in torch integer arithmetic. They cannot match the JAX
package's masks, which come from the TPU's own generator. Every entry
draws the same bits, so at one seed they drop the same scores, padded or
not.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import _native

MAX_S = 512  # above this the JAX package switches to fused_attention_long
# the long entry's range (GatedAttn's wide route): the largest S whose
# indices the key-tiled kernels hold in an int, 3 S in the float32 dK/dV
# kernel's statistics; the grids and every other index and scratch take more.
# Above 2048 the JAX package computes its jnp reference, even on a TPU;
# the port runs the same kernels, whose keys stream in tiles
MAX_S_LONG = (2 ** 31 - 1) // 3
# Dh values the key-tiled kernels are built for, each on the tensor cores
HEAD_DIMS = (4, 8, 16, 24, 32, 48, 64, 128, 256)
# the widths the bf16 kernels are built for: the flagship's Dh 24 (C 96, 4
# heads), the CLIs' default --C 512's Dh 128, and 256; the others pad to them
BF16_HEAD_DIMS = (24, 128, 256)
LANE_SPLIT_DIMS = (128, 256)
# the proj route's rule, the fit of the fused forward kernel it was drawn
# for (fused_attention_proj.cu, since replaced by the forward's stages): its
# head widths, kMaxSharedBytes (227 KB a block on sm_90) in floats, and
# kRows, the seq rows it staged at a time
PROJ_HEAD_DIMS = (4, 8, 16, 24, 32, 48, 64)
PROJ_SHARED_FLOATS = 232448 // 4
PROJ_ROWS = 32
# attention_gemm.cu: the output tiles (BM, BN), large where they cover the
# output evenly in at least GEMM_LARGE_MIN_TILES blocks, else small
# (`gemm_tile`), and the K chunk a block stages at a time; a split of K is
# a whole number of chunks
GEMM_TILES = {"large": (128, 128), "small": (64, 64)}
GEMM_LARGE_MIN_TILES = 128
GEMM_KC = 32
# the blocks `gemm_splits` aims at with small tiles: 2 for each of the
# H100's 132 SMs
GEMM_BLOCKS = 2 * 132
# attention_gemm.cu's bf16 kernel on TMA and wgmma (`gemm_wgmma_bf16_kernel`):
# output tiles of WGMMA_BM rows and `wgmma_tile` columns, K in blocks of
# WGMMA_BK through a ring of `wgmma_stages` stages (WGMMA_STAGES: the least,
# the most where two blocks share an SM, the most where the grid fits
# WGMMA_SMS); dseq's and dW's long K split (`wgmma_splits`) into about
# WGMMA_SPLIT_KB k-blocks a split where the tiles are few, the splits of a
# tile summed a cluster of WGMMA_CLUSTER (or, for 2, 4 or 6 splits,
# WGMMA_PAIR) blocks at a time (`wgmma_cluster`)
WGMMA_BM, WGMMA_BK = 128, 64
WGMMA_BN = (96, 128)
WGMMA_STAGES = (2, 3, 6)
WGMMA_SMS = 132
WGMMA_SPLIT_KB = 8
WGMMA_CLUSTER = 8
WGMMA_PAIR = 2

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


def keep_threshold(rate: float) -> int:
    """uint32 threshold of the keep test `bits >= threshold`."""
    return min(int(rate * (1 << 32)), (1 << 32) - 1)


def _mulhilo(m: int, c: torch.Tensor):
    """(hi, lo) 32-bit words of m * c for uint32 values held in int64.

    The constant m is split into 16-bit limbs, so no partial product
    reaches 2^63: x, y < 2^48."""
    x = c * (m & 0xFFFF)
    y = c * (m >> 16)
    hi = (y + (x >> 16)) >> 16
    lo = (((y & 0xFFFF) << 16) + x) & _U32
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors (or ints) holding uint32 values; the
    arguments broadcast. Returns the four output words."""
    for rnd in range(10):
        if rnd:
            k0 = (k0 + _W0) & _U32
            k1 = (k1 + _W1) & _U32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def dropout_keep_plain(seed: torch.Tensor, batch: int, heads: int,
                       seq_len: int, rate: float) -> torch.Tensor:
    """Keep mask (B, H, S, S) of the kernels, on the seed's device.

    On the CPU, batch rows go through Philox in chunks of at most 2^18
    counters, whose int64 temporaries stay in cache (4x faster than one
    pass over the whole batch); on the card in one pass."""
    dev = seed.device
    idx = lambda n, dim: torch.arange(n, dtype=torch.int64, device=dev).reshape(
        [n if d == dim else 1 for d in range(4)])
    quads = (seq_len + 3) // 4
    key = seed.to(torch.int64) & _U32
    rows = (max(1, (1 << 18) // (heads * seq_len * quads))
            if dev.type == "cpu" else batch)
    keep = []
    for b0 in range(0, batch, rows):
        n = min(rows, batch - b0)
        words = philox4x32_10(idx(quads, 3), idx(seq_len, 2), idx(heads, 1),
                              idx(n, 0) + b0, key, 0)
        bits = torch.stack(torch.broadcast_tensors(*words), dim=-1)
        bits = bits.reshape(n, heads, seq_len, 4 * quads)[..., :seq_len]
        keep.append(bits >= keep_threshold(rate))
    return torch.cat(keep)


def head_scale(head_dim: int) -> float:
    """Dh^-1/2 as the packed kernels computed it before they took it as an
    argument, 1.f / sqrtf(Dh) in float32: the kernel wrappers' default, so
    every width keeps its bits. The plain versions' Dh ** -0.5 is the
    correctly rounded value and may differ in the last bit (Dh = 24)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(head_dim)))


class AttentionRoute(NamedTuple):
    """GatedAttn's entry for one shape: "proj" (`fused_attention_proj`) or
    "wide" (`fused_attention_long`), the head width, and the width the
    kernels run: the head width, or the built width it is zero-padded to."""
    entry: str
    head_dim: int
    kernel_head_dim: int


def padded_head_dim(head_dim: int, widths=HEAD_DIMS) -> int:
    """The narrowest of `widths` that holds `head_dim`: HEAD_DIMS, the
    float32 kernels' widths, or BF16_HEAD_DIMS, where Dh 4, 8, 16 and 24 run
    24 wide and 32 to 128 run 128 wide."""
    for width in widths:
        if width >= head_dim:
            return width
    raise ValueError(f"head width {head_dim} > {widths[-1]}, the widest "
                     f"the attention kernels are built for (C > "
                     f"{4 * widths[-1]} with 4 heads)")


def proj_shared_floats(seq_len: int, channels: int, head_dim: int) -> int:
    """The shared memory, in floats, that the fused proj forward kernel
    took for one head (its weight rows, the staged seq rows, K, V and Q):
    the rule `attention_route` keeps, though the stages that replaced the
    kernel hold no whole head."""
    cp = channels + 1
    return 3 * head_dim * cp + PROJ_ROWS * cp + 3 * seq_len * head_dim


def attention_route(seq_len: int, channels: int, num_heads: int,
                    dtype: torch.dtype = torch.float32) -> AttentionRoute:
    """Which entry computes GatedAttn's attention for S = seq_len, C =
    channels: the proj entry where the head width is one of
    PROJ_HEAD_DIMS, S <= MAX_S and the fused forward kernel the route was
    drawn for fit a block's shared memory (`proj_shared_floats`), the wide
    route `fused_attention_long` everywhere else, at the padded width.
    Both entries now run the same kernels at an unpadded width; the rule
    stays so that every shape keeps its entry, its padding and its bits
    (folding the two routes is left for later). Decided from the shape
    alone, before any launch; raises for S > MAX_S_LONG or a head width
    above 256. In bfloat16 both entries run the heads zero-padded to the
    next of BF16_HEAD_DIMS, and `kernel_head_dim` says that width."""
    if channels % num_heads:
        raise ValueError(f"C={channels} is not a multiple of {num_heads} "
                         f"heads")
    if seq_len > MAX_S_LONG:
        raise ValueError(f"S={seq_len} > {MAX_S_LONG}, beyond the attention "
                         f"kernels' range")
    dh = channels // num_heads
    fits = proj_shared_floats(seq_len, channels, dh) <= PROJ_SHARED_FLOATS
    bf16 = dtype == torch.bfloat16
    if dh in PROJ_HEAD_DIMS and seq_len <= MAX_S and fits:
        return AttentionRoute(
            "proj", dh, padded_head_dim(dh, BF16_HEAD_DIMS) if bf16 else dh)
    return AttentionRoute("wide", dh, padded_head_dim(
        dh, BF16_HEAD_DIMS if bf16 else HEAD_DIMS))


def bf16_scale(x: float) -> float:
    """x rounded to bfloat16: the JAX package's bf16 `q * dh ** -0.5` takes
    the Python scale as a bf16 constant, so q * scale is the rounded product
    of two bf16 values."""
    return float(torch.tensor(x, dtype=torch.bfloat16))


def bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of bf16 operands as the JAX package takes it (float32
    accumulation, `preferred_element_type`): the float32 product of the bf16
    values, rounded once to bf16."""
    return torch.matmul(a.float(), b.float()).to(torch.bfloat16)


def bf16_product_close(got: torch.Tensor, want: torch.Tensor,
                       a: torch.Tensor, b: torch.Tensor) -> bool:
    """The bar of a bf16 product c = a b^T (a (M, K), b (N, K)) against its
    plain version: |got - want| within one bf16 ulp of the larger of the
    two, plus K 2^-24 sum_k |a_ik b_jk|. Both sum the same products in
    float32, in different orders, and round once; where a sum cancels
    below that spread an ulp of the result says nothing."""
    a, b = a.reshape(-1, a.shape[-1]).float(), b.float()
    got, want = got.reshape(a.shape[0], -1).float(), want.reshape(
        a.shape[0], -1).float()
    spread = a.shape[1] * 2.0 ** -24 * (a.abs() @ b.abs().t())
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return bool(((got - want).abs() <= ulp + spread).all())


def bf16_top_ulp_readings(got: torch.Tensor, want: torch.Tensor,
                          max_share: float = 0.05):
    """(largest |got - want|, one bf16 ulp at the largest |want|, the share
    of values that differ, whether the bar holds): the bar of a bf16
    result that its kernel and its plain version both round once from
    float32 sums of the same terms, in different orders. The largest
    difference within that ulp, and at most `max_share` of the values
    differing (a sum near a rounding boundary flips its last bit)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    top = float(want.abs().max())
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0
    largest, share = float(diff.max()), float((diff > 0).float().mean())
    return largest, ulp, share, largest <= ulp and share <= max_share


def qkv_plain(seq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """qkv = seq w^T: torch.matmul in float32 (and float64), `bf16_matmul`
    in bf16 (the JAX `_proj`); the two operands of one dtype."""
    if seq.dtype != w.dtype:
        raise TypeError(f"qkv projection: seq is {seq.dtype}, w is "
                        f"{w.dtype}; the operands take one dtype")
    if seq.dtype == torch.bfloat16:
        return bf16_matmul(seq, w.t())
    return torch.matmul(seq, w.t())


def _split_qkv(qkv, num_heads, q_scale=None):
    """k, v and q times q_scale (default Dh ** -0.5) of the packed qkv
    (B, S, 3C), each (B, H, S, Dh); in bf16 the scale is `bf16_scale`d and
    q * scale rounded to bf16."""
    b, s, c3 = qkv.shape
    c = c3 // 3
    dh = c // num_heads
    scale = dh ** -0.5 if q_scale is None else q_scale
    if qkv.dtype == torch.bfloat16:
        scale = bf16_scale(scale)

    def heads(t):
        return t.reshape(b, s, num_heads, dh).transpose(1, 2)

    k, v, q = (heads(t) for t in qkv.split(c, dim=-1))
    return k, v, q * scale


def _merge_heads(t):
    b, h, s, dh = t.shape
    return t.transpose(1, 2).reshape(b, s, h * dh)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    rate: float = 0.0,
                    seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dropout(softmax(q k^T)) v on q, k, v (B, H, S, Dh), q already
    scaled -> (B, H, S, Dh). bf16 operands: the scores, softmax and dropout
    in float32, then P rounded to bf16 and P v rounded once (the JAX
    `_reference`)."""
    low = q.dtype == torch.bfloat16
    if low:
        q, k = q.float(), k.float()
    p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)), -1)
    if rate > 0.0:
        b, h, s, _ = q.shape
        p = torch.where(dropout_keep_plain(seed, b, h, s, rate),
                        p / (1.0 - rate), 0.0)
    if low:
        return bf16_matmul(p.to(torch.bfloat16), v)
    return torch.matmul(p, v)


def attention_plain_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        g: torch.Tensor, rate: float = 0.0,
                        seed: Optional[torch.Tensor] = None):
    """(dq, dk, dv) of `attention_plain` for the cotangent g (B, H, S, Dh),
    by the formulas of the JAX module's docstring:
        dV = Pd^T g;  dPd = g V^T;  dP = mask * dPd / (1 - r)
        dS = P (dP - rowsum(dP P));  dQ = dS K;  dK = dS^T Q
    bf16 operands (`_bwd_kernel`'s recipe): q, k, v and g widened to
    float32, every product in float32 from unrounded P, Pd, dP and dS, and
    only dq, dk and dv rounded to bf16, once each."""
    if q.dtype == torch.bfloat16:
        grads = attention_plain_bwd(q.float(), k.float(), v.float(),
                                    g.float(), rate, seed)
        return tuple(x.to(torch.bfloat16) for x in grads)
    p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)), -1)
    dpd = torch.matmul(g, v.transpose(-1, -2))
    if rate > 0.0:
        b, h, s, _ = q.shape
        keep = dropout_keep_plain(seed, b, h, s, rate)
        pd = torch.where(keep, p / (1.0 - rate), 0.0)
        dp = torch.where(keep, dpd / (1.0 - rate), 0.0)
    else:
        pd, dp = p, dpd
    dv = torch.matmul(pd.transpose(-1, -2), g)
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    return torch.matmul(ds, k), torch.matmul(ds.transpose(-1, -2), q), dv


def _attention_plain_bwd_bf16(q, k, v, g, rate, seed, dq_scale):
    """`attention_plain_bwd`'s formulas on bf16 q (already scaled), k, v, g
    at `_bwd_kernel_bh`'s rounding points: P, dP and dS in float32, Pd
    rounded to bf16 for dV, dS rounded to bf16 for dQ and dK, each product
    summed in float32 and rounded once; with `dq_scale` dQ is multiplied by
    it in float32 before its rounding (`_bwd_kernel_proj`)."""
    low = torch.bfloat16
    p = torch.softmax(torch.matmul(q.float(), k.float().transpose(-1, -2)), -1)
    dpd = torch.matmul(g.float(), v.float().transpose(-1, -2))
    if rate > 0.0:
        b, h, s, _ = q.shape
        keep = dropout_keep_plain(seed, b, h, s, rate)
        pd = torch.where(keep, p / (1.0 - rate), 0.0)
        dp = torch.where(keep, dpd / (1.0 - rate), 0.0)
    else:
        pd, dp = p, dpd
    dv = bf16_matmul(pd.to(low).transpose(-1, -2), g)
    ds = (p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))).to(low)
    dq = torch.matmul(ds.float(), k.float())
    dq = (dq if dq_scale is None else dq * np.float32(dq_scale)).to(low)
    return dq, bf16_matmul(ds.transpose(-1, -2), q), dv


def attention_long_plain(qkv: torch.Tensor, num_heads: int,
                         rate: float = 0.0,
                         seed: Optional[torch.Tensor] = None,
                         q_scale: Optional[float] = None) -> torch.Tensor:
    """qkv (B, S, 3C) packed [k | v | q], q not yet scaled -> (B, S, C):
    `attention_plain` on the heads, q scaled by q_scale (default Dh^-1/2;
    the wide route passes the true width's scale for padded heads). The
    plain version of both packed entries, `fused_attention_long` and
    `fused_attention_qkv`."""
    k, v, q = _split_qkv(qkv, num_heads, q_scale)
    return _merge_heads(attention_plain(q, k, v, rate, seed))


def attention_stats_plain(qkv: torch.Tensor, num_heads: int,
                          q_scale: Optional[float] = None) -> torch.Tensor:
    """The float32 (B, H, S, 2) statistics the bf16 forward kernel keeps for
    the backward: each query row's softmax max m and inverse denominator
    1 / sum_j exp(s_j - m), over the scores of `attention_long_plain` (q
    scaled as `_split_qkv` scales it), so that m + log l is the row's
    logsumexp. Independent of the dropout, which scales only P V."""
    k, _, q = _split_qkv(qkv, num_heads, q_scale)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    m = scores.amax(-1)
    inv_l = 1.0 / torch.exp(scores - m[..., None]).sum(-1)
    return torch.stack([m, inv_l], dim=-1)


def attention_long_plain_bwd(qkv: torch.Tensor, g: torch.Tensor,
                             num_heads: int, rate: float = 0.0,
                             seed: Optional[torch.Tensor] = None,
                             q_scale: Optional[float] = None,
                             scale_dq_in_fp32: bool = False) -> torch.Tensor:
    """dqkv (B, S, 3C), packed [dK | dV | dq * q_scale], of
    `attention_long_plain` for the cotangent g (B, S, C), by
    `attention_plain_bwd` on the heads. bf16: q scaled as the forward
    scales it (`_split_qkv`), and dq either rounded and then scaled in bf16
    by the bf16 constant (`_vjp_bwd_long` on `_bwd_kernel_bh`'s dq, the
    default) or, with `scale_dq_in_fp32`, scaled by q_scale in float32 and
    rounded once (`_bwd_kernel_proj`)."""
    b, s, c3 = qkv.shape
    dh = c3 // 3 // num_heads
    if q_scale is None:
        q_scale = dh ** -0.5
    k, v, q = _split_qkv(qkv, num_heads, q_scale)
    gh = g.reshape(b, s, num_heads, dh).transpose(1, 2)
    low = qkv.dtype == torch.bfloat16
    in_fp32 = low and scale_dq_in_fp32
    if low:
        dq, dk, dv = _attention_plain_bwd_bf16(q, k, v, gh, rate, seed,
                                               q_scale if in_fp32 else None)
    else:
        dq, dk, dv = attention_plain_bwd(q, k, v, gh, rate, seed)
    if low and not in_fp32:
        dq = (dq.float() * bf16_scale(q_scale)).to(torch.bfloat16)
    elif not low:
        dq = dq * q_scale
    return torch.cat([_merge_heads(dk), _merge_heads(dv), _merge_heads(dq)],
                     dim=-1)


def _project_bwd(dqkv, seq, w):
    """(dseq, dW) of qkv = seq w^T for the cotangent dqkv. bf16: dseq the
    float32 sums rounded once (`bf16_matmul`), dW summed in float32 and
    rounded to w's dtype (`_vjp_bwd_proj`, `_vjp_bwd_long`)."""
    if dqkv.dtype == torch.bfloat16:
        return bf16_matmul(dqkv, w), dw_plain(dqkv, seq).to(w.dtype)
    return torch.matmul(dqkv, w), dw_plain(dqkv, seq)


def dw_plain(dqkv: torch.Tensor, seq: torch.Tensor) -> torch.Tensor:
    """dW = dqkv^T seq summed over (B, S): torch.einsum in the operands'
    float32 or float64, and in float32 for bf16 operands (the JAX
    package's dW, summed in float32 before its rounding to w's dtype)."""
    if dqkv.dtype == torch.bfloat16:
        dqkv, seq = dqkv.float(), seq.float()
    return torch.einsum("bso,bsc->oc", dqkv, seq)


def attention_proj_plain(seq: torch.Tensor, w: torch.Tensor, num_heads: int,
                         rate: float = 0.0,
                         seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """seq (B, S, C), w (3C, C) with rows [k | v | q] -> (B, S, C)."""
    return attention_long_plain(qkv_plain(seq, w), num_heads, rate, seed)


def attention_proj_plain_bwd(seq, w, g, num_heads: int, rate: float = 0.0,
                             seed: Optional[torch.Tensor] = None):
    """(dseq, dW) of `attention_proj_plain` for the cotangent g (B, S, C):
    dqkv as `attention_long_plain_bwd` (in bf16 with `_bwd_kernel_proj`'s
    dq, scaled in float32 and rounded once), then dseq = dqkv w and
    dW = dqkv^T seq."""
    dqkv = attention_long_plain_bwd(qkv_plain(seq, w), g, num_heads, rate,
                                    seed, scale_dq_in_fp32=True)
    return _project_bwd(dqkv, seq, w)


def _check_heads_and_rate(kernel, c, num_heads, rate, seed):
    if c % num_heads:
        raise ValueError(f"{kernel}: C={c} is not a multiple of {num_heads} "
                         f"heads")
    _check_rate(kernel, rate, seed)


def _check_rate(kernel, rate, seed):
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"{kernel}: dropout rate {rate} is not in [0, 1)")
    if rate > 0.0 and (seed is None or seed.shape != (1,)
                       or seed.dtype != torch.int32):
        raise ValueError(f"{kernel}: dropout needs a (1,) int32 seed tensor")


def _validate(seq, w, num_heads, rate, seed, kernel="fused_attention_proj"):
    if seq.dim() != 3 or w.shape != (3 * seq.shape[2], seq.shape[2]):
        raise ValueError(f"{kernel}: seq {tuple(seq.shape)} and w "
                         f"{tuple(w.shape)} are not (B, S, C) and (3C, C)")
    _check_heads_and_rate(kernel, seq.shape[2], num_heads, rate, seed)


def _validate_qkv(kernel, qkv, num_heads, rate, seed):
    if qkv.dim() != 3 or qkv.shape[2] % 3:
        raise ValueError(f"{kernel}: qkv {tuple(qkv.shape)} is not (B, S, 3C)")
    _check_heads_and_rate(kernel, qkv.shape[2] // 3, num_heads, rate, seed)


def _aligned(*tensors):
    """The tensors as the key-tiled kernels take them: a CUDA tensor
    contiguous and starting on a 16-byte boundary (their cp.async copies
    move 16-byte chunks, and a tensor map's base is 16-byte aligned),
    copied into a fresh tensor where it is not; any
    other tensor as it is, for `_cuda_args` to refuse."""
    out = []
    for t in tensors:
        if t.device.type == "cuda":
            t = t.contiguous()
            if t.data_ptr() % 16:
                t = t.clone()
        out.append(t)
    return out


def _cuda_args(kernel, seq_len, head_dim, max_s, rate, seed,
               head_dims=HEAD_DIMS, bf16=False, **tensors):
    """The kernel's own limits (S, head width, float32, or bf16 where the
    entry has bf16 kernels, `bf16`; one dtype for every operand), then
    device and layout; returns (device, seed pointer, threshold, keep
    scale)."""
    if seq_len > max_s:
        raise ValueError(f"{kernel}: S={seq_len} > {max_s}, beyond the "
                         f"kernel's range")
    if head_dim not in head_dims:
        raise ValueError(f"{kernel}: head width {head_dim} not in "
                         f"{head_dims}, the widths the kernel is built for "
                         f"(fused_attention_long, GatedAttn's wide route, "
                         f"pads any width up to {HEAD_DIMS[-1]})")
    dtypes = (torch.float32, torch.bfloat16) if bf16 else (torch.float32,)
    dtype = next(iter(tensors.values())).dtype
    for arg, t in tensors.items():
        if t.dtype not in dtypes or t.dtype != dtype:
            raise TypeError(f"{kernel}: '{arg}' has dtype {t.dtype}, the "
                            f"kernel takes {' or '.join(map(str, dtypes))}, "
                            f"one dtype for every operand")
    device = _native.check_cuda_inputs(kernel, dtypes=dtypes, **tensors)
    if rate == 0.0:
        return device, None, 0, 1.0
    if seed.device != device:
        raise ValueError(f"{kernel}: seed is on {seed.device}, expected "
                         f"{device}")
    return device, seed.data_ptr(), keep_threshold(rate), 1.0 / (1.0 - rate)


def _proj_cuda_args(kernel, seq, w, num_heads, rate, seed, bf16=False,
                    **tensors):
    """The proj route's shapes (`attention_route`'s fit rule), then
    `_cuda_args`."""
    b, s, c = seq.shape
    dh = c // num_heads
    if (s <= MAX_S and dh in PROJ_HEAD_DIMS
            and attention_route(s, c, num_heads).entry != "proj"):
        raise ValueError(
            f"{kernel}: S={s}, C={c} over {num_heads} heads is not a proj "
            f"shape: its fused forward would have needed "
            f"{proj_shared_floats(s, c, dh) * 4} bytes of shared memory, "
            f"over the {PROJ_SHARED_FLOATS * 4} a block has "
            f"(`attention_route`'s rule); fused_attention_long (GatedAttn's "
            f"wide route) computes the same function there")
    return _cuda_args(kernel, s, dh, MAX_S, rate, seed, PROJ_HEAD_DIMS,
                      bf16, seq=seq, w=w, **tensors)


def _forward(seq, w, num_heads, rate, seed, with_stats=False):
    """out, or (out, the bf16 forward's statistics) `with_stats`."""
    _validate(seq, w, num_heads, rate, seed)
    if seq.device.type == "cpu" and w.device.type == "cpu":
        out = attention_proj_plain(seq, w, num_heads, rate, seed)
        if with_stats:
            return out, attention_stats_plain(qkv_plain(seq, w), num_heads)
        return out
    _proj_cuda_args("fused_attention_proj", seq, w, num_heads, rate,
                    seed, bf16=True)  # the checks; the stages launch
    out = _proj_fwd_stages(seq, w, num_heads, rate, seed, with_stats)
    fused_attention_proj.launches += 1
    return out


def _proj_fwd_stages(seq, w, num_heads, rate, seed, with_stats=False):
    """`_fwd_kernel_proj`'s work in two stages, each across the whole
    batch: qkv = seq w^T (`attention_qkv_gemm`), then out by the
    tensor-core forward (`attention_long_qkv`, q scaled by `head_scale`,
    the backward's scale, so its scores and its mask are the ones the
    backward regenerates; in bf16 the bf16 constant Dh ** -0.5, the JAX
    package's, and `with_stats` the forward's statistics beside out). The
    qkv (B, S, 3C) lives only for the call. CPU tensors take each
    wrapper's plain version."""
    q_scale = (None if seq.dtype == torch.bfloat16
               else head_scale(seq.shape[2] // num_heads))
    return attention_long_qkv(attention_qkv_gemm(seq, w), num_heads, rate,
                              seed, q_scale, with_stats)


def fused_attention_proj_bwd(seq: torch.Tensor, w: torch.Tensor,
                             g: torch.Tensor, num_heads: int,
                             rate: float = 0.0,
                             seed: Optional[torch.Tensor] = None,
                             stats: Optional[torch.Tensor] = None):
    """(dseq, dW) of `fused_attention_proj` for the cotangent g, with the
    forward's dropout mask regenerated from `seed`; in bf16 `stats` are the
    forward's statistics (`attention_long_qkv_bwd`). CPU tensors take the
    plain version; CUDA tensors launch the kernels (`_proj_bwd_stages`) or
    raise. It takes the shapes the forward takes (`attention_route`'s
    "proj"). One call counts one launch here and one in each stage's
    count."""
    if g.shape != seq.shape:
        raise ValueError(f"fused_attention_proj_bwd: g {tuple(g.shape)} is "
                         f"not seq's {tuple(seq.shape)}")
    _validate(seq, w, num_heads, rate, seed)
    if all(t.device.type == "cpu" for t in (seq, w, g)):
        return attention_proj_plain_bwd(seq, w, g, num_heads, rate, seed)
    _proj_cuda_args("fused_attention_proj_bwd", seq, w, num_heads, rate,
                    seed, bf16=True, g=g)  # the checks; the stages launch
    dseq, dw = _proj_bwd_stages(seq, w, g, num_heads, rate, seed, stats)
    fused_attention_proj_bwd.launches += 1
    return dseq, dw


def _proj_bwd_stages(seq, w, g, num_heads, rate, seed, stats=None):
    """`_bwd_kernel_proj`'s work in three stages, each across the whole
    batch: qkv = seq w^T recomputed (`attention_qkv_gemm`); dqkv by the
    tensor-core dq and dK/dV kernels (`attention_long_qkv_bwd`, with the
    forward's q scale, 1.f / sqrtf(Dh) in float32 and the bf16 constant in
    bf16, and so its scores and its mask; in bf16 dq scaled in float32 and
    rounded once); then dseq = dqkv w and dW = dqkv^T seq
    (`attention_dseq_gemm`, `attention_dw_gemm`, K split where few output
    tiles meet a long K; dW rounded to w's dtype). CPU tensors take each
    wrapper's plain version."""
    dqkv = attention_long_qkv_bwd(attention_qkv_gemm(seq, w), g, num_heads,
                                  rate, seed, scale_dq_in_fp32=True,
                                  stats=stats)
    return (attention_dseq_gemm(dqkv, w),
            attention_dw_gemm(dqkv, seq).to(w.dtype))


def _keeps_stats(seq, w):
    """Whether a forward saves the bf16 kernels' statistics for its
    backward: bf16 operands, and a backward to come (grad mode on and seq
    or w requiring grad). Eval, sampling and no_grad calls run the forward
    kernel without its store."""
    return (seq.dtype == torch.bfloat16 and torch.is_grad_enabled()
            and (seq.requires_grad or w.requires_grad))


class _AttentionProj(torch.autograd.Function):
    """Saves (seq, w, seed), the residuals of the JAX package's
    `_vjp_fwd_proj`: the projection and the mask are recomputed. In bf16
    (`keep_stats`) it also saves the forward's (B, H, S, 2) statistics, so
    that the backward's kernels need not rebuild each row's softmax."""

    @staticmethod
    def forward(ctx, seq, w, seed, num_heads, rate, keep_stats):
        ctx.num_heads, ctx.rate = num_heads, rate
        if not keep_stats:
            ctx.save_for_backward(seq, w, seed)
            return _forward(seq, w, num_heads, rate, seed)
        out, stats = _forward(seq, w, num_heads, rate, seed, with_stats=True)
        ctx.save_for_backward(seq, w, seed, stats)
        return out

    @staticmethod
    def backward(ctx, g):
        seq, w, seed, *stats = ctx.saved_tensors
        dseq, dw = fused_attention_proj_bwd(seq, w, g.contiguous(),
                                            ctx.num_heads, ctx.rate, seed,
                                            *stats)
        return dseq, dw, None, None, None, None


def fused_attention_proj(seq: torch.Tensor, w: torch.Tensor, num_heads: int,
                         rate: float = 0.0,
                         seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dropout(softmax(q k^T / sqrt(Dh))) v over `num_heads` heads, with
    [k|v|q] = seq w^T; `seed` is a (1,) int32 tensor on seq's device, read
    only when rate > 0. Differentiable in seq and w. CPU tensors take the
    plain versions; CUDA tensors launch the kernels (`_proj_fwd_stages`,
    `_proj_bwd_stages`) or raise. A call counts one launch here and one
    in each stage's count, forward and backward alike."""
    return _AttentionProj.apply(seq, w, seed, num_heads, rate,
                                _keeps_stats(seq, w))


# -- the packed entries' kernels: qkv in, the key axis tiled -------------------------
class LaunchCount:
    """The launch count of kernels that no wrapper of their own launches:
    the key-tiled kernels at Dh = 128 and 256 (the tensor-core forward and
    backward, which narrower widths run too but count only in their
    entry), launched by every key-tiled attention entry at those widths.
    The entry counts the launch too."""

    def __init__(self, name: str):
        self.__name__ = name
        self.launches = 0


attention_lanes = LaunchCount("attention_lanes")
attention_lanes_bwd = LaunchCount("attention_lanes_bwd")
# the bf16 kernels' launches (the forward, the dq and dK/dV pair, the GEMM
# for each of its three products), counted also by the entry that launches
# them
attention_fwd_bf16 = LaunchCount("attention_fwd_bf16")
attention_bwd_bf16 = LaunchCount("attention_bwd_bf16")
attention_qkv_gemm_bf16 = LaunchCount("attention_qkv_gemm_bf16")
attention_dseq_gemm_bf16 = LaunchCount("attention_dseq_gemm_bf16")
attention_dw_gemm_bf16 = LaunchCount("attention_dw_gemm_bf16")
# the bf16 GEMM's calls that `wgmma_route` sends to the kernel of one-value
# copies (none on any path: chip_smoke.py holds it at 0); each also counts
# on its product's entry and bf16 counter
attention_gemm_bf16_unaligned = LaunchCount("attention_gemm_bf16_unaligned")
# the core entries' bf16 kernels (fused_attention_bf16.cu), counted also by
# the entry that launches them: the split forward (TMA + wgmma on three
# tensor maps), the split backward (the 3xTF32 dq and dK/dV pair on widened
# bf16), the packed forward and the packed dq and dK/dV pair
fused_attention_bf16 = LaunchCount("fused_attention_bf16")
fused_attention_bwd_bf16 = LaunchCount("fused_attention_bwd_bf16")
fused_attention_qkv_bf16 = LaunchCount("fused_attention_qkv_bf16")
fused_attention_qkv_bwd_bf16 = LaunchCount("fused_attention_qkv_bwd_bf16")
# the split entry's bf16 calls at Dh 4, whose operands go through a copy
# zero-padded to Dh 8 (rows of 8 bytes take neither a tensor map nor the
# kernels' 16-byte copies); each also counts as its kernel's launch
core_bf16_padded = LaunchCount("core_bf16_padded")


def _count_lanes(head_dim, counter):
    if head_dim in LANE_SPLIT_DIMS:
        counter.launches += 1


def _packed_fwd(kernel, source, fn, max_s, qkv, num_heads, q_scale, rate,
                seed, bf16=False, with_stats=False,
                counter=attention_fwd_bf16, bf16_source=None):
    """Launch the packed forward `fn` of library `source` (the long entry's
    or `fused_attention_qkv`'s) on CUDA tensors after the kernel's checks,
    q scaled by q_scale (None: `head_scale`); returns out (B, S, C). With
    `bf16` a bf16 qkv launches the bf16 instantiation (`fn` with the bf16
    suffix, of library `bf16_source` (default `source`), its launch
    counted on `counter`) on heads zero-padded to the
    next of BF16_HEAD_DIMS, q scaled by `bf16_scale(q_scale)` (None: the
    true Dh ** -0.5); `with_stats` (bf16 only) returns (out, stats), the
    kernel's float32 (B, H, S, 2) (m, 1/l) of each query row
    (`attention_stats_plain`)."""
    b, s, c3 = qkv.shape
    c = c3 // 3
    dh = c // num_heads
    qkv, = _aligned(qkv)
    device, seed_ptr, threshold, scale = _cuda_args(
        kernel, s, dh, max_s, rate, seed, bf16=bf16, qkv=qkv)
    if qkv.dtype == torch.bfloat16:
        width = padded_head_dim(dh, BF16_HEAD_DIMS)
        q_scale = bf16_scale(dh ** -0.5 if q_scale is None else q_scale)
        qkv = _pad_heads(qkv, dh, width)
        out = torch.empty((b, s, num_heads * width), dtype=qkv.dtype,
                          device=device)
        stats = (torch.empty((b, num_heads, s, 2), dtype=torch.float32,
                             device=device) if with_stats else None)
        _native.launch(bf16_source or source, f"{fn}_bf16", device,
                       seed_ptr, qkv.data_ptr(), out.data_ptr(),
                       None if stats is None else stats.data_ptr(), b, s,
                       num_heads * width, num_heads, q_scale, threshold,
                       scale)
        counter.launches += 1
        out = _unpad_heads(out, dh, width)
        return (out, stats) if with_stats else out
    if with_stats:
        raise TypeError(f"{kernel}: the statistics are the bf16 kernel's; "
                        f"qkv is {qkv.dtype}")
    if q_scale is None:
        q_scale = head_scale(dh)
    out = torch.empty((b, s, c), dtype=qkv.dtype, device=device)
    _native.launch(source, fn, device, seed_ptr, qkv.data_ptr(),
                   out.data_ptr(), b, s, c, num_heads, q_scale, threshold,
                   scale)
    _count_lanes(dh, attention_lanes)
    return out


def _packed_bwd(kernel, source, fn, max_s, qkv, g, num_heads, q_scale, rate,
                seed, bf16=False, scale_dq_in_fp32=False, stats=None,
                counters=(attention_fwd_bf16, attention_bwd_bf16),
                bf16_source=None):
    """Launch the packed backward `fn` of library `source` on CUDA tensors
    after the kernel's checks, q scaled by q_scale (None: `head_scale`);
    returns dqkv (B, S, 3C). With `bf16` a bf16 qkv and g launch the bf16
    pair (`fn` with the bf16 suffix, of library `bf16_source` (default
    `source`), counted on the second of `counters`) on heads zero-padded
    as `_packed_fwd` pads them, q scaled by
    `bf16_scale(q_scale)` (None: the true Dh ** -0.5), from the forward's
    statistics `stats` (float32 (B, H, S, 2); None: the forward kernel runs
    first for them, one launch more, counted on the first), D in a float32
    (B, H, S) scratch, and dq scaled by q_scale in float32 and rounded once
    where `scale_dq_in_fp32`, else rounded and then scaled by the bf16
    constant (`attention_long_plain_bwd`'s two recipes)."""
    b, s, c3 = qkv.shape
    c = c3 // 3
    dh = c // num_heads
    qkv, g = _aligned(qkv, g)
    device, seed_ptr, threshold, scale = _cuda_args(
        kernel, s, dh, max_s, rate, seed, bf16=bf16, qkv=qkv, g=g)
    if qkv.dtype == torch.bfloat16:
        if stats is None:
            stats = _packed_fwd(kernel, source, fn.replace("_bwd", "_fwd"),
                                max_s, qkv, num_heads, q_scale, rate, seed,
                                bf16, with_stats=True, counter=counters[0],
                                bf16_source=bf16_source)[1]
        elif (stats.shape != (b, num_heads, s, 2)
              or stats.dtype != torch.float32 or stats.device != device):
            raise ValueError(f"{kernel}: stats {tuple(stats.shape)} "
                             f"{stats.dtype} on {stats.device} are not the "
                             f"forward's float32 {(b, num_heads, s, 2)} on "
                             f"{device}")
        stats = stats.contiguous()
        width = padded_head_dim(dh, BF16_HEAD_DIMS)
        true_scale = dh ** -0.5 if q_scale is None else q_scale
        qkv, g = _pad_heads(qkv, dh, width), _pad_heads(g, dh, width)
        dqkv = torch.empty_like(qkv)
        dsum = torch.empty((b, num_heads, s), dtype=torch.float32,
                           device=device)
        keep = keep_bits_scratch(b, num_heads, s, rate, device)
        _native.launch(bf16_source or source, f"{fn}_bf16", device,
                       seed_ptr, qkv.data_ptr(), g.data_ptr(),
                       stats.data_ptr(),
                       dsum.data_ptr(),
                       None if keep is None else keep.data_ptr(),
                       dqkv.data_ptr(), b, s,
                       num_heads * width, num_heads, bf16_scale(true_scale),
                       true_scale if scale_dq_in_fp32
                       else bf16_scale(true_scale),
                       int(not scale_dq_in_fp32), threshold, scale)
        counters[1].launches += 1
        return _unpad_heads(dqkv, dh, width)
    if stats is not None:
        raise TypeError(f"{kernel}: the statistics are the bf16 kernels'; "
                        f"qkv is {qkv.dtype}")
    stats = torch.empty((b, num_heads, s, 3), dtype=torch.float32,
                        device=device)
    if q_scale is None:
        q_scale = head_scale(dh)
    dqkv = torch.empty_like(qkv)
    _native.launch(source, fn, device, seed_ptr, qkv.data_ptr(),
                   g.data_ptr(), dqkv.data_ptr(), stats.data_ptr(), b, s, c,
                   num_heads, q_scale, threshold, scale)
    _count_lanes(dh, attention_lanes_bwd)
    return dqkv


def keep_bits_scratch(batch: int, heads: int, seq_len: int, rate: float,
                      device) -> Optional[torch.Tensor]:
    """The bf16 backward pair's scratch of keep bits at rate > 0 (None at
    rate 0): one bit a score, B H Sp^2 / 32 int32 words with Sp = S rounded
    up to 64 (csrc/attention_tiled.cuh, `keep_group`), drawn by the dq
    kernel and read by both kernels."""
    if rate == 0.0:
        return None
    padded = -(-seq_len // 64) * 64
    return torch.empty(batch * heads * padded * padded // 32,
                       dtype=torch.int32, device=device)


def _check_cotangent(kernel, qkv, g):
    b, s, c3 = qkv.shape
    if g.shape != (b, s, c3 // 3):
        raise ValueError(f"{kernel}: g {tuple(g.shape)} is not "
                         f"{(b, s, c3 // 3)}")


# -- the long-sequence (and wide) entry ----------------------------------------------
def attention_long_qkv(qkv: torch.Tensor, num_heads: int, rate: float = 0.0,
                       seed: Optional[torch.Tensor] = None,
                       q_scale: Optional[float] = None,
                       with_stats: bool = False):
    """The forward kernel at its own boundary: qkv (B, S, 3C) packed
    [k | v | q] -> (B, S, C), q scaled by q_scale (default Dh^-1/2); with
    `with_stats` (bf16 only) (out, stats), stats the float32 (B, H, S, 2)
    (m, 1/l) of each query row that the bf16 backward takes
    (`attention_stats_plain`; out's bits are the same either way). CPU
    tensors take `attention_long_plain` (and `attention_stats_plain`) with
    the same arguments; CUDA tensors launch the kernel (float32 or bf16, in
    bf16 on heads padded to `padded_head_dim`) or raise (S > 2048, a head
    width outside HEAD_DIMS, any other dtype)."""
    _validate_qkv("fused_attention_long", qkv, num_heads, rate, seed)
    if qkv.device.type == "cpu":
        out = attention_long_plain(qkv, num_heads, rate, seed, q_scale)
        if with_stats:
            return out, attention_stats_plain(qkv, num_heads, q_scale)
        return out
    out = _packed_fwd("fused_attention_long", "fused_attention_long",
                      "gpnf_attention_long_fwd", MAX_S_LONG, qkv, num_heads,
                      q_scale, rate, seed, bf16=True, with_stats=with_stats)
    fused_attention_long.launches += 1
    return out


def attention_long_qkv_bwd(qkv: torch.Tensor, g: torch.Tensor, num_heads: int,
                           rate: float = 0.0,
                           seed: Optional[torch.Tensor] = None,
                           q_scale: Optional[float] = None,
                           scale_dq_in_fp32: bool = False,
                           stats: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """The backward kernels at their own boundary: dqkv (B, S, 3C) of
    `attention_long_qkv` for the cotangent g (B, S, C), the mask regenerated
    from `seed`; in bf16 dq by the recipe `scale_dq_in_fp32` names
    (`attention_long_plain_bwd`), from `stats`, the forward's (m, 1/l)
    (`attention_long_qkv(..., with_stats=True)`), which the call computes
    first by the forward kernel where they are not given. CPU tensors take
    `attention_long_plain_bwd` with the same arguments (the stats unused);
    CUDA tensors launch the kernels (float32 or bf16) or raise."""
    _validate_qkv("fused_attention_long_bwd", qkv, num_heads, rate, seed)
    _check_cotangent("fused_attention_long_bwd", qkv, g)
    if qkv.device.type == "cpu" and g.device.type == "cpu":
        return attention_long_plain_bwd(qkv, g, num_heads, rate, seed,
                                        q_scale, scale_dq_in_fp32)
    dqkv = _packed_bwd("fused_attention_long_bwd", "fused_attention_long",
                       "gpnf_attention_long_bwd", MAX_S_LONG, qkv, g,
                       num_heads, q_scale, rate, seed, bf16=True,
                       scale_dq_in_fp32=scale_dq_in_fp32, stats=stats)
    fused_attention_long_bwd.launches += 1
    return dqkv


# -- the projection at S <= MAX_S: qkv = seq w^T, dseq and dW ---------------------
def gemm_tile(m: int, n: int):
    """(BM, BN) of the output tiles attention_gemm.cu takes for an (m x n)
    product, as its `pick_large` chooses them: 128 x 128 where those tiles
    cover the output with no ragged edge and make GEMM_LARGE_MIN_TILES
    blocks, else 64 x 64."""
    bm, bn = GEMM_TILES["large"]
    if m % bm == 0 and n % bn == 0 and (m // bm) * (n // bn) >= \
            GEMM_LARGE_MIN_TILES:
        return bm, bn
    return GEMM_TILES["small"]


def gemm_splits(m: int, n: int, k: int, blocks: int = GEMM_BLOCKS) -> int:
    """How many ranges of K attention_gemm.cu's kernel sums apart for an
    (m x n) product over K = k: one with large tiles (`gemm_tile`: they
    already make a block for nearly every SM) or where the small tiles
    alone make `blocks` blocks, else enough that tiles x splits reaches
    `blocks` (or one split per GEMM_KC chunk of K, where K is shorter),
    each range a whole number of chunks and none empty; `gemm_chunk` gives
    the ranges' length. A pure function of the shape: the same shape
    always sums in the same order.

    `blocks` defaults to GEMM_BLOCKS, 2 x 132, the best single target of
    `python -m gpnf_tpu_torch.bench_attention --kernel gemm`'s sweep on an
    H100 80GB HBM3 at 700 W: the 21 products of its cells summed to 0.9859
    / 0.9171 / 1.0733 / 1.1549 / 1.3798 ms at 132 / 264 / 528 / 1056 /
    2112 blocks (PERF.md, PR 16). The cp.async ring hides a block's loads
    behind its own products, so few blocks an SM fill it, and each split
    more writes and reads back an (m x n) partial. A large-tile product
    split 2 or 3 ways ran 10-30% slower than unsplit."""
    bm, bn = gemm_tile(m, n)
    if (bm, bn) == GEMM_TILES["large"]:
        return 1
    tiles = -(-m // bm) * -(-n // bn)
    if tiles >= blocks:
        return 1
    chunks = -(-k // GEMM_KC)
    per_split = max(1, chunks // -(-blocks // tiles))
    return -(-chunks // per_split)


def gemm_chunk(k: int, splits: int) -> int:
    """The K rows of each split but the last, as attention_gemm.cu computes
    them: a whole number of GEMM_KC chunks."""
    chunks = -(-k // GEMM_KC)
    return GEMM_KC * -(-chunks // splits)


def split_gemm_plain(a: torch.Tensor, b: torch.Tensor,
                     splits: int) -> torch.Tensor:
    """a (m, k) b (k, n) as attention_gemm.cu sums it: each split's K range
    by torch.matmul, then the partials added in split order."""
    chunk = gemm_chunk(a.shape[1], splits)
    out = None
    for k0 in range(0, a.shape[1], chunk):
        part = torch.matmul(a[:, k0:k0 + chunk], b[k0:k0 + chunk])
        out = part if out is None else out + part
    return out


def _gemm(kernel, a, b, shape, m, n, k, trans_a, trans_b, splits=None):
    """c = A B (m x n, A m x k, B k x n) by csrc/attention_gemm.cu on CUDA
    tensors, A read from a transposed where trans_a, B from b where
    trans_b, K cut into `splits` ranges (default `gemm_splits`); c has the
    given shape. Raises unless a and b hold m k and k n values. A strided
    view is copied into a contiguous tensor first; the kernel takes any
    alignment (16-byte copies where every base and row allow them, else
    4-byte ones, with the same bits)."""
    if a.numel() != m * k or b.numel() != k * n or a.dim() != 3:
        raise ValueError(f"{kernel}: {tuple(a.shape)} and {tuple(b.shape)} "
                         f"do not make a product")
    a, b = a.contiguous(), b.contiguous()
    device = _native.check_cuda_inputs(kernel, a=a, b=b)
    if splits is None:
        splits = gemm_splits(m, n, k)
    c = torch.empty(shape, dtype=a.dtype, device=device)
    partial = (torch.empty((splits, m, n), dtype=a.dtype, device=device)
               if splits > 1 else None)
    _native.launch("attention_gemm", "gpnf_attention_gemm", device,
                   a.data_ptr(), b.data_ptr(), c.data_ptr(),
                   None if partial is None else partial.data_ptr(), m, n, k,
                   int(trans_a), int(trans_b), splits)
    return c


def wgmma_tile(n: int) -> int:
    """The output tile's width of the bf16 TMA + wgmma GEMM for n columns,
    as attention_gemm.cu's `wgmma_bn` picks it: 128 where it divides n (the
    CLIs' C 512: n 1536 and 512), else 96 (the flagship's n 288 and 96 in
    whole tiles)."""
    return WGMMA_BN[1] if n % WGMMA_BN[1] == 0 else WGMMA_BN[0]


def wgmma_stages(per: int, blocks: int) -> int:
    """The ring's depth for a grid of `blocks` blocks whose splits are `per`
    k-blocks, as `wgmma_stages` in attention_gemm.cu: per, held to
    WGMMA_STAGES[0] .. WGMMA_STAGES[1] (two blocks an SM), or
    .. WGMMA_STAGES[2] where the grid fits WGMMA_SMS."""
    most = WGMMA_STAGES[2] if blocks <= WGMMA_SMS else WGMMA_STAGES[1]
    return min(max(per, WGMMA_STAGES[0]), most)


def wgmma_cluster(splits: int) -> int:
    """The blocks of a cluster that sums `splits` splits of a tile, as
    attention_gemm.cu's `wgmma_cluster`: 1 unsplit, WGMMA_CLUSTER for a
    multiple of it, WGMMA_PAIR for 2, 4 or 6; 0 for a count the kernel
    refuses."""
    if splits == 1:
        return 1
    if splits % WGMMA_CLUSTER == 0:
        return WGMMA_CLUSTER
    return WGMMA_PAIR if splits in (2, 4, 6) else 0


def wgmma_splits(m: int, n: int, k: int, sms: int = WGMMA_SMS) -> int:
    """How many ranges of K the bf16 TMA + wgmma GEMM sums apart for an
    (m x n) product over K = k, all in its one launch: a multiple of
    WGMMA_CLUSTER, about WGMMA_SPLIT_KB k-blocks a split and at least one
    cluster, the most that keeps tiles x splits within `sms` (one block an
    SM, the deepest ring); else, where the tiles are too many for that, 6,
    4 or 2 (clusters of WGMMA_PAIR) with at least WGMMA_SPLIT_KB k-blocks
    a split; no range empty; one where no count qualifies (the tiles fill
    the card, or K is short). A pure function of the shape: the same shape
    always sums in the same order. The qkv projection never splits (its K
    is C); dseq and dW take it. `python -m gpnf_tpu_torch.bench_attention
    --kernel gemm --dtype bfloat16` sweeps the counts."""
    tiles = -(-m // WGMMA_BM) * -(-n // wgmma_tile(n))
    kb = -(-k // WGMMA_BK)

    def fits(splits):
        return tiles * splits <= sms and (splits - 1) * -(-kb // splits) < kb

    splits = max(WGMMA_CLUSTER, kb // WGMMA_SPLIT_KB // WGMMA_CLUSTER
                 * WGMMA_CLUSTER)
    for splits in range(splits, 0, -WGMMA_CLUSTER):
        if fits(splits):
            return splits
    for splits in (6, 4, 2):
        if kb >= splits * WGMMA_SPLIT_KB and fits(splits):
            return splits
    return 1


def wgmma_per(k: int, splits: int) -> int:
    """The k-blocks of WGMMA_BK of each split but the last."""
    kb = -(-k // WGMMA_BK)
    return -(-kb // splits)


def wgmma_route(a_ptr: int, b_ptr: int, c_ptr: int, lda: int, ldb: int,
                n: int) -> bool:
    """Whether the bf16 GEMM takes the TMA + wgmma kernel: every base on a
    16-byte boundary and the row strides of A, B and c (lda, ldb, n values)
    multiples of 8 values, TMA's rule for a tensor map. Every product on the
    paths meets it (C is 96, 192 or 512; the wrapper allocates c); the rest,
    say C = 20, goes to the kernel of one-value copies
    (`attention_gemm_bf16_unaligned` counts it). A choice by the operands'
    addresses, not a fallback: each kernel raises where it fails."""
    return (a_ptr % 16 == 0 and b_ptr % 16 == 0 and c_ptr % 16 == 0
            and lda % 8 == 0 and ldb % 8 == 0 and n % 8 == 0)


# the arrival counters of the split bf16 GEMM, one int32 for each block rank
# of a cluster of each output tile, for each (device, stream): zeroed once
# when made (or grown), and left zero by every launch (the last cluster to
# arrive resets each). Calls on one stream run in order, so one buffer a
# stream is never shared by two launches at once; the port runs one stream.
_WGMMA_COUNTERS: dict = {}
WGMMA_COUNTERS_MIN = 1024


def wgmma_counters(device: torch.device, tiles: int) -> torch.Tensor:
    """The counters of the current stream of `device`, at least `tiles`."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    buf = _WGMMA_COUNTERS.get(key)
    if buf is None or buf.numel() < tiles:
        buf = torch.zeros(max(tiles, WGMMA_COUNTERS_MIN), dtype=torch.int32,
                          device=device)
        _WGMMA_COUNTERS[key] = buf
    return buf


class GemmBf16Plan(NamedTuple):
    """How the bf16 GEMM runs one product: `route` "wgmma" (the TMA + wgmma
    kernel) or "unaligned" (the kernel of one-value copies), and on the
    wgmma route its output tile's width, the splits of K, the k-blocks of a
    split and the ring's depth. Every plan is one device launch."""
    route: str
    tile: int = 0
    splits: int = 1
    per: int = 0
    stages: int = 0


def gemm_bf16_plan(m: int, n: int, k: int, a_ptr: int, b_ptr: int,
                   c_ptr: int, trans_a: bool, trans_b: bool,
                   splits: Optional[int] = None) -> GemmBf16Plan:
    """The plan of `_gemm_bf16` for an (m x n) product over K = k with
    operands at these addresses (A read from (k x m) where trans_a, B from
    (n x k) where trans_b): `wgmma_route`, `wgmma_tile`, the splits
    (`wgmma_splits` unless given), `wgmma_per` and `wgmma_stages`."""
    if not wgmma_route(a_ptr, b_ptr, c_ptr, m if trans_a else k,
                       k if trans_b else n, n):
        return GemmBf16Plan("unaligned")
    return _wgmma_plan(m, n, k, splits)


@functools.lru_cache(maxsize=None)
def _wgmma_plan(m, n, k, splits):
    """The wgmma route's plan of a shape: a pure function of it, kept so
    that a call's host time does not recompute it."""
    if splits is None:
        splits = wgmma_splits(m, n, k)
    per, tile = wgmma_per(k, splits), wgmma_tile(n)
    blocks = -(-m // WGMMA_BM) * -(-n // tile) * splits
    return GemmBf16Plan("wgmma", tile, splits, per, wgmma_stages(per, blocks))


def _gemm_bf16(kernel, a, b, shape, m, n, k, trans_a, trans_b, out_dtype,
               splits=None):
    """c = A B in bf16 on CUDA tensors, A and B laid out as `_gemm` takes
    them, both bf16; the sums in float32, c (the given shape) bf16, rounded
    once, or float32 (`out_dtype`), as `gemm_bf16_plan` routes it: on
    attention_gemm.cu's TMA + wgmma kernel, K cut into `splits` ranges
    (`wgmma_splits` unless given) summed in its one launch, or on its
    kernel of one-value copies, K unsplit. A strided view is copied into a
    contiguous tensor first."""
    if a.numel() != m * k or b.numel() != k * n or a.dim() != 3:
        raise ValueError(f"{kernel}: {tuple(a.shape)} and {tuple(b.shape)} "
                         f"do not make a product")
    a, b = a.contiguous(), b.contiguous()
    device = _native.check_cuda_inputs(kernel, dtypes=(torch.bfloat16,), a=a,
                                       b=b)
    c = torch.empty(shape, dtype=out_dtype, device=device)
    out_bf16 = int(out_dtype == torch.bfloat16)
    plan = gemm_bf16_plan(m, n, k, a.data_ptr(), b.data_ptr(), c.data_ptr(),
                          trans_a, trans_b, splits)
    if plan.route == "unaligned":
        _native.launch("attention_gemm", "gpnf_attention_gemm_bf16_unaligned",
                       device, a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n,
                       k, int(trans_a), int(trans_b), out_bf16)
        attention_gemm_bf16_unaligned.launches += 1
        return c
    partial = counters = None
    cluster = wgmma_cluster(plan.splits)
    if plan.splits > cluster:  # each cluster's sums, then the last's
        tiles = -(-m // WGMMA_BM) * -(-n // plan.tile)
        partial = torch.empty((plan.splits // cluster, tiles,
                               WGMMA_BM * plan.tile), dtype=torch.float32,
                              device=device)
        counters = wgmma_counters(device, tiles * cluster)
    _native.launch("attention_gemm", "gpnf_attention_gemm_bf16", device,
                   a.data_ptr(), b.data_ptr(), c.data_ptr(),
                   None if partial is None else partial.data_ptr(),
                   None if counters is None else counters.data_ptr(), m, n, k,
                   int(trans_a), int(trans_b), plan.splits, out_bf16)
    return c


def attention_qkv_gemm(seq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """qkv = seq w^T, seq (B, S, C) and w (3C, C) -> (B, S, 3C): the
    projection that `_fwd_kernel_proj` computes in its body, on the wide
    route and in the proj backward. CPU tensors take `qkv_plain`
    (torch.matmul, or `bf16_matmul`); CUDA tensors launch the kernel (a bf16
    pair the bf16 one) or raise."""
    if seq.device.type == "cpu" and w.device.type == "cpu":
        return qkv_plain(seq, w)
    b, s, c = seq.shape
    args = ("attention_qkv_gemm", seq, w, (b, s, w.shape[0]), b * s,
            w.shape[0], c, False, True)
    if seq.dtype == torch.bfloat16:
        out = _gemm_bf16(*args, torch.bfloat16, splits=1)
        attention_qkv_gemm_bf16.launches += 1
    else:
        out = _gemm(*args)
    attention_qkv_gemm.launches += 1
    return out


def attention_dseq_gemm(dqkv: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dseq = dqkv w, dqkv (B, S, 3C) and w (3C, C) -> (B, S, C), as
    `_bwd_kernel_proj` computes it (bf16: float32 sums rounded once). CPU
    tensors take torch.matmul (`bf16_matmul`); CUDA tensors launch the
    kernel (a bf16 pair the bf16 one) or raise."""
    if dqkv.device.type == "cpu" and w.device.type == "cpu":
        return (bf16_matmul(dqkv, w) if dqkv.dtype == torch.bfloat16
                else torch.matmul(dqkv, w))
    b, s, c3 = dqkv.shape
    args = ("attention_dseq_gemm", dqkv, w, (b, s, w.shape[1]), b * s,
            w.shape[1], c3, False, False)
    if dqkv.dtype == torch.bfloat16:
        out = _gemm_bf16(*args, torch.bfloat16)
        attention_dseq_gemm_bf16.launches += 1
    else:
        out = _gemm(*args)
    attention_dseq_gemm.launches += 1
    return out


def attention_dw_gemm(dqkv: torch.Tensor, seq: torch.Tensor) -> torch.Tensor:
    """dW = dqkv^T seq summed over (B, S), dqkv (B, S, 3C) and seq
    (B, S, C) -> (3C, C), as `_bwd_kernel_proj` computes it: float32 for
    bf16 operands too (its dW output; the callers round it to w's dtype, as
    `_vjp_bwd_proj` does). CPU tensors take `dw_plain`; CUDA tensors launch
    the kernel (a bf16 pair the bf16 one) or raise."""
    if dqkv.device.type == "cpu" and seq.device.type == "cpu":
        return dw_plain(dqkv, seq)
    b, s, c3 = dqkv.shape
    args = ("attention_dw_gemm", dqkv, seq, (c3, seq.shape[2]), c3,
            seq.shape[2], b * s, True, False)
    if dqkv.dtype == torch.bfloat16:
        out = _gemm_bf16(*args, torch.float32)
        attention_dw_gemm_bf16.launches += 1
    else:
        out = _gemm(*args)
    attention_dw_gemm.launches += 1
    return out


def _long_project(seq, w):
    """qkv = seq w^T for the long entry: `attention_qkv_gemm` at S <= MAX_S,
    where the JAX package computes it inside `_fwd_kernel_proj`; above, as
    its `fused_attention_long` leaves it to XLA, `qkv_plain`."""
    if seq.shape[1] <= MAX_S:
        return attention_qkv_gemm(seq, w)
    return qkv_plain(seq, w)


def _long_project_bwd(dqkv, seq, w):
    """(dseq, dW) of `_long_project` for the cotangent dqkv."""
    if seq.shape[1] <= MAX_S:
        return (attention_dseq_gemm(dqkv, w),
                attention_dw_gemm(dqkv, seq).to(w.dtype))
    return _project_bwd(dqkv, seq, w)


def _pad_heads(t, head_dim, width):
    """(B, S, n * head_dim) -> (B, S, n * width), every head zero-padded to
    `width` channels; t itself where the two are equal."""
    if width == head_dim:
        return t
    b, s, _ = t.shape
    return F.pad(t.reshape(b, s, -1, head_dim),
                 (0, width - head_dim)).reshape(b, s, -1)


def _unpad_heads(t, head_dim, width):
    """The inverse of `_pad_heads`: each head's first head_dim channels."""
    if width == head_dim:
        return t
    b, s, _ = t.shape
    return t.reshape(b, s, -1, width)[..., :head_dim].reshape(b, s, -1)


def _wide_widths(c, num_heads):
    """(Dh, the width the kernels run, q_scale): the true Dh ** -0.5 where
    the heads are padded, else None, each entry's own default, so that an
    unpadded call is the long entry's as it always was."""
    dh = c // num_heads
    width = padded_head_dim(dh)
    return dh, width, (None if width == dh else dh ** -0.5)


def fused_attention_long_bwd(seq: torch.Tensor, w: torch.Tensor,
                             g: torch.Tensor, num_heads: int,
                             rate: float = 0.0,
                             seed: Optional[torch.Tensor] = None,
                             stats: Optional[torch.Tensor] = None):
    """(dseq, dW) of `fused_attention_long` for the cotangent g: the
    projection recomputed, dqkv from the kernels (heads padded as the
    forward pads them; in bf16 from the forward's `stats` where given),
    then dseq = dqkv w and dW = dqkv^T seq: the GEMM kernels at
    S <= MAX_S, torch.matmul above (the JAX package's `_vjp_bwd_long`)."""
    _validate(seq, w, num_heads, rate, seed, "fused_attention_long_bwd")
    dh, width, q_scale = _wide_widths(seq.shape[2], num_heads)
    dqkv = attention_long_qkv_bwd(
        _pad_heads(_long_project(seq, w), dh, width),
        _pad_heads(g, dh, width), num_heads, rate, seed, q_scale,
        stats=stats)
    return _long_project_bwd(_unpad_heads(dqkv, dh, width).contiguous(),
                             seq, w)


class _AttentionLong(torch.autograd.Function):
    """Saves (seq, w, seed), the residuals of the JAX package's
    `_vjp_fwd_long`: the projection and the mask are recomputed; in bf16
    (`keep_stats`) also the forward's statistics, as `_AttentionProj`."""

    @staticmethod
    def forward(ctx, seq, w, seed, num_heads, rate, keep_stats):
        ctx.num_heads, ctx.rate = num_heads, rate
        dh, width, q_scale = _wide_widths(seq.shape[2], num_heads)
        out = attention_long_qkv(
            _pad_heads(_long_project(seq, w), dh, width), num_heads, rate,
            seed, q_scale, keep_stats)
        if keep_stats:
            out, stats = out
            ctx.save_for_backward(seq, w, seed, stats)
        else:
            ctx.save_for_backward(seq, w, seed)
        return _unpad_heads(out, dh, width)

    @staticmethod
    def backward(ctx, g):
        seq, w, seed, *stats = ctx.saved_tensors
        dseq, dw = fused_attention_long_bwd(seq, w, g.contiguous(),
                                            ctx.num_heads, ctx.rate, seed,
                                            *stats)
        return dseq, dw, None, None, None, None


def fused_attention_long(seq: torch.Tensor, w: torch.Tensor, num_heads: int,
                         rate: float = 0.0,
                         seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`fused_attention_proj`'s function with the projection outside the
    attention kernels: the JAX package's entry for MAX_S < S <= MAX_S_LONG,
    and GatedAttn's wide route wherever `attention_route` says the proj
    kernel does not fit. The projection and dseq / dW are the GEMM kernels
    (`attention_qkv_gemm`, `attention_dseq_gemm`, `attention_dw_gemm`) at
    S <= MAX_S, where the JAX package computes them inside the proj
    kernels, and torch.matmul above, where it leaves them to XLA. A head
    width outside HEAD_DIMS (up to 256) is zero-padded to the next built
    one in q, k, v and g, q scaled by the true Dh^-1/2, and the outputs
    sliced back. Differentiable in seq and w. CPU tensors take the plain
    versions after the same padding; CUDA tensors launch the kernels or
    raise."""
    _validate(seq, w, num_heads, rate, seed, "fused_attention_long")
    return _AttentionLong.apply(seq, w, seed, num_heads, rate,
                                _keeps_stats(seq, w))


# -- the core entries: separate q, k, v, or packed qkv ------------------------------
def _check_one_dtype(kernel, **tensors):
    """Raise unless every operand has the first one's dtype (on every
    device: the plain versions would otherwise mix them)."""
    (first, ref), *rest = tensors.items()
    for arg, t in rest:
        if t.dtype != ref.dtype:
            raise TypeError(f"{kernel}: '{arg}' has dtype {t.dtype}, "
                            f"'{first}' {ref.dtype}; the operands take one "
                            f"dtype")


def _validate_split(kernel, rate, seed, **tensors):
    shapes = {arg: tuple(t.shape) for arg, t in tensors.items()}
    if len(set(shapes.values())) != 1 or len(shapes["q"]) != 4:
        raise ValueError(f"{kernel}: {shapes} are not one (B, H, S, Dh) "
                         f"shape")
    _check_one_dtype(kernel, **tensors)
    _check_rate(kernel, rate, seed)


def _check_seq_len(kernel, seq_len):
    """The core entries' limit on S on the card: the long entry's, whose
    kernels they run."""
    if seq_len > MAX_S_LONG:
        raise ValueError(f"{kernel}: S={seq_len} > {MAX_S_LONG}, beyond the "
                         f"kernel's range")


def _split_padded(kernel, seq_len, head_dim, *tensors):
    """The split kernels' width and operands: Dh zero-padded to the next
    built width as the long entry pads it (`padded_head_dim`, which raises
    above 256), and on bf16 a width of 4 to 8 (rows of 8 bytes take
    neither a tensor map nor the kernels' 16-byte copies;
    `core_bf16_padded` counts those calls); fresh copies where padded.
    q is already scaled, so its zero columns change no score."""
    _check_seq_len(kernel, seq_len)
    width = padded_head_dim(head_dim)
    if width == 4 and tensors[0].dtype == torch.bfloat16:
        core_bf16_padded.launches += 1
        width = 8
    if width == head_dim:
        return width, tensors
    return width, tuple(F.pad(t, (0, width - head_dim)) for t in tensors)


def _attention_forward(q, k, v, rate, seed):
    _validate_split("fused_attention", rate, seed, q=q, k=k, v=v)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return attention_plain(q, k, v, rate, seed)
    b, h, s, dh = q.shape
    width, (q, k, v) = _split_padded("fused_attention", s, dh, q, k, v)
    q, k, v = _aligned(q, k, v)
    device, seed_ptr, threshold, scale = _cuda_args(
        "fused_attention", s, width, MAX_S_LONG, rate, seed, bf16=True, q=q,
        k=k, v=v)
    out = torch.empty_like(q)
    if q.dtype == torch.bfloat16:
        _native.launch("fused_attention_bf16", "gpnf_attention_fwd_bf16",
                       device,
                       seed_ptr, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), b, h, s, width, threshold, scale)
        fused_attention_bf16.launches += 1
    else:
        _native.launch("fused_attention", "gpnf_attention_fwd", device,
                       seed_ptr, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), b, h, s, width, threshold, scale)
        _count_lanes(width, attention_lanes)
    fused_attention.launches += 1
    return out[..., :dh] if width != dh else out


def fused_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        g: torch.Tensor, rate: float = 0.0,
                        seed: Optional[torch.Tensor] = None):
    """(dq, dk, dv) of `fused_attention` for the cotangent g (B, H, S, Dh),
    the forward's mask regenerated from `seed`. CPU tensors take
    `attention_plain_bwd`; CUDA tensors launch the kernels (float32, or
    bf16: the same dq and dK/dV pair on the bf16 values, widened in the
    kernels, dq, dk and dv rounded once; heads padded as the forward pads
    them) or raise."""
    _validate_split("fused_attention_bwd", rate, seed, q=q, k=k, v=v, g=g)
    if all(t.device.type == "cpu" for t in (q, k, v, g)):
        return attention_plain_bwd(q, k, v, g, rate, seed)
    b, h, s, dh = q.shape
    width, (q, k, v, g) = _split_padded("fused_attention_bwd", s, dh, q, k,
                                        v, g)
    q, k, v, g = _aligned(q, k, v, g)
    device, seed_ptr, threshold, scale = _cuda_args(
        "fused_attention_bwd", s, width, MAX_S_LONG, rate, seed, bf16=True,
        q=q, k=k, v=v, g=g)
    bf16 = q.dtype == torch.bfloat16
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    stats = torch.empty((b, h, s, 3), dtype=torch.float32, device=device)
    _native.launch("fused_attention_bf16" if bf16 else "fused_attention",
                   "gpnf_attention_bwd_bf16" if bf16 else "gpnf_attention_bwd",
                   device, seed_ptr, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                   stats.data_ptr(), b, h, s, width, threshold, scale)
    if bf16:
        fused_attention_bwd_bf16.launches += 1
    else:
        _count_lanes(width, attention_lanes_bwd)
    fused_attention_bwd.launches += 1
    if width != dh:
        return dq[..., :dh], dk[..., :dh], dv[..., :dh]
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    """Saves (q, k, v, seed), the residuals of the JAX package's
    `_vjp_fwd`: the mask is regenerated."""

    @staticmethod
    def forward(ctx, q, k, v, seed, rate):
        ctx.save_for_backward(q, k, v, seed)
        ctx.rate = rate
        return _attention_forward(q, k, v, rate, seed)

    @staticmethod
    def backward(ctx, g):
        q, k, v, seed = ctx.saved_tensors
        dq, dk, dv = fused_attention_bwd(q, k, v, g.contiguous(), ctx.rate,
                                         seed)
        return dq, dk, dv, None, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    rate: float = 0.0,
                    seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dropout(softmax(q k^T)) v on q, k, v (B, H, S, Dh), q already scaled;
    `seed` is a (1,) int32 tensor on q's device, read only when rate > 0.
    Differentiable in q, k and v. CPU tensors take the plain versions; CUDA
    tensors launch the kernels (float32 or bf16, one dtype for all three;
    a width the kernels are not built for zero-padded to the next one) or
    raise where the long entry raises (S > MAX_S_LONG, Dh > 256), and for
    any other dtype."""
    return _Attention.apply(q, k, v, seed, rate)


def _attention_qkv_forward(qkv, num_heads, rate, seed, with_stats=False):
    """out, or (out, the bf16 forward's statistics) `with_stats`."""
    _validate_qkv("fused_attention_qkv", qkv, num_heads, rate, seed)
    if qkv.device.type == "cpu":
        out = attention_long_plain(qkv, num_heads, rate, seed)
        if with_stats:
            return out, attention_stats_plain(qkv, num_heads)
        return out
    _check_seq_len("fused_attention_qkv", qkv.shape[1])
    dh, width, q_scale = _wide_widths(qkv.shape[2] // 3, num_heads)
    out = _packed_fwd("fused_attention_qkv", "fused_attention",
                      "gpnf_attention_qkv_fwd", MAX_S_LONG,
                      _pad_heads(qkv, dh, width), num_heads, q_scale, rate,
                      seed, bf16=True, with_stats=with_stats,
                      counter=fused_attention_qkv_bf16,
                      bf16_source="fused_attention_bf16")
    fused_attention_qkv.launches += 1
    if with_stats:
        return _unpad_heads(out[0], dh, width), out[1]
    return _unpad_heads(out, dh, width)


def fused_attention_qkv_bwd(qkv: torch.Tensor, g: torch.Tensor,
                            num_heads: int, rate: float = 0.0,
                            seed: Optional[torch.Tensor] = None,
                            stats: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """dqkv (B, S, 3C), packed [dK | dV | dq * Dh^-1/2], of
    `fused_attention_qkv` for the cotangent g (B, S, C), the mask
    regenerated from `seed`; in bf16 dq scaled in float32 and rounded once
    (`_bwd_kernel_qkv`), from `stats`, the forward's (m, 1/l), which the
    call computes first by the forward kernel where they are not given.
    CPU tensors take `attention_long_plain_bwd` (the stats unused); CUDA
    tensors launch the kernels (float32 or bf16; heads padded as the
    forward pads them) or raise."""
    _validate_qkv("fused_attention_qkv_bwd", qkv, num_heads, rate, seed)
    _check_cotangent("fused_attention_qkv_bwd", qkv, g)
    _check_one_dtype("fused_attention_qkv_bwd", qkv=qkv, g=g)
    if qkv.device.type == "cpu" and g.device.type == "cpu":
        return attention_long_plain_bwd(qkv, g, num_heads, rate, seed,
                                        scale_dq_in_fp32=True)
    _check_seq_len("fused_attention_qkv_bwd", qkv.shape[1])
    dh, width, q_scale = _wide_widths(g.shape[2], num_heads)
    dqkv = _packed_bwd("fused_attention_qkv_bwd", "fused_attention",
                       "gpnf_attention_qkv_bwd", MAX_S_LONG,
                       _pad_heads(qkv, dh, width), _pad_heads(g, dh, width),
                       num_heads, q_scale, rate, seed, bf16=True,
                       scale_dq_in_fp32=True, stats=stats,
                       counters=(fused_attention_qkv_bf16,
                                 fused_attention_qkv_bwd_bf16),
                       bf16_source="fused_attention_bf16")
    fused_attention_qkv_bwd.launches += 1
    return _unpad_heads(dqkv, dh, width)


class _AttentionQkv(torch.autograd.Function):
    """Saves (qkv, seed), the residuals of the JAX package's
    `_vjp_fwd_qkv`: the mask is regenerated; in bf16 (`keep_stats`) also
    the forward's statistics, as `_AttentionProj`."""

    @staticmethod
    def forward(ctx, qkv, seed, num_heads, rate, keep_stats):
        ctx.num_heads, ctx.rate = num_heads, rate
        if not keep_stats:
            ctx.save_for_backward(qkv, seed)
            return _attention_qkv_forward(qkv, num_heads, rate, seed)
        out, stats = _attention_qkv_forward(qkv, num_heads, rate, seed,
                                            with_stats=True)
        ctx.save_for_backward(qkv, seed, stats)
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, seed, *stats = ctx.saved_tensors
        dqkv = fused_attention_qkv_bwd(qkv, g.contiguous(), ctx.num_heads,
                                       ctx.rate, seed, *stats)
        return dqkv, None, None, None, None


def fused_attention_qkv(qkv: torch.Tensor, num_heads: int, rate: float = 0.0,
                        seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dropout(softmax(q k^T / sqrt(Dh))) v over `num_heads` heads of the
    packed qkv (B, S, 3C) laid out [k | v | q] (GatedAttn's in_proj order)
    -> (B, S, C); `seed` as `fused_attention`'s. Differentiable in qkv. CPU
    tensors take the plain versions (`attention_long_plain[_bwd]`, the same
    function); CUDA tensors launch the kernels (float32 or bf16; a width
    the kernels are not built for zero-padded to the next one, q scaled by
    the true Dh^-1/2, as the long entry pads it) or raise where the long
    entry raises (S > MAX_S_LONG, Dh > 256), and for any other dtype."""
    keep_stats = (qkv.dtype == torch.bfloat16 and torch.is_grad_enabled()
                  and qkv.requires_grad)
    return _AttentionQkv.apply(qkv, seed, num_heads, rate, keep_stats)


fused_attention_proj.launches = 0
fused_attention_proj_bwd.launches = 0
fused_attention_long.launches = 0
fused_attention_long_bwd.launches = 0
fused_attention.launches = 0
fused_attention_bwd.launches = 0
fused_attention_qkv.launches = 0
fused_attention_qkv_bwd.launches = 0
attention_qkv_gemm.launches = 0
attention_dseq_gemm.launches = 0
attention_dw_gemm.launches = 0
