"""The fused GatedConv in bf16 (MarScfConfig(compute_dtype="bfloat16",
fused_gated_conv=True), `bench.py`'s BENCH_FUSED_GCONV=1 step) against the
JAX package on the CPU.

- The plain bf16 forward and backward against the Pallas `_fwd_kernel` and
  `_bwd_kernel` in interpret mode on bf16 operands at rate 0, on a
  2-program grid, compiled with XLA's `xla_allow_excess_precision` off (as
  tests/test_torch_bf16_train.py: otherwise XLA keeps float32 where the
  kernels round). Bar: that file's, the largest difference within one
  bf16 ulp of the largest |want| and at most 5% of the bf16 elements
  differing (out and dx agree bit for bit at these sizes; the float32
  weight gradients differ only in the order of their sums); db1 is the
  float32 sum of the unrounded dh, as `_bwd_kernel` takes it, and not
  that of bf16(dh).
- The bf16 kernels' arithmetic (csrc/fused_gated_conv.cu with `OpBf16`)
  emulated in their tile order: the conv's chunks of 16 channels (elu(v)
  and elu(-v) rounded to bf16 when staged), every product's k16 steps
  summed into fresh float32 accumulators a 32-deep chunk, the chunks added
  in fp32, splits of K in split order, then the bf16 epilogues, db1 by the
  column sums' row ranges; held to the plain bf16 versions by the same bar
  at C 12, 48 and 160, K unsplit and in 3 ranges.
- The constants and loop bodies the emulation follows against the source,
  and the shared-memory banks of every ldmatrix of every product's bf16
  layout and tile.
- A tiny bf16 model with the flag against the JAX bf16 model with the flag
  on converted weights, by the rules of tests/test_torch_bf16_train.py:
  the loss within half of the JAX bf16-vs-float32 gap (the JAX model's
  fused GatedConv on the Pallas kernel in interpret mode, as on the TPU),
  each gradient tensor within twice the JAX bf16 model's distance from the
  JAX float32 gradient, the whole gradient's L2 within the JAX bf16
  model's (the JAX models on the jnp reference and jax.vjp of it, as off
  the TPU).
- The float32 plain versions keep their bits.

The kernels themselves are held to the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py (phase 21).
"""
import functools
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gpnf_tpu.models.marscf import MarScfConfig as JaxConfig
from gpnf_tpu.models.marscf import MarScfFlow as JaxFlow
from gpnf_tpu.ops.pallas import fused_gated_conv as j_fgc
from gpnf_tpu_torch import convert
from gpnf_tpu_torch.models.marscf import MarScfConfig, MarScfFlow
from gpnf_tpu_torch.ops import kernels
from test_torch_bf16_mma import frag_a, frag_a_trans, ldmatrix_conflicts
from test_torch_bf16_train import EXACT, TINY, _held, top_ulp
from test_torch_gated_conv_mma import (CASES, SRC, _const, _dx_chunks,
                                       _neighbour, _pixel_chunks, _row_chunks,
                                       _taps, _tiles)
from torch_parity import normal, rng

fgc = importlib.import_module("gpnf_tpu_torch.ops.kernels.fused_gated_conv")
BF16 = torch.bfloat16
SEED = jnp.zeros((1,), jnp.int32)
KC = _const("KC")
COL_SPLITS = _const("kColSplits")
NAMES = ("dx", "dw1", "db1", "dwg", "dbg")


def _inputs(b, h, w, c, seed=0):
    """x, w1, b1, wg, bg and a cotangent, rounded to bf16, as numpy
    float32 arrays of bf16 values."""
    r = rng(seed + c)
    arrays = (normal(r, (b, h, w, c)),
              normal(r, (3, 3, 2 * c, c), 1.0 / math.sqrt(18 * c)),
              normal(r, (c,), 0.1),
              normal(r, (2 * c, 2 * c), 1.0 / math.sqrt(2 * c)),
              normal(r, (2 * c,), 0.1), normal(r, (b, h, w, c)))
    return [torch.from_numpy(a).to(BF16).float().numpy() for a in arrays]


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(BF16)


def _held_any(got, want):
    """The bf16 training tests' bar: a bf16 result within one bf16 ulp of
    the largest |want| with at most 5% of its elements differing (`_held`);
    a float32 one (the weight and bias gradients, float32 sums of bf16
    products in another order) within the ulp."""
    if got.dtype == BF16:
        return _held(got, want)
    diff = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert diff.max() <= top_ulp(want), (float(diff.max()), top_ulp(want))


def _interpret_run(kernel, seed, x, w1, b1, wg, bg, g, rate):
    """The JAX `_run` at rate 0 in interpret mode: its pallas_call of
    `kernel` on a grid of 2 batch blocks (1 for an odd batch), without the
    TPU's memory spaces; out (or dx) in x's dtype, the weight gradients
    float32 as `_bwd_kernel` writes them."""
    from jax.experimental import pallas as pl

    assert rate == 0.0
    b, hh, ww, c = x.shape
    programs = 2 if b % 2 == 0 else 1
    xblk = pl.BlockSpec((b // programs, hh, ww, c), lambda i: (i, 0, 0, 0))
    w1s = pl.BlockSpec((3, 3, 2 * c, c), lambda i: (0, 0, 0, 0))
    vec_c = pl.BlockSpec((c,), lambda i: (0,))
    wgs = pl.BlockSpec((2 * c, 2 * c), lambda i: (0, 0))
    vec_2c = pl.BlockSpec((2 * c,), lambda i: (0,))
    specs = [pl.BlockSpec(memory_space=None), xblk, w1s, vec_c, wgs, vec_2c]
    out = jax.ShapeDtypeStruct(x.shape, x.dtype)
    if g is None:
        return pl.pallas_call(
            functools.partial(kernel, rate=0.0), grid=(programs,),
            in_specs=specs, out_specs=xblk, out_shape=out,
            interpret=True)(seed, x, w1, b1, wg, bg)
    f32 = lambda shape: jax.ShapeDtypeStruct(shape, jnp.float32)
    return pl.pallas_call(
        functools.partial(kernel, rate=0.0), grid=(programs,),
        in_specs=specs + [xblk], out_specs=[xblk, w1s, vec_c, wgs, vec_2c],
        out_shape=[out] + [f32(a.shape) for a in (w1, b1, wg, bg)],
        interpret=True)(seed, x, w1, b1, wg, bg, g)


def _pallas_bf16(kernel, x, w1, b1, wg, bg, g=None):
    """`_interpret_run` on bf16 operands, compiled with XLA's excess
    precision off; numpy float32 arrays of its outputs."""
    args = [jnp.asarray(a).astype(jnp.bfloat16) for a in
            ((x, w1, b1, wg, bg) if g is None else (x, w1, b1, wg, bg, g))]
    run = lambda *a: _interpret_run(kernel, SEED, *a[:5],
                                    a[5] if len(a) > 5 else None, 0.0)
    got = jax.jit(run).lower(*args).compile(compiler_options=EXACT)(*args)
    return (np.asarray(got.astype(jnp.float32)) if g is None else
            [np.asarray(a.astype(jnp.float32)) for a in got])


def _dh(x, w1, b1, wg, bg, g):
    """The unrounded float32 dh of `_bwd_kernel` (rate 0), from the plain
    bf16 forward's h, a, sig and bf16(dG2)."""
    _, h, _, a, sig, _ = fgc._forward_math_bf16(x, w1, b1, wg, bg, None)
    c = x.shape[3]
    gf = g.float()
    dg2 = torch.cat([gf * sig, gf * a.float() * sig * (1.0 - sig)],
                    -1).to(BF16)
    dh2 = torch.matmul(dg2.float(), wg.float().t()).to(BF16).float()
    hf = h.float()
    return dh2[..., :c] * fgc._delu(hf) - dh2[..., c:] * fgc._delu(-hf)


# -- the plain bf16 versions against the Pallas kernels -----------------------
@pytest.fixture(scope="module")
def pallas_case():
    """(inputs, the Pallas forward, the Pallas backward) at B 4, 8 x 8, C
    16, rate 0."""
    arrays = _inputs(4, 8, 8, 16)
    return (arrays, _pallas_bf16(j_fgc._fwd_kernel, *arrays[:5]),
            _pallas_bf16(j_fgc._bwd_kernel, *arrays))


def test_plain_bf16_forward_matches_pallas_fwd_kernel(pallas_case):
    arrays, want, _ = pallas_case
    got = kernels.gated_conv_plain(*map(_bf16, arrays[:5]))
    assert got.dtype == BF16
    _held(got, want)


def test_plain_bf16_backward_matches_pallas_bwd_kernel(pallas_case):
    """dx bf16, the weight and bias gradients float32 (dx, dbg: the same
    bits; dw1, db1, dwg: sums in another order); db1 the sum of the
    unrounded dh: within float32's spread of the Pallas db1, where the sum
    of bf16(dh) is not."""
    arrays, _, want = pallas_case
    got = kernels.gated_conv_plain_bwd(*map(_bf16, arrays))
    assert got[0].dtype == BF16 and all(t_.dtype == torch.float32
                                        for t_ in got[1:])
    for name, a, ref in zip(NAMES, got, want):
        _held_any(a, ref)
    dh = _dh(*map(_bf16, arrays)).reshape(-1, 16)
    spread = dh.shape[0] * 2.0 ** -24 * dh.abs().sum(0)
    assert torch.equal(got[2], dh.sum(0))
    assert bool(((got[2] - torch.from_numpy(want[2])).abs() <= spread).all())
    rounded = dh.to(BF16).float().sum(0)
    assert not bool(((rounded - torch.from_numpy(want[2])).abs()
                     <= spread).all())


def test_plain_bf16_backward_is_autograd_of_its_forward_rounded():
    """Through the public entry on the CPU: the autograd function returns
    the plain backward's dx and its float32 weight gradients rounded to
    the weights' bf16, as `_vjp_bwd` rounds them."""
    arrays = _inputs(2, 4, 4, 8, seed=5)
    args = [_bf16(a).requires_grad_() for a in arrays[:5]]
    kernels.fused_gated_conv(*args).backward(_bf16(arrays[5]))
    want = kernels.gated_conv_plain_bwd(*map(_bf16, arrays))
    assert torch.equal(args[0].grad, want[0])
    for arg, ref in zip(args[1:], want[1:]):
        assert arg.grad.dtype == BF16 and torch.equal(arg.grad, ref.to(BF16))


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_float32_plain_versions_keep_their_bits(rate):
    """float32: the formulas of the JAX `_reference` and of `_bwd_kernel` as
    they were, bit for bit."""
    x, w1, b1, wg, bg, g = map(torch.from_numpy, _inputs(2, 5, 7, 12, seed=3))
    seed = torch.tensor([9], dtype=torch.int32)
    scale = (None if rate == 0.0 else torch.where(
        kernels.gated_conv_keep_plain(seed, 2, 24, rate), 1.0 / (1.0 - rate),
        0.0)[:, None, None, :])
    nchw, nhwc = (lambda t_: t_.permute(0, 3, 1, 2),
                  lambda t_: t_.permute(0, 2, 3, 1))
    w_oihw = w1.permute(3, 2, 0, 1)
    h1 = fgc._concat_elu(x)
    h = nhwc(F.conv2d(nchw(h1), w_oihw, padding=1)) + b1
    h2 = fgc._concat_elu(h) * (1.0 if scale is None else scale)
    a, gate = torch.chunk(torch.matmul(h2, wg) + bg, 2, dim=-1)
    sig = torch.sigmoid(gate)
    assert torch.equal(kernels.gated_conv_plain(x, w1, b1, wg, bg, rate,
                                                seed), a * sig + x)
    dg2 = torch.cat([g * sig, g * a * sig * (1.0 - sig)], dim=-1)
    dh2 = torch.matmul(dg2, wg.t()) * (1.0 if scale is None else scale)
    dh = dh2[..., :12] * fgc._delu(h) - dh2[..., 12:] * fgc._delu(-h)
    dh1 = nhwc(F.conv_transpose2d(nchw(dh), w_oihw, padding=1))
    want = (dh1[..., :12] * fgc._delu(x) - dh1[..., 12:] * fgc._delu(-x) + g,
            torch.nn.grad.conv2d_weight(nchw(h1), w_oihw.shape, nchw(dh),
                                        padding=1).permute(2, 3, 1, 0),
            dh.reshape(-1, 12).sum(0), h2.reshape(-1, 24).t()
            @ dg2.reshape(-1, 24), dg2.reshape(-1, 24).sum(0))
    got = kernels.gated_conv_plain_bwd(x, w1, b1, wg, bg, g, rate, seed)
    for name, a_, b_ in zip(NAMES, got, want):
        assert torch.equal(a_, b_), name


# -- the bf16 kernels' arithmetic, emulated in their tile order ---------------
def _r(t_):
    """Rounded to bf16, as float32."""
    return t_.to(BF16).float()


def _elu16(v):
    return _r(fgc._elu(v))


def _conv_chunks(x, w1):
    """The conv: tap by tap, KC / 2 channels of x a chunk, bf16(elu(v)) in
    the chunk's first half and bf16(elu(-v)) in its second, against the
    rows of w1[tap] that multiply them."""
    c, half = x.shape[3], KC // 2
    chunks = []
    for tap, (dy, dx) in _taps():
        xs, wt = _neighbour(x, dy, dx), w1[tap // 3, tap % 3]
        for c0 in range(0, c, half):
            v = xs[:, c0:c0 + half]
            k = v.shape[1]
            a, b = torch.zeros(xs.shape[0], KC), torch.zeros(KC, c)
            a[:, :k], a[:, half:half + k] = _elu16(v), _elu16(-v)
            b[:k], b[half:half + k] = wt[c0:c0 + k], wt[c + c0:c + c0 + k]
            chunks.append((a, b))
    return chunks


def emulate_bf16(chunks, splits=1):
    """c = sum of the chunks' A B as the bf16 kernel sums it: split z takes
    the chunks [z per, (z + 1) per), per = ceil(chunks / splits); each
    chunk's two k16 steps into fresh float32 accumulators (the bf16
    products exact in float32), the chunk added to the split's sum in
    fp32; the splits added in order."""
    per = -(-len(chunks) // splits)
    total = None
    for s0 in range(0, len(chunks), per):
        acc = None
        for a, b in chunks[s0:s0 + per]:
            part = torch.zeros(a.shape[0], b.shape[1])
            for k in range(0, KC, 16):
                part = part + a[:, k:k + 16] @ b[k:k + 16]
            acc = part if acc is None else acc + part
        total = acc if total is None else total + acc
    return total


def emulated_forward_bf16(x, w1, b1, wg, bg, splits=1):
    """(h, h2, a, sig, out) of the bf16 chain (x and the weights bf16
    values in float32): the conv's epilogue h = bf16(bf16(c) + b1), h2 =
    bf16(elu(+-h)); the gate's a = bf16(bf16(c) + bg), g likewise, out =
    bf16(a sigmoid(g) + x)."""
    c = x.shape[3]
    h = _r(_r(emulate_bf16(_conv_chunks(x, w1), splits)) + b1)
    h2 = torch.cat([_elu16(h), _elu16(-h)], dim=1)
    ag = _r(emulate_bf16(_row_chunks(h2, wg), splits))
    a, sig = _r(ag[:, :c] + bg[:c]), torch.sigmoid(_r(ag[:, c:] + bg[c:]))
    return h, h2, a, sig, _r(a * sig + x.reshape(-1, c))


def _column_sums(dh):
    """db1 as the kernel sums it: rows in ranges of ceil(P / kColSplits),
    each range summed in row order, the ranges added in order."""
    per = -(-dh.shape[0] // COL_SPLITS)
    total = None
    for r0 in range(0, dh.shape[0], per):
        acc = torch.zeros(dh.shape[1])
        for row in dh[r0:r0 + per]:
            acc = acc + row
        total = acc if total is None else total + acc
    return total


def emulated_backward_bf16(x, w1, b1, wg, bg, g, splits=1):
    """(dx, dw1, db1, dwg, dbg): the forward again, then dG2 =
    bf16(...), dh2 = bf16(dG2 wg^T), dh in float32 (db1 its column sums),
    bf16(dh) into dx (rounded once) and dw1 (no ones row), dwg | dbg with
    the ones row; each product as its kernel sums it."""
    c = x.shape[3]
    h, h2, a, sig, _ = emulated_forward_bf16(x, w1, b1, wg, bg, splits)
    gf = g.reshape(-1, c)
    dg2 = _r(torch.cat([gf * sig, gf * a * sig * (1.0 - sig)], dim=1))
    dh2 = _r(emulate_bf16(_row_chunks(dg2, wg.t()), splits))
    dh = dh2[:, :c] * fgc._delu(h) - dh2[:, c:] * fgc._delu(-h)
    dh_c = _r(dh)
    dh1 = emulate_bf16(_dx_chunks(dh_c.reshape(x.shape), w1), splits)
    xf = x.reshape(-1, c)
    dx = _r(dh1[:, :c] * fgc._delu(xf) - dh1[:, c:] * fgc._delu(-xf) + gf)
    dwgb = emulate_bf16(_pixel_chunks(h2, dg2), splits)
    im2col = torch.cat([torch.cat([_elu16(v), _elu16(-v)], dim=1) for v in (
        _neighbour(x, dy, dx_) for _, (dy, dx_) in _taps())], dim=1)
    # dw1's rows alone: in bf16 the kernel has no ones row (db1 sums dh)
    dw1 = emulate_bf16(_pixel_chunks(im2col, dh_c), splits)[:-1]
    return (dx.reshape(x.shape), dw1.reshape(3, 3, 2 * c, c),
            _column_sums(dh), dwgb[:-1], dwgb[-1])


@pytest.mark.parametrize("shape", CASES)
def test_emulated_bf16_chain_matches_the_plain_versions(shape):
    """out and dx, dw1, db1, dwg, dbg within the module's bar of the plain
    bf16 versions, every product unsplit, then in 3 ranges of K."""
    arrays = _inputs(*shape)
    tens = [torch.from_numpy(a) for a in arrays]
    want = kernels.gated_conv_plain(*map(_bf16, arrays[:5]))
    want_b = kernels.gated_conv_plain_bwd(*map(_bf16, arrays))
    for splits in (1, 3):
        out = emulated_forward_bf16(*tens[:5], splits)[-1].reshape(shape)
        _held(out.to(BF16), want)
        for name, a, ref in zip(NAMES, emulated_backward_bf16(*tens, splits),
                                want_b):
            _held_any(a.to(ref.dtype), ref)


@pytest.fixture(scope="module")
def emulated_case():
    """The bf16 kernels' results emulated in their tile order at (4, 8, 8,
    48), K in 3 ranges, and their inputs as bf16 tensors."""
    arrays = _inputs(4, 8, 8, 48)
    tens = [torch.from_numpy(a) for a in arrays]
    out = emulated_forward_bf16(*tens[:5], 3)[-1].reshape(arrays[0].shape)
    dx, *grads = emulated_backward_bf16(*tens, 3)
    return (out.to(BF16), dx.to(BF16), *grads), list(map(_bf16, arrays))


def test_bf16_bars_hold_the_emulated_kernels(emulated_case):
    """The emulated kernels within every bar of `gated_conv_bf16_readings`
    (few values of out and dx differ; the weight gradients' sums in
    another order far inside theirs)."""
    got, args = emulated_case
    readings = fgc.gated_conv_bf16_readings(got, *args)
    assert readings["held"], readings
    assert max(readings[n]["over_rss"] for n in NAMES[1:]) < 0.1, readings


@pytest.mark.parametrize("moved", fgc.GATED_CONV_MOVED)
def test_bf16_bars_catch_a_moved_rounding_point(emulated_case, moved):
    """The plain versions with one rounding point moved (h1 unrounded, h
    rounded once, dh2 unrounded, db1 summed from bf16(dh)) or one split's
    pixels left out of the weight gradients fall outside the bars against
    the emulated kernels; the two that leave out and dx alone, through a
    weight gradient's bars (db1 from bf16(dh) through its rms alone)."""
    got, args = emulated_case
    readings = fgc.gated_conv_bf16_readings(got, *args, moved=(moved,))
    assert not readings["held"], readings
    if moved in ("db1_from_rounded_dh", "split_dropped"):
        assert any(readings[n]["over_bar"] > 1.0 or readings[n][
            "rms_over_rss"] > fgc.GATED_CONV_WGRAD_RMS for n in NAMES[1:])


def test_column_sums_cover_every_row_once():
    """db1's row ranges: at most kColSplits of them, none empty, every row
    in exactly one, at the paths' pixel counts and small ones."""
    for pixels in (1, 70, 255, 256, 257, 1024, 16384, 65536):
        per = -(-pixels // COL_SPLITS)
        ranges = [(r0, min(pixels, r0 + per)) for r0 in range(0, pixels, per)]
        assert len(ranges) <= COL_SPLITS and all(a < b for a, b in ranges)
        assert sum(b - a for a, b in ranges) == pixels


# -- the source the emulation follows -----------------------------------------
def test_bf16_constants_and_loop_bodies_match_the_cuda_source():
    """The bf16 policy's chunks of two k16 steps into fresh accumulators on
    the float32 kernel's tiles and chunks (KC, the conv's KC / 2 channels),
    its padding, its rounding points and db1's column sums are
    fused_gated_conv.cu's own."""
    assert KC == 32 and COL_SPLITS == 256
    assert {k: v[:2] for k, v in _tiles().items()} == {
        "large": (128, 128), "wide": (64, 128), "mid": (64, 96),
        "small": (64, 64)}
    policy = SRC[SRC.index("struct OpBf16 {"):]
    policy = policy[:policy.index("\n};\n")]
    for line in ("static constexpr int kKPad = gpnf::kBf16Pad;",
                 "static constexpr int kOuterPad = gpnf::kBf16Pad;",
                 "for (int kk = 0; kk < KC; kk += 16) {",
                 "gpnf::mma_bf16(part[i][j], fa, fb[j][0], fb[j][1]);"):
        assert line in policy, line
    for line in ("constexpr int KSTEP = AM == kAConv ? KC / 2 : KC;",
                 "for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];",
                 "at[0] = from_float<E>(v > 0.f ? v : e);",
                 "const float h = rnd(rnd(v) + __bfloat162float(b1[o]));",
                 "const float e0 = rnd(elu(h)), e1 = rnd(elu(-h));",
                 "const float av = rnd(rnd(a) + __bfloat162float(bg[o]));",
                 "out[i] = __float2bfloat16_rn(av * sig + "
                 "__bfloat162float(x[i]));",
                 "dg2[i + o] = __float2bfloat16_rn(go * sig);",
                 "const float d_lo = rnd(sb ? lo * sb[o] : lo);",
                 "const float dh = d_lo * delu(h) - d_hi * delu(-h);",
                 "dh32[i] = dh;",
                 "WgradOut{dw1, kBf16 ? nullptr : db1, 18 * c, c}",
                 "acc += dh[static_cast<long long>(r) * cols + col];",
                 "const int ones = g.bf16 ? 0 : 1;"):
        assert line in SRC, line


# -- the banks of every ldmatrix of the bf16 layouts --------------------------
def frag_b_rows2(base, ld, lo, hi, k0):
    """Lane addresses (bytes) of `frag_b_bf16_rows2<LD>`: B^T rows (n) lo ..
    lo + 7 and hi .. hi + 7, columns (k) k0 and k0 + 8."""
    return [base + 2 * ((hi if lane >> 4 else lo) * ld + (lane & 7) * ld + k0
                        + (((lane >> 3) & 1) << 3)) for lane in range(32)]


def frag_b_cols2(base, ld, k0, lo, hi):
    """Of `frag_b_bf16_cols2<LD>`: rows (k) k0 .. k0 + 15, columns (n) lo
    and hi."""
    return [base + 2 * ((k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld
                        + (hi if lane >> 4 else lo)) for lane in range(32)]


# (A transposed, B transposed) of each product, and the tiles it may take
# (tests/test_torch_gated_conv_mma.py's TILES)
LAYOUTS = {"conv": (False, False), "gate": (False, False),
           "dh": (False, True), "dx": (False, True), "dwg": (True, False),
           "dw1": (True, False)}
TILES = {"conv": ("large", "wide", "mid", "small"),
         "gate": ("large", "small"), "dh": ("large", "small"),
         "dx": ("large", "small"), "dwg": ("wide", "mid", "small"),
         "dw1": ("large", "wide", "mid", "small")}


def bf16_loads(name, tile):
    """Every fragment load of the bf16 kernel for one product and tile:
    each warp's A fragments and B pairs (fragment j with j + NI / 2, the
    two halves of a paired tile) at k steps 0 and 16 of a chunk, in every
    stage of the ring."""
    trans_a, trans_b = LAYOUTS[name]
    bm, bn, wm_, wn_, stages = _tiles()[tile]
    pad = 8
    lda = bm + pad if trans_a else KC + pad
    ldb = KC + pad if trans_b else bn + pad
    size_a = KC * lda if trans_a else bm * lda
    size_b = bn * ldb if trans_b else KC * ldb
    loads = []
    for stage in range(stages):
        a_base = 2 * stage * (size_a + size_b)
        b_base = a_base + 2 * size_a
        for warp in range((bm // wm_) * (bn // wn_)):
            wm = (warp // (bn // wn_)) * wm_
            wn = (warp % (bn // wn_)) * (wn_ // 2)
            for kk in range(0, KC, 16):
                for i in range(wm_ // 16):
                    loads.append(frag_a_trans(a_base, lda, kk, wm + 16 * i)
                                 if trans_a else
                                 frag_a(a_base, lda, wm + 16 * i, kk))
                for j in range(wn_ // 16):
                    lo, hi = wn + 8 * j, bn // 2 + wn + 8 * j
                    loads.append(frag_b_rows2(b_base, ldb, lo, hi, kk)
                                 if trans_b else
                                 frag_b_cols2(b_base, ldb, kk, lo, hi))
    return loads


@pytest.mark.parametrize("name,tile", [(n, tl) for n in LAYOUTS
                                       for tl in TILES[n]])
def test_bf16_fragment_loads_are_conflict_free(name, tile):
    """Every ldmatrix phase of every warp touches 32 distinct banks (rows
    of KC + 8 or BM / BN + 8 bf16 values, odd multiples of 16 bytes)."""
    loads = bf16_loads(name, tile)
    assert loads and all(ldmatrix_conflicts(a) == 0 for a in loads)


def test_unpadded_bf16_rows_would_conflict():
    """The count is not vacuous: B rows of BN = 64 values with no pad put
    a phase's rows on the same banks."""
    assert ldmatrix_conflicts(frag_b_cols2(0, 64, 0, 0, 32)) > 0


# -- a tiny model with the flag against the JAX bf16 model with the flag ------
@pytest.fixture(scope="module")
def tiny_fused():
    """Every model with fused_gated_conv=True, one batch of 2 at dropout 0:
    the JAX (loss, grads) in float32, in bf16 and in bf16 without XLA's
    excess precision, where off the TPU its fused GatedConv runs the jnp
    `_reference` and jax.vjp of it; the JAX bf16 loss with the fused
    GatedConv through the Pallas `_fwd_kernel` in interpret mode (the
    TPU's path: `_use_kernel` and `_run` patched for this fixture only);
    the port's bf16 (loss, grads) and its fused-entry calls."""
    cfg = dict(TINY, fused_gated_conv=True)
    j32 = JaxFlow(JaxConfig(**cfg, remat=False))
    j16 = JaxFlow(JaxConfig(**cfg, remat=False, compute_dtype="bfloat16"))
    params = jax.device_get(j32.init(jax.random.PRNGKey(0)))
    t16 = MarScfFlow(MarScfConfig(**cfg, compute_dtype="bfloat16"),
                     device="cpu")
    convert.load_jax_params(t16, params)
    r = rng(31)
    x = r.random((2, 3, 8, 8), dtype=np.float32) - 0.5
    noise = r.random((2, 3, 8, 8), dtype=np.float32)
    num_dims = 8 * 8 * 3

    def loss_of(model):
        def loss_fn(p):
            logdet = jnp.full((2,), -math.log(256.0) * num_dims)
            _, obj = model.encode(p, jnp.asarray(x + noise / 256.0), logdet)
            return jnp.mean(-obj / (math.log(2.0) * num_dims))
        return loss_fn

    def grads(model, options=None):
        run = jax.jit(jax.value_and_grad(loss_of(model))).lower(
            params).compile(compiler_options=options)
        loss, g = run(params)
        return float(loss), convert.jax_to_state_dict(jax.device_get(g))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_fgc, "_use_kernel", lambda x: True)
        mp.setattr(j_fgc, "_run", _interpret_run)
        kernel16 = float(jax.jit(loss_of(j16))(params))
    t16.train()
    before = (kernels.fused_gated_conv.launches,
              kernels.fused_gated_conv_bwd.launches)
    loss = torch.mean(t16(torch.from_numpy(x),
                          noise=torch.from_numpy(noise))[1])
    loss.backward()
    calls = (kernels.fused_gated_conv.launches - before[0],
             kernels.fused_gated_conv_bwd.launches - before[1])
    got = {name: p.grad.numpy().copy() for name, p in t16.named_parameters()}
    return (grads(j32), grads(j16), grads(j16, EXACT), kernel16,
            (float(loss.detach()), got), calls)


def test_config_builds_and_the_couplings_run_the_fused_block_in_bf16(
        tiny_fused):
    """The flag reaches every coupling block in bf16 (no refusal), and a
    training step goes through the fused entry once a block each way (on
    the CPU its plain versions: no launch is counted)."""
    cfg = MarScfConfig(**TINY, fused_gated_conv=True,
                       compute_dtype="bfloat16")
    model = MarScfFlow(cfg, device="cpu")
    blocks = [b for m in model.modules() if hasattr(m, "blocks")
              for b in m.blocks]
    assert blocks and all(b.fused_gconv for b in blocks)
    assert tiny_fused[-1] == (0, 0)


def test_tiny_bf16_fused_model_loss_matches_jax(tiny_fused):
    """The loss within half of the JAX bf16-vs-float32 gap of the JAX bf16
    model whose fused GatedConv runs the Pallas kernel (in interpret mode),
    whose roundings the port's follow: at this configuration the same
    bits. The JAX bf16 model on its jnp `_reference` (lax.conv on bf16, its
    own points of rounding) is 1.0e-4 bits/dim from the port, 0.6 of its
    own bf16-vs-float32 gap: that model is the gradients' yardstick
    below, as tests/test_torch_bf16_train.py's rule has it."""
    (loss32, _), _, _, kernel16, (loss, _), _ = tiny_fused
    gap = abs(kernel16 - loss32)
    assert gap > 0.0
    assert abs(loss - kernel16) <= 0.5 * gap, (loss, kernel16, loss32)


def test_tiny_bf16_fused_model_every_gradient_matches_jax(tiny_fused):
    """Each parameter's gradient no further from the JAX float32 gradient
    than twice the JAX bf16 model's (the larger of its two XLA settings'),
    and the whole gradient's L2 distance no more than the JAX bf16
    model's."""
    (_, want32), (_, want16), (_, exact16), _, (_, got), _ = tiny_fused
    assert len(got) > 40 and set(got) <= set(want16)
    err = lambda g, name: float(np.abs(g - want32[name]).max())
    worst = {}
    for name, grad in got.items():
        assert grad.dtype == np.float32
        jax_err = max(err(want16[name], name), err(exact16[name], name))
        worst[name] = err(grad, name) / jax_err if jax_err else (
            0.0 if err(grad, name) == 0.0 else np.inf)
    assert max(worst.values()) <= 2.0, sorted(
        worst.items(), key=lambda kv: -kv[1])[:5]
    l2 = lambda grads: math.sqrt(sum(
        float(((grads[name] - want32[name]) ** 2).sum()) for name in got))
    assert l2(got) <= l2(want16), (l2(got), l2(want16))
