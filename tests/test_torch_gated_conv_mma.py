"""The arithmetic of the fused GatedConv's tensor-core kernels
(gpnf_tpu_torch/csrc/fused_gated_conv.cu on mma_tf32.cuh), emulated on the
CPU: each product of the chain (the conv, the gate, dh, dx, dwg, dw1) as
its kernel sums it, from the im2col index maps of the conv, dx (the
flipped taps) and dw1 gathers, in chunks of GATED_CONV_KC (the conv's
chunks pair elu(v) and elu(-v) of KC / 2 channels), each chunk's k steps
of 8 with three 3xTF32 products into fresh accumulators, the chunks added
in fp32 and the splits of K added in split order; then the paired-column
epilogues. Held against the JAX `fused_gated_conv` and `jax.vjp`, and
against the Pallas `_fwd_kernel` / `_bwd_kernel` in interpret mode, at C
12, 48 and 160 on small images (rate 0), with K unsplit and split (the
source picks the count from the shape; any count sums the same chunks in
order). Also the constants and loop bodies the emulation follows against
the source, and the shared-memory banks of every fragment load of every
product's layout and tile. The kernels themselves, and the tiles, splits
and launches the source picks at the paths' shapes, are held on the card
by tests/test_torch_cuda.py.
"""
import importlib
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gpnf_tpu.ops.pallas import fused_gated_conv as j_fgc
from test_torch_gated_conv import SEED, _pallas
from torch_parity import normal, rng, split, t

fgc = importlib.import_module("gpnf_tpu_torch.ops.kernels.fused_gated_conv")

CSRC = Path(fgc.__file__).resolve().parents[2] / "csrc"
SRC = (CSRC / "fused_gated_conv.cu").read_text()


def _const(name):
    value = re.search(rf"constexpr int {name} = ([^;]*);", SRC).group(1)
    return eval(value.split("//")[0], {})  # "2 * 132", "1 << 24"


KC = _const("KC")  # k rows a chunk
NAMES = ("dx", "dw1", "db1", "dwg", "dbg")
# (B, H, W, C): the issue's widths on a square and a ragged image
CASES = [(2, 4, 4, 12), (2, 5, 7, 12), (2, 4, 4, 48), (2, 5, 7, 48),
         (2, 4, 4, 160), (2, 5, 7, 160)]


def _inputs(b, h, w, c, seed=0):
    r = rng(seed + c)
    return (normal(r, (b, h, w, c)),
            normal(r, (3, 3, 2 * c, c), 1.0 / math.sqrt(18 * c)),
            normal(r, (c,), 0.1), normal(r, (2 * c, 2 * c),
                                         1.0 / math.sqrt(2 * c)),
            normal(r, (2 * c,), 0.1), normal(r, (b, h, w, c)))


# -- the index maps of the gathers ---------------------------------------------
def _taps(flip=False):
    """(tap, (dy, dx)) of the 3 x 3 taps, tap = 3 ky + kx: the conv reads
    pixel (y + ky - 1, x + kx - 1), the transposed conv of dx its flip."""
    for tap in range(9):
        dy, dx = tap // 3 - 1, tap % 3 - 1
        yield tap, ((-dy, -dx) if flip else (dy, dx))


def _neighbour(x, dy, dx):
    """x (B, H, W, C) read at (y + dy, x + dx), zeros outside the image, as
    (B H W, C): the rows a gather copies."""
    b, h, w, c = x.shape
    pad = F.pad(x, (0, 0, 1, 1, 1, 1))
    return pad[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w].reshape(-1, c)


def _concat_elu(v):
    return torch.cat([fgc._elu(v), fgc._elu(-v)], dim=-1)


def _im2col(x):
    """(B H W, 18C): column tap 2C + i is concat_elu(x)[i] at the tap's
    neighbour, the A of the conv and (transposed) of dw1."""
    return torch.cat([_concat_elu(_neighbour(x, dy, dx))
                      for _, (dy, dx) in _taps()], dim=1)


def _im2col_flipped(dh):
    """(B H W, 9C): column tap C + o is dh[o] at the flipped neighbour, the
    A of dx."""
    return torch.cat([_neighbour(dh, dy, dx) for _, (dy, dx) in
                      _taps(flip=True)], dim=1)


def _w1_dx(w1):
    """(9C, 2C): row tap C + o, column i is w1[tap][i][o], the B of dx."""
    return torch.cat([w1[tap // 3, tap % 3].t() for tap in range(9)], dim=0)


# -- the kernels' chunks, in their order ----------------------------------------
def _pad(a, rows, cols):
    out = torch.zeros(rows, cols)
    out[:a.shape[0], :a.shape[1]] = a
    return out


def _row_chunks(a, b):
    """A (m, K) row-major and B (K, n): K in chunks of KC, the last padded
    with zeros (kARows: the gate, dh)."""
    k = a.shape[1]
    return [(_pad(a[:, k0:k0 + KC], a.shape[0], KC),
             _pad(b[k0:k0 + KC], KC, b.shape[1])) for k0 in range(0, k, KC)]


def _conv_chunks(x, w1):
    """The conv: tap by tap, KC / 2 channels of x a chunk, their elu(v) in
    the chunk's first half and elu(-v) in its second, against the rows of
    w1[tap] (2C, C) that multiply them."""
    c, half = x.shape[3], KC // 2
    chunks = []
    for tap, (dy, dx) in _taps():
        xs = _neighbour(x, dy, dx)
        wt = w1[tap // 3, tap % 3]
        for c0 in range(0, c, half):
            v = xs[:, c0:c0 + half]
            k = v.shape[1]
            a, b = torch.zeros(xs.shape[0], KC), torch.zeros(KC, c)
            a[:, :k], a[:, half:half + k] = fgc._elu(v), fgc._elu(-v)
            b[:k], b[half:half + k] = wt[c0:c0 + k], wt[c + c0:c + c0 + k]
            chunks.append((a, b))
    return chunks


def _dx_chunks(dh, w1):
    """dx: tap by tap, C channels of dh in chunks of KC."""
    c = dh.shape[3]
    a, b = _im2col_flipped(dh), _w1_dx(w1)
    return [chunk for tap in range(9) for chunk in _row_chunks(
        a[:, tap * c:(tap + 1) * c], b[tap * c:(tap + 1) * c])]


def _pixel_chunks(a_t, b):
    """A weight gradient: A^T (pixels, m) with a column of ones appended (the
    bias gradient), B (pixels, n); K = pixels in chunks of KC."""
    a_t = torch.cat([a_t, torch.ones(a_t.shape[0], 1)], dim=1)
    return [(_pad(a_t[p0:p0 + KC].t(), a_t.shape[1], KC),
             _pad(b[p0:p0 + KC], KC, b.shape[1]))
            for p0 in range(0, a_t.shape[0], KC)]


def emulate(chunks, splits=1):
    """c = sum of the chunks' A B as the kernel sums it: split z takes the
    chunks [z per, (z + 1) per), per = ceil(chunks / splits); each chunk's
    k steps of 8, lo*hi, hi*lo then hi*hi, into fresh accumulators, the
    chunk added to the split's sum in fp32; the splits added in order."""
    per = -(-len(chunks) // splits)
    total = None
    for s0 in range(0, len(chunks), per):
        acc = None
        for a, b in chunks[s0:s0 + per]:
            (ah, al), (bh, bl) = split(a.contiguous()), split(b.contiguous())
            part = torch.zeros(a.shape[0], b.shape[1])
            for k in range(0, KC, 8):
                for x_, y_ in ((al, bh), (ah, bl), (ah, bh)):
                    part = part + x_[:, k:k + 8] @ y_[k:k + 8]
            acc = part if acc is None else acc + part
        total = acc if total is None else total + acc
    return total


def emulated_forward(x, w1, b1, wg, bg, splits=1):
    """(h, h2, a + bg, sigmoid(g + bg), out) of the chain, each product's K
    in `splits` ranges: the conv's epilogue h = c + b1, h2 = concat_elu(h);
    the gate's paired epilogue."""
    c = x.shape[3]
    h = emulate(_conv_chunks(x, w1), splits) + b1
    h2 = _concat_elu(h)
    ag = emulate(_row_chunks(h2, wg), splits)
    a, sig = ag[:, :c] + bg[:c], torch.sigmoid(ag[:, c:] + bg[c:])
    return h, h2, a, sig, a * sig + x.reshape(-1, c)


def emulated_backward(x, w1, b1, wg, bg, g, splits=1):
    """(dx, dw1, db1, dwg, dbg): the forward again, then dG2 (the gate's
    backward epilogue), dh2 = dG2 wg^T and dh, dh1 and dx, dwg | dbg and dw1
    | db1, each as its kernel sums it, in `splits` ranges of K."""
    c = x.shape[3]
    h, h2, a, sig, _ = emulated_forward(x, w1, b1, wg, bg, splits)
    gf = g.reshape(-1, c)
    dg2 = torch.cat([gf * sig, gf * a * sig * (1.0 - sig)], dim=1)
    dh2 = emulate(_row_chunks(dg2, wg.t()), splits)
    dh = dh2[:, :c] * fgc._delu(h) - dh2[:, c:] * fgc._delu(-h)
    dh1 = emulate(_dx_chunks(dh.reshape(x.shape), w1), splits)
    xf = x.reshape(-1, c)
    dx = dh1[:, :c] * fgc._delu(xf) - dh1[:, c:] * fgc._delu(-xf) + gf
    dwgb = emulate(_pixel_chunks(h2, dg2), splits)
    dw1b = emulate(_pixel_chunks(_im2col(x), dh), splits)
    return (dx.reshape(x.shape), dw1b[:-1].reshape(3, 3, 2 * c, c),
            dw1b[-1], dwgb[:-1], dwgb[-1])


@jax.jit
def _jax_forward_and_vjp(x, w1, b1, wg, bg, g):
    """The JAX fused_gated_conv (rate 0) and its jax.vjp for g, in one
    compiled call."""
    out, vjp = jax.vjp(
        lambda *a: j_fgc.fused_gated_conv(SEED, *a, 0.0, False),
        x, w1, b1, wg, bg)
    return out, vjp(g)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(got.double().numpy() - want).max()
                 / np.abs(want).max())


# -- against the JAX package ----------------------------------------------------
@pytest.mark.parametrize("shape", CASES)
def test_emulated_chain_matches_jax_and_the_pallas_kernels_interpret(shape):
    """Forward within 1e-5 x max(1, max |out|) of the JAX fused_gated_conv
    and of the Pallas `_fwd_kernel`; dx within 1e-5 of its largest entry
    and each weight and bias gradient within 1e-4 of its own largest, of
    jax.vjp and of the Pallas `_bwd_kernel` (the card's bars); every
    product unsplit, then in 3 ranges of K."""
    x, w1, b1, wg, bg, g = _inputs(*shape)
    want, grads = _jax_forward_and_vjp(
        *(jnp.asarray(a) for a in (x, w1, b1, wg, bg, g)))
    pallas_out = _pallas(j_fgc._fwd_kernel, x, w1, b1, wg, bg)
    pallas_grads = _pallas(j_fgc._bwd_kernel, x, w1, b1, wg, bg, g)
    for splits in (1, 3):
        out = emulated_forward(*map(t, (x, w1, b1, wg, bg)),
                               splits)[-1].reshape(shape)
        got = emulated_backward(*map(t, (x, w1, b1, wg, bg, g)), splits)
        for ref in (want, pallas_out):
            scale = max(1.0, float(np.abs(np.asarray(ref)).max()))
            assert float(np.abs(out.numpy() - np.asarray(ref)).max()) <= \
                1e-5 * scale
        for refs in (grads, pallas_grads):
            for name, a, ref in zip(NAMES, got, refs):
                assert _rel(a, ref) <= (1e-5 if name == "dx" else 1e-4), \
                    (name, splits)


@pytest.mark.parametrize("shape", [(2, 4, 4, 12), (2, 5, 7, 160)])
def test_gathers_index_maps_are_the_convs(shape):
    """The im2col maps in float64, exactly: the conv's (neighbour (y + ky -
    1, x + kx - 1), concat_elu) against F.conv2d, dx's (the flipped taps, B
    = w1[tap]^T) against F.conv_transpose2d, dw1's (A^T = im2col^T) against
    torch.nn.grad.conv2d_weight."""
    b, h, w, c = shape
    r = rng(c)
    x = torch.from_numpy(r.standard_normal((b, h, w, c)))
    dh = torch.from_numpy(r.standard_normal((b, h, w, c)))
    w1 = torch.from_numpy(r.standard_normal((3, 3, 2 * c, c)))
    w_oihw = w1.permute(3, 2, 0, 1)
    h1 = _concat_elu(x).permute(0, 3, 1, 2)
    conv = F.conv2d(h1, w_oihw, padding=1).permute(0, 2, 3, 1)
    np.testing.assert_allclose(_im2col(x) @ w1.reshape(18 * c, c),
                               conv.reshape(-1, c), rtol=1e-12, atol=1e-12)
    dh1 = F.conv_transpose2d(dh.permute(0, 3, 1, 2), w_oihw, padding=1)
    np.testing.assert_allclose(_im2col_flipped(dh) @ _w1_dx(w1),
                               dh1.permute(0, 2, 3, 1).reshape(-1, 2 * c),
                               rtol=1e-12, atol=1e-12)
    dw1 = torch.nn.grad.conv2d_weight(h1, w_oihw.shape, dh.permute(0, 3, 1, 2),
                                      padding=1).permute(2, 3, 1, 0)
    np.testing.assert_allclose(_im2col(x).t() @ dh.reshape(-1, c),
                               dw1.reshape(18 * c, c), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("splits", [1, 2, 5])
@pytest.mark.parametrize("name", ["conv", "gate", "dh", "dx", "dwg", "dw1"])
def test_each_emulated_product_matches_float64(name, splits):
    """Each product's chunks, as emulated, within ~fp32 of the same chunks
    summed in float64: (K + 16) 2^-24 of the sum of |a||b|, K the product's
    depth (3xTF32's bound, mma_tf32.cuh), at C 48 on 5 x 7, K in `splits`
    ranges added in order."""
    x, w1, b1, wg, bg, g = map(t, _inputs(2, 5, 7, 48))
    c = 48
    h, h2, a, sig, _ = emulated_forward(x, w1, b1, wg, bg)
    dh = torch.randn(x.shape, generator=torch.Generator().manual_seed(1))
    chunks = {"conv": lambda: _conv_chunks(x, w1),
              "gate": lambda: _row_chunks(h2, wg),
              "dh": lambda: _row_chunks(torch.cat([a, sig], 1), wg.t()),
              "dx": lambda: _dx_chunks(dh, w1),
              "dwg": lambda: _pixel_chunks(h2, torch.cat([a, sig], 1)),
              "dw1": lambda: _pixel_chunks(_im2col(x), dh.reshape(-1, c))}
    parts = chunks[name]()
    got = emulate(parts, splits).double()
    exact = sum(a_.double() @ b_.double() for a_, b_ in parts)
    mass = sum(a_.double().abs() @ b_.double().abs() for a_, b_ in parts)
    depth = KC * len(parts)
    assert bool(((got - exact).abs() <= (depth + 16) * 2.0 ** -24 * mass
                 + 1e-30).all())


# -- the emulation's constants and loop bodies against the source -----------------
def _tiles():
    return {name.lower(): tuple(map(int, re.search(
        rf"using {name} = Tile<(\d+), (\d+), (\d+), (\d+), (\d+)>;",
        SRC).groups())) for name in ("Large", "Wide", "Mid", "Small")}


def test_constants_match_the_cuda_source():
    """The tiles whose banks are checked below, the wrapper's pixel limit,
    and the loop bodies the emulation follows (the conv's KC / 2 channels a
    chunk, fresh accumulators a chunk added in fp32, the splits added in
    order, one exp for elu(v) and elu(-v)) are fused_gated_conv.cu's
    own."""
    assert {k: v[:2] for k, v in _tiles().items()} == {
        "large": (128, 128), "wide": (64, 128), "mid": (64, 96),
        "small": (64, 64)}
    assert KC == 32
    assert _const("kMaxPixels") == fgc.GATED_CONV_MAX_PIXELS
    for body in ("constexpr int KSTEP = AM == kAConv ? KC / 2 : KC;",
                 "for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];",
                 "gpnf::mma_3xtf32(part[i][j], fa, fb[j]);",
                 "concat_elu_at<KC / 2>(as + r * S::kLda + cc + q);",
                 "for (int z = 1; z < splits; ++z) {",
                 "const float e = expf(-fabsf(v)) - 1.f;"):
        assert body in SRC, body


# -- the shared-memory banks of every fragment load ------------------------------
# (A layout, B layout, paired) of each product: A "rows" (BM rows of KC + 4,
# `tile_frag_a`) or "cols" (KC rows of BM + 8, `frag_a_kmajor`); B "kmajor"
# (KC rows of BN + 8, `frag_b_kmajor`) or "trans" (BN rows of KC + 4,
# `tile_frag_bt`)
LAYOUTS = {"conv": ("rows", "kmajor", False), "gate": ("rows", "kmajor", True),
           "dh": ("rows", "trans", True), "dx": ("rows", "trans", True),
           "dwg": ("cols", "kmajor", False), "dw1": ("cols", "kmajor", False)}
# the tiles each product may take (pick_tile: paired never 64 x 96 or 64 x
# 128, dwg never 128 x 128)
TILES = {"conv": ("large", "wide", "mid", "small"),
         "gate": ("large", "small"), "dh": ("large", "small"),
         "dx": ("large", "small"), "dwg": ("wide", "mid", "small"),
         "dw1": ("large", "wide", "mid", "small")}


@pytest.mark.parametrize("name,tile", [(n, tl) for n in LAYOUTS
                                       for tl in TILES[n]])
def test_fragment_loads_hit_32_banks(name, tile):
    """Every load of every fragment (lane = 4 gr + tg), for every warp, k
    step and accumulator, touches 32 distinct banks; the columns of a
    warp's fragment j are (j < NI / 2 ? 0 : BN / 2) + wn + 8 (j mod NI / 2)
    + gr, the pairing of the gate, dh and dx (the same loads unpaired)."""
    a_lay, b_lay, _ = LAYOUTS[name]
    bm, bn, wm_, wn_, _ = _tiles()[tile]
    pad, opad = 4, 8
    lda = bm + opad if a_lay == "cols" else KC + pad
    ldb = KC + pad if b_lay == "trans" else bn + opad
    b_base = KC * lda if a_lay == "cols" else bm * lda
    ni, warps_n = wn_ // 8, bn // wn_
    lanes = [(lane >> 2, lane & 3) for lane in range(32)]
    for warp in range((bm // wm_) * warps_n):
        wm, wn = (warp // warps_n) * wm_, (warp % warps_n) * (wn_ // 2)
        for kk in range(0, KC, 8):
            loads = []
            for i in range(wm_ // 16):
                for hh in (0, 8):
                    for q in (0, 4):
                        if a_lay == "cols":
                            loads.append(lambda gr, tg, i=i, hh=hh, q=q:
                                         (kk + tg + q) * lda + wm + 16 * i
                                         + gr + hh)
                        else:
                            loads.append(lambda gr, tg, i=i, hh=hh, q=q:
                                         (wm + 16 * i + gr + hh) * lda + kk
                                         + tg + q)
            for j in range(ni):
                col = (0 if j < ni // 2 else bn // 2) + wn + 8 * (j % (ni // 2))
                for q in (0, 4):
                    if b_lay == "trans":
                        loads.append(lambda gr, tg, col=col, q=q:
                                     b_base + (col + gr) * ldb + kk + tg + q)
                    else:
                        loads.append(lambda gr, tg, col=col, q=q:
                                     b_base + (kk + tg + q) * ldb + col + gr)
            for load in loads:
                assert len({load(gr, tg) % 32 for gr, tg in lanes}) == 32, (
                    name, tile, warp, kk)
