"""The arithmetic of the projection GEMMs' tensor-core kernel
(gpnf_tpu_torch/csrc/attention_gemm.cu on mma_tf32.cuh), emulated on the
CPU: K in chunks of GEMM_KC summed apart, k steps of 8 with three 3xTF32
products each, the chunks added in fp32 and the splits of K in split
order; held against the JAX package's projection (`_proj`) and its
gradients, and against `split_gemm_plain`. Also the shared-memory banks
of every fragment load of every layout and tile the source builds, and
the tile constants and tile choice against the source. The kernel itself
is held against torch.matmul on the card by tests/test_torch_cuda.py."""
import importlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpnf_tpu.ops.pallas import fused_attention as jfa
from torch_parity import normal, rng, split, t

fa = importlib.import_module("gpnf_tpu_torch.ops.kernels.fused_attention")

CSRC = Path(fa.__file__).resolve().parents[2] / "csrc"
GEMM = (CSRC / "attention_gemm.cu").read_text()
MMA = (CSRC / "mma_tf32.cuh").read_text()
# (trans_a, trans_b) of the three products: qkv = seq w^T, dseq = dqkv w,
# dW = dqkv^T seq
LAYOUTS = {"qkv": (False, True), "dseq": (False, False), "dw": (True, False)}


def const(name, text=GEMM):
    return int(re.search(rf"constexpr int {name} = ([^;]*);", text)
               .group(1).split("//")[0].strip().replace("gpnf::kTilePad",
                                                       str(const_pad())))


def const_pad():
    return int(re.search(r"constexpr int kTilePad = (\d+);", MMA).group(1))


def tiles():
    """{"large" / "small": (BM, BN, WM, WN, stages)} of the source."""
    return {name: tuple(map(int, re.search(
        rf"using {name.capitalize()} = Tile<(\d+), (\d+), (\d+), (\d+), "
        rf"(\d+)>;", GEMM).groups())) for name in ("large", "small")}


def emulated_gemm(a, b, trans_a=False, trans_b=False, splits=1):
    """c = A B (float32) as attention_gemm.cu's kernel sums it, A = a^T
    where trans_a, B = b^T where trans_b: split z's K range in chunks of
    GEMM_KC, each chunk's k steps of 8 in order with lo*hi, hi*lo, hi*hi
    into fresh accumulators, the chunks added to the split's sum in fp32,
    then the splits' sums added in split order. Every output entry at once
    (an entry's sum does not depend on the tile it falls in); past K the
    kernel's zeros add nothing and are left out."""
    a = (a.t() if trans_a else a).contiguous()
    b = (b.t() if trans_b else b).contiguous()
    ah, al = split(a)
    bh, bl = split(b)
    m, k = a.shape
    chunk = fa.gemm_chunk(k, splits)
    total = None
    for k0 in range(0, k, chunk):
        acc = torch.zeros(m, b.shape[1])
        for c0 in range(k0, min(k, k0 + chunk), fa.GEMM_KC):
            part = torch.zeros_like(acc)
            for s0 in range(c0, min(k, c0 + fa.GEMM_KC), 8):
                step = slice(s0, min(k, s0 + 8))
                for x, y in ((al, bh), (ah, bl), (ah, bh)):
                    part = part + x[:, step] @ y[step]
            acc = acc + part
        total = acc if total is None else total + acc
    return total


def product(name, seq, w, dqkv):
    """(a, b, (m, n, k)) of the named product as the wrappers launch it."""
    b, s, c = seq.shape
    rows = b * s
    return {"qkv": (seq.reshape(rows, c), w, (rows, 3 * c, c)),
            "dseq": (dqkv.reshape(rows, 3 * c), w, (rows, c, 3 * c)),
            "dw": (dqkv.reshape(rows, 3 * c), seq.reshape(rows, c),
                   (3 * c, c, rows))}[name]


@pytest.mark.parametrize("name", sorted(LAYOUTS))
@pytest.mark.parametrize("shape", [(2, 16, 96), (2, 17, 96), (1, 7, 6),
                                   (2, 16, 512)])
def test_emulated_gemms_match_jax(shape, name):
    """The emulated kernel at the split `gemm_splits` gives, against the
    JAX package on the CPU: qkv against `_proj`, dseq and dW against
    jax.vjp of `_proj` for a cotangent dqkv; within 1e-5 of the largest
    |JAX| entry (a float32 sum of up to 3C or B S products)."""
    r = rng(sum(shape))
    batch, s, c = shape
    seq, w = normal(r, (batch, s, c), 0.5), normal(r, (3 * c, c), 0.1)
    dqkv = normal(r, (batch, s, 3 * c))
    qkv, vjp = jax.vjp(jfa._proj, jnp.asarray(seq), jnp.asarray(w))
    dseq, dw = vjp(jnp.asarray(dqkv))
    want = {"qkv": qkv, "dseq": dseq, "dw": dw}[name]
    a, b, (m, n, k) = product(name, t(seq), t(w), t(dqkv))
    got = emulated_gemm(a, b, *LAYOUTS[name], fa.gemm_splits(m, n, k))
    want = np.asarray(want, np.float64).reshape(m, n)
    assert np.abs(got.double().numpy() - want).max() <= \
        1e-5 * np.abs(want).max()


@pytest.mark.parametrize("m,n,k", [(288, 96, 4096), (100, 30, 1000)])
def test_emulated_gemm_matches_split_gemm_plain(m, n, k):
    """Where `gemm_splits` cuts K (dW at the flagship's B 64, S 64; a
    ragged shape), the emulated kernel against the split GEMM's plain
    version (each split by torch.matmul, the splits in order), within 1e-5
    of the largest entry."""
    splits = fa.gemm_splits(m, n, k)
    assert splits > 1
    r = rng(m + n + k)
    a, b = t(normal(r, (k, m))), t(normal(r, (k, n)))
    got = emulated_gemm(a, b, True, False, splits)
    want = fa.split_gemm_plain(a.t(), b, splits)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("tile", ["large", "small"])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_fragment_loads_hit_32_banks(name, tile):
    """Every shared-memory load of the kernel's fragments (lane = 4 gr +
    tg; A by `tile_frag_a` from rows of KC + kTilePad floats or by
    `frag_a_kmajor` from k rows of BM + kOuterPad, B by `tile_frag_bt` or
    `frag_b_kmajor` likewise) touches 32 distinct banks, for every warp, k
    step and accumulator of the layout and tile: no conflicts."""
    trans_a, trans_b = LAYOUTS[name]
    bm, bn, wm_, wn_, _ = tiles()[tile]
    kc, kpad, opad = const("KC"), const("kKPad"), const("kOuterPad")
    lda = bm + opad if trans_a else kc + kpad
    ldb = kc + kpad if trans_b else bn + opad
    b_base = kc * lda if trans_a else bm * lda  # B's tile after A's
    lanes = [(lane >> 2, lane & 3) for lane in range(32)]
    for wm in range(0, bm, wm_):
        for wn in range(0, bn, wn_):
            for kk in range(0, kc, 8):
                loads = []
                for i in range(wm_ // 16):
                    for h in (0, 8):  # a0 / a2 rows gr, a1 / a3 rows gr + 8
                        for q in (0, 4):  # columns k = tg, tg + 4
                            row = lambda gr, tg, i=i, h=h: wm + 16 * i + gr + h
                            col = lambda gr, tg, q=q: kk + tg + q
                            loads.append(
                                (lambda gr, tg, r=row, c=col:
                                 c(gr, tg) * lda + r(gr, tg)) if trans_a else
                                (lambda gr, tg, r=row, c=col:
                                 r(gr, tg) * lda + c(gr, tg)))
                for j in range(wn_ // 8):
                    for q in (0, 4):  # b0, b1: k = tg, tg + 4
                        col = wn + 8 * j
                        loads.append(
                            (lambda gr, tg, c=col, q=q: b_base + (c + gr) * ldb
                             + kk + tg + q) if trans_b else
                            (lambda gr, tg, c=col, q=q: b_base
                             + (kk + tg + q) * ldb + c + gr))
                for load in loads:
                    banks = {load(gr, tg) % 32 for gr, tg in lanes}
                    assert len(banks) == 32, (name, tile, wm, wn, kk)


def test_gemm_constants_match_the_cuda_source():
    """GEMM_TILES, GEMM_KC, GEMM_LARGE_MIN_TILES and GEMM_BLOCKS, which
    `gemm_splits`, `gemm_tile` and the emulation use, are
    attention_gemm.cu's own; the kernel sums each chunk apart and reads
    its fragments with the helpers the bank test models."""
    got = tiles()
    assert {name: v[:2] for name, v in got.items()} == fa.GEMM_TILES
    assert const("KC") == fa.GEMM_KC
    assert const("kLargeMinTiles") == fa.GEMM_LARGE_MIN_TILES
    assert f"GEMM_BLOCKS = {fa.GEMM_BLOCKS // 132}\n// x 132" in GEMM
    assert const("kKPad") == const_pad() == 4 and const("kOuterPad") == 8
    for body in ("for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];",
                 "gpnf::tile_frag_bt<KC>(bs, col, kk + tg)",
                 "gpnf::frag_b_kmajor<S::kLdb>(bs, kk + tg, col)",
                 "gpnf::frag_a_kmajor<S::kLda>(as, kk + tg, row)",
                 "gpnf::tile_frag_a<KC>(as, row, kk + tg)",
                 "gpnf::mma_3xtf32(part[i][j], fa, fb[j]);"):
        assert body in GEMM, body
    for body in ("return frag_a(tile[k * LD + r], tile[k * LD + r + 8],\n"
                 "                tile[(k + 4) * LD + r], tile[(k + 4) * LD "
                 "+ r + 8]);",
                 "return frag_b(tile[k * LD + c], tile[(k + 4) * LD + c]);",
                 "return r * (W + kTilePad) + c;",
                 'asm volatile("cp.async.wait_group %0;" ::"n"(N) : '
                 '"memory");'):
        assert body in MMA, body


@pytest.mark.parametrize("m,n,tile", [
    (16384, 288, "small"), (16384, 96, "small"), (288, 96, "small"),
    (4096, 576, "small"), (4096, 1536, "large"), (4096, 512, "large"),
    (1536, 512, "small"), (1024, 1536, "small"), (4096, 384, "small"),
    (16384, 128, "large"), (16256, 128, "small"), (16320, 128, "small")])
def test_gemm_tile_follows_the_sources_rule(m, n, tile):
    """`gemm_tile` as `pick_large` chooses: 128 x 128 where those tiles
    cover the output with no ragged edge and make kLargeMinTiles blocks,
    else 64 x 64; large tiles run unsplit. The rule's lines are the
    source's."""
    assert fa.gemm_tile(m, n) == fa.GEMM_TILES[tile]
    if tile == "large":
        assert fa.gemm_splits(m, n, 1 << 20) == 1
    for line in ("return m % Large::BM == 0 && n % Large::BN == 0 &&",
                 "static_cast<long long>(m / Large::BM) * (n / Large::BN) >=",
                 "kLargeMinTiles;"):
        assert line in GEMM
