"""The bf16 kernels on TMA and wgmma (csrc/wgmma_bf16.cuh): the projection
GEMM (attention_gemm.cu's `gemm_wgmma_bf16_kernel`) and the attention
forward (attention_wgmma.cuh's `attention_wgmma_fwd_kernel`), checked on
the CPU.

- Layouts: a model of the TMA's 128- and 64-byte swizzles and of the wgmma
  descriptor's addressing (the canonical K-major and MN-major layouts of
  the PTX ISA), held, for each of the three products (qkv: A and B
  K-major; dseq: B N-major; dW: A M-major, B N-major) and every k16 step of
  a stage, to where the kernel's TMA boxes put each element: the
  descriptors' strides and advances are read from the source. Wrong
  strides or advances fail the same model. The staged output tile's
  swizzle too: the TMA store's box, and no bank conflicts in the stores
  that fill it.
- Routes, tiles and splits: `gemm_bf16_plan` at every product of the
  paths (qkv never split; dseq and dW split into whole, non-empty ranges
  of k-blocks, summed in the one launch), the constants and rules against
  the source, C = 20 on the unaligned route.
- Summation order: the kernel's order (each split one float32 sum, the
  splits of a cluster added in split order, the clusters' sums in cluster
  order) emulated against `dw_plain` and the JAX `_bwd_kernel_proj`
  formula for dW.
- The forward: its tiles at each width and rate against the source; q's,
  K's (K-major) and V's (MN-major) boxes at every k16 step under the 64-
  and 128-byte swizzles; the score accumulators repacked as P V's
  register A fragments; each accumulator's Philox word; the rows a block,
  the ring and the shared memory at the paths' shapes.
The kernels themselves are held against the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py."""
import importlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import rng

fa = importlib.import_module("gpnf_tpu_torch.ops.kernels.fused_attention")

CSRC = Path(fa.__file__).resolve().parents[2] / "csrc"
GEMM = (CSRC / "attention_gemm.cu").read_text()
HEADER = (CSRC / "wgmma_bf16.cuh").read_text()


def flat(text):
    """The text with every run of white space one space."""
    return " ".join(text.split())


FLAT = flat(GEMM)


def const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", GEMM).group(1))


BM, BK = const("kWgBM"), const("kWgBK")
ATOM = const("kWgAtom")
SPAN = const("kWgSwizzle")
STORE_COLS = const("kWgStoreCols")
CONSUMERS = const("kWgConsumers")
LBO_K = const("kWgLboK")
# the derived strides, as the source writes them
DERIVED = {"kWgSboK": 8 * SPAN, "kWgSboMn": 8 * SPAN, "kWgLboMn": BK * SPAN,
           "kWgLboK": LBO_K}
EXPRS = {"kWgSboK": "8 * kWgSwizzle", "kWgSboMn": "8 * kWgSwizzle",
         "kWgLboMn": "kWgBK * kWgSwizzle"}
ENV = {"kWgBM": BM, "kWgBK": BK, "kWgAtom": ATOM, "kWgSwizzle": SPAN,
       **DERIVED}
LAYOUTS = {"qkv": (False, False), "dseq": (False, True), "dw": (True, True)}


def swizzle(off, span):
    """The byte a TMA box's byte `off` lands on (from a base aligned to the
    pattern): its 16-byte chunk XORed with bits 7 .. of the offset, span /
    16 chunks (CuTe's Swizzle<3,4,3> for 128 bytes, <2,4,3> for 64)."""
    return off ^ (((off >> 7) & (span // 16 - 1)) << 4)


def desc_read(start, lbo, sbo, span, mn_major, j, kk):
    """The byte wgmma reads for element (j, kk) (j along m or n, kk < 16
    along k) of an operand whose descriptor starts at `start`: the PTX
    ISA's canonical layouts. K-major, rows of `span` bytes along k: ((8, x),
    (8, 2)) : ((span, SBO), (1, 8)) elements; MN-major, rows of `span` bytes
    along m or n: ((span / 2, x), (8, 2)) : ((1, LBO), (span, SBO)) in
    bytes and elements as below. The swizzle XOR applies to the address."""
    if mn_major:
        atom = span // 2
        off = (start + (j // atom) * lbo + 2 * (j % atom) + (kk // 8) * sbo
               + (kk % 8) * span)
    else:
        off = start + (j // 8) * sbo + (j % 8) * span + 2 * kk
    return swizzle(off, span)


def descriptor_args():
    """{("a" or "b", mn_major): (advance a k16 step in bytes, LBO, SBO,
    swizzle bytes)} of the kernel's make_desc calls."""
    out = {}
    for m in re.finditer(
            r"([AB])_MN \? wg::make_desc\((\w)_tile \+ kk \* ([^,]+), (\w+),"
            r"\s+(\w+), wg::kSwizzle(\d+)\)\s+: wg::make_desc\(\w_tile \+ kk "
            r"\* ([^,]+), (\w+), (\w+),\s+wg::kSwizzle(\d+)\)", GEMM):
        op = m.group(2)
        out[(op, True)] = (eval(m.group(3), {}, ENV), ENV[m.group(4)],
                           ENV[m.group(5)], int(m.group(6)))
        out[(op, False)] = (eval(m.group(7), {}, ENV), ENV[m.group(8)],
                            ENV[m.group(9)], int(m.group(10)))
    return out


DESC = descriptor_args()


def tma_k_major(rows):
    """{(row, k): byte} of a K-major stage tile: one box of `rows` rows
    (m or n) by BK values of k, SPAN-byte rows."""
    return {(r, c): swizzle(r * SPAN + 2 * c, SPAN)
            for r in range(rows) for c in range(BK)}


def tma_mn_major(cols):
    """{(j, k): byte} of an MN-major stage tile: boxes of ATOM values of m
    or n by BK rows of k, box b at b LBO."""
    lbo = DERIVED["kWgLboMn"]
    return {(j, r): (j // ATOM) * lbo + swizzle(r * SPAN + 2 * (j % ATOM),
                                                SPAN)
            for j in range(cols) for r in range(BK)}


def operand_mismatches(op, mn_major, rows, first, desc=None):
    """Elements (j, k) of the `rows`-row operand slice from `first` (a
    warpgroup's 64 rows of A, or all of B) that the descriptor reads
    elsewhere than the TMA put them, over every k16 step of the stage."""
    advance, lbo, sbo, span = desc or DESC[(op, mn_major)]
    total = BM if op == "a" else rows
    placed = tma_mn_major(total) if mn_major else tma_k_major(total)
    start0 = (first // ATOM) * DERIVED["kWgLboMn"] if mn_major \
        else first * SPAN
    bad = []
    for step in range(BK // 16):
        start = start0 + step * advance
        for j in range(rows):
            for kk in range(16):
                if desc_read(start, lbo, sbo, span, mn_major, j, kk) != \
                        placed[(first + j, 16 * step + kk)]:
                    bad.append((step, j, kk))
    return bad


def test_constants_and_descriptors_match_the_source():
    """The tile, the boxes and the strides the kernel is written with: a
    stage of BK values is one 128-byte K-major row, an MN-major box's row
    one 128-byte swizzle span too, every tile on the 1024-byte period of the
    pattern; the derived strides as the model reads them; the four
    descriptors (A and B, each major) of the kernel's k16 loop."""
    assert (BM, BK, ATOM, SPAN, CONSUMERS) == (128, 64, 64, 128, 2)
    assert 2 * BK == SPAN and 2 * ATOM == SPAN and BM == 64 * CONSUMERS
    for name, expr in EXPRS.items():
        assert f"constexpr int {name} = {expr};" in GEMM, name
    assert DESC == {("a", False): (32, LBO_K, 1024, 128),
                    ("b", False): (32, LBO_K, 1024, 128),
                    ("a", True): (2048, 8192, 1024, 128),
                    ("b", True): (2048, 8192, 1024, 128)}
    # the warpgroup's slice of A, and the boxes' host-side shapes
    assert flat("(A_MN ? g * (64 / kWgAtom) * kWgLboMn : g * 64 * "
                "kWgSwizzle)") in FLAT
    for enc in ("encode_tmap_2d(&call.ta, a, bf, 2, k, m, m, kWgBK, kWgAtom, "
                "CU_TENSOR_MAP_SWIZZLE_128B)",
                "encode_tmap_2d(&call.ta, a, bf, 2, m, k, k, kWgBM, kWgBK, "
                "CU_TENSOR_MAP_SWIZZLE_128B)",
                "encode_tmap_2d(&call.tb, b, bf, 2, n, k, k, bn, kWgBK, "
                "CU_TENSOR_MAP_SWIZZLE_128B)",
                "encode_tmap_2d(&call.tb, b, bf, 2, k, n, n, kWgBK, kWgAtom, "
                "CU_TENSOR_MAP_SWIZZLE_128B)"):
        assert enc in FLAT, enc
    assert "wg::mma_m64k16<BN, A_MN, B_MN>(acc, da, db, 1);" in GEMM
    # bits of the descriptor: address, LBO, SBO >> 4 at 0, 16, 32; the
    # swizzle at 62 (128 bytes: 1)
    for field in ("((addr & 0x3FFFF) >> 4)", "(lbo >> 4) << 16",
                  "(sbo >> 4) << 32", "(swz) << 62", "kSwizzle128 = 1"):
        assert field in HEADER, field
    for n in (96, 128):
        assert f"wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16" in \
            HEADER


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("bn", fa.WGMMA_BN)
def test_descriptors_read_what_the_tma_wrote(layout, bn):
    """For each product, at each tile width, every element (row, k) of A
    (each warpgroup's 64 rows) and of B at every k16 step of a stage lands,
    by the TMA box's swizzle, at the byte the descriptor reads for it (an
    N-major B of BN 96 is two boxes of 64 columns, wgmma reading 96)."""
    a_mn, b_mn = LAYOUTS[layout]
    for g in range(CONSUMERS):
        assert operand_mismatches("a", a_mn, 64, 64 * g) == []
    assert operand_mismatches("b", b_mn, bn, 0) == []


@pytest.mark.parametrize("mn_major", [False, True])
def test_wrong_strides_or_advances_would_read_elsewhere(mn_major):
    """The model is not vacuous: LBO and SBO swapped, half the k16 advance,
    or the 64-byte swizzle read other bytes than the TMA wrote (on the
    card, LBO and SBO of the N-major operands swapped gave wrong
    products)."""
    advance, lbo, sbo, span = DESC[("b", mn_major)]
    wrong = [(advance // 2, lbo, sbo, span), (advance, lbo, sbo, span // 2)]
    if mn_major:
        wrong.append((advance, sbo, lbo, span))
    else:
        wrong.append((advance, lbo, sbo // 2, span))
    for desc in wrong:
        assert operand_mismatches("b", mn_major, 96, 0, desc), desc


def out_offset(row, col, elem):
    """attention_gemm.cu's `out_offset`: the staged byte of (row, col) of a
    warpgroup's 64 output rows."""
    row_bytes = STORE_COLS * elem
    off = (col // STORE_COLS) * 64 * row_bytes + row * row_bytes + \
        (col % STORE_COLS) * elem
    return swizzle(off, row_bytes)


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("bn", fa.WGMMA_BN)
def test_staged_output_is_the_store_box_and_conflict_free(elem, bn):
    """The staged tile is what the TMA store of each 64 x STORE_COLS box
    reads (its rows one swizzle span: 64 bytes of bf16, 128 of float32),
    and each warp's store of one accumulator pair (8 rows, 4 lanes a row)
    falls on distinct banks where c is bf16 (4 bytes a lane, one
    wavefront); float32 pairs (8 bytes a lane, half-warps of 4 rows, whose
    rows r and r ^ 1 share their two chunks under the 128-byte swizzle) at
    most two ways: dW's 3 or 12 tiles a call, against a split's partial
    sums."""
    assert f"return off ^ (((off >> 7) & kMask) << 4);" in GEMM
    span = STORE_COLS * elem
    assert span in (64, 128)
    box = 64 * span
    for row in range(64):
        for col in range(bn):
            want = (col // STORE_COLS) * box + swizzle(
                row * span + (col % STORE_COLS) * elem, span)
            assert out_offset(row, col, elem) == want
    for warp in range(4):
        for h in range(2):
            for j in range(bn // 8):
                addrs = [out_offset(16 * warp + (lane >> 2) + 8 * h,
                                    8 * j + 2 * (lane & 3), elem)
                         for lane in range(32)]
                width = 2 * elem  # bytes a lane stores
                for half in ((range(32),) if width == 4
                             else (range(16), range(16, 32))):
                    banks = [(addrs[lane] // 4 + w) % 32 for lane in half
                             for w in range(width // 4)]
                    ways = max(banks.count(x) for x in banks)
                    assert ways == (1 if elem == 2 else 2), (warp, h, j)


def test_shared_memory_fits():
    """Every instantiation's shared memory at the shared ring's depth lets
    two blocks share an SM (the kernel's launch bounds ask for two), at the
    deepest ring fits one block's 227 KB, and its staged output and a
    split's partial fit in the ring's shortest depth."""
    for bn in fa.WGMMA_BN:
        for b_cols in (bn, -(-bn // ATOM) * ATOM):  # K- or N-major B
            stage = (BM + b_cols) * BK * 2

            def size(stages):
                return 1024 + stages * stage + 2 * 6 * 8 + 16
            # two blocks an SM (228 KB, 1 KB of it reserved for each)
            assert 2 * (size(fa.WGMMA_STAGES[1]) + 1024) <= 228 * 1024
            assert size(fa.WGMMA_STAGES[2]) <= 232448
            for elem in (2, 4):  # the staged output fits the shortest ring
                assert BM * bn * elem <= fa.WGMMA_STAGES[0] * stage
    assert ("return 1024 + static_cast<size_t>(stages) * kStageBytes + "
            "2 * kWgMaxStages * 8 + 16;") in FLAT
    assert const("kWgBlocksPerSm") == 2


# -- routes, tiles, splits -------------------------------------------------------
# (B, S, C) of the products on the paths: the flagship's 32-px levels (and
# the 64-px levels 1 and 2), the C 192 step, the CLIs' C 512 at the 32-px
# levels
PATH_SHAPES = [(64, 256, 96), (64, 64, 96), (64, 16, 96), (64, 256, 192),
               (64, 64, 192), (64, 16, 192), (16, 256, 512), (16, 64, 512),
               (16, 16, 512)]


def products(b, s, c):
    """(name, m, n, k, trans_a, trans_b, splits) of qkv (never split),
    dseq and dW (split by the rule), as their wrappers call the GEMM."""
    return [("qkv", b * s, 3 * c, c, False, True, 1),
            ("dseq", b * s, c, 3 * c, False, False, None),
            ("dw", 3 * c, c, b * s, True, False, None)]


def test_rules_match_the_source():
    """The Python mirror's constants and rules against attention_gemm.cu:
    the tile, the ring's depth, the block rows and depth."""
    assert (fa.WGMMA_BM, fa.WGMMA_BK) == (BM, BK)
    assert fa.WGMMA_STAGES == (const("kWgMinStages"), const("kWgSharedStages"),
                               const("kWgMaxStages"))
    assert fa.WGMMA_SMS == const("kWgSms") == 132
    assert "int wgmma_bn(int n) { return n % 128 == 0 ? 128 : 96; }" in GEMM
    assert const("kWgCluster") == fa.WGMMA_CLUSTER == 8
    assert const("kWgPair") == fa.WGMMA_PAIR == 2
    assert [fa.wgmma_cluster(s) for s in (1, 2, 3, 4, 6, 8, 10, 16, 24)] == \
        [1, 2, 0, 2, 2, 8, 0, 8, 8]
    assert flat("if (splits % kWgCluster == 0) return kWgCluster; return "
                "splits <= 3 * kWgPair && splits % kWgPair == 0 ? kWgPair : "
                "0;") in FLAT
    assert fa.WGMMA_BN == (96, 128)
    assert [fa.wgmma_tile(n) for n in (288, 96, 1536, 512, 576, 192, 16)] == \
        [96, 96, 128, 128, 96, 96, 96]
    assert [fa.wgmma_stages(p, 384) for p in (1, 2, 3, 4, 6, 43)] == \
        [2, 2, 3, 3, 3, 3]
    assert [fa.wgmma_stages(p, 132) for p in (1, 2, 3, 5, 6, 43)] == \
        [2, 2, 3, 5, 6, 6]
    assert ("const int most = blocks <= kWgSms ? kWgMaxStages : "
            "kWgSharedStages;") in FLAT
    assert ("const int per = splits > 0 ? (kb + splits - 1) / splits : 0;"
            in FLAT)
    assert "wgmma_cluster(splits) == 0 ||" in FLAT
    # one launch a call: the entry launches the one kernel, and no kernel
    # adds the bf16 splits apart
    entry = GEMM[GEMM.index("extern \"C\" int gpnf_attention_gemm_bf16("):]
    entry = entry[:entry.index("\n}\n")]
    assert "<<<" not in entry and "sum_splits" not in entry
    assert "sum_splits_bf16_kernel" not in GEMM


@pytest.mark.parametrize("b,s,c", PATH_SHAPES)
def test_plan_at_the_paths_shapes(b, s, c):
    """Every product of the paths takes the wgmma route on 16-byte aligned
    operands, in whole tiles of n; qkv is never split; where dseq or dW
    split, the splits are a multiple of the cluster, each range is whole
    k-blocks, the ranges cover K, none is empty, and the tiles times the
    splits stay within one block an SM."""
    for name, m, n, k, ta, tb, splits in products(b, s, c):
        plan = fa.gemm_bf16_plan(m, n, k, 256, 512, 1024, ta, tb, splits)
        assert plan.route == "wgmma" and n % plan.tile == 0, (name, plan)
        kb = -(-k // BK)
        if name == "qkv":
            assert plan.splits == 1
        assert plan.per * plan.splits >= kb > plan.per * (plan.splits - 1)
        assert plan.per == fa.wgmma_per(k, plan.splits)
        tiles = -(-m // BM) * (n // plan.tile)
        assert plan.stages == fa.wgmma_stages(plan.per, tiles * plan.splits)
        if plan.splits > 1:
            assert fa.wgmma_cluster(plan.splits) in (fa.WGMMA_PAIR,
                                                     fa.WGMMA_CLUSTER)
            assert tiles * plan.splits <= fa.WGMMA_SMS
        assert fa.gemm_bf16_plan(m, n, k, 256, 512, 1024, ta, tb,
                                 splits) == plan


def test_split_counts_at_the_flagship_and_c512():
    """The splits the rule gives the long-K products: dW at the flagship's
    levels (K = B S = 16,384 / 4,096 / 1,024: 3 tiles, clusters of 8) and
    at C 512 (48 tiles: 2, a pair), dseq at C 512 where the tiles are few;
    one where the tiles fill the card or K is short."""
    got = {(m, n, k): fa.wgmma_splits(m, n, k) for m, n, k in (
        (288, 96, 16384), (288, 96, 4096), (288, 96, 1024),
        (1536, 512, 4096), (1536, 512, 1024), (1536, 512, 256),
        (4096, 512, 1536), (1024, 512, 1536), (256, 512, 1536),
        (16384, 96, 288), (1024, 96, 288))}
    assert list(got.values()) == [32, 8, 8, 2, 2, 1, 1, 2, 8, 1, 1]


@pytest.mark.parametrize("case", ["c20", "shifted", "aligned"])
def test_route_follows_the_operands(case):
    """C = 20 (rows of 40 bytes) and a base off a 16-byte boundary take the
    unaligned route; 16-byte bases with rows of whole 16 bytes the wgmma
    one."""
    if case == "c20":
        plan = fa.gemm_bf16_plan(66, 60, 20, 0, 0, 0, False, True)
    elif case == "shifted":
        plan = fa.gemm_bf16_plan(256, 288, 96, 2, 0, 0, False, True)
    else:
        plan = fa.gemm_bf16_plan(256, 288, 96, 16, 32, 48, False, True)
    assert plan.route == ("wgmma" if case == "aligned" else "unaligned")


# -- summation order ----------------------------------------------------------------
def emulated_wgmma_gemm(a, b, splits=1, out_dtype=torch.bfloat16):
    """c = a b (bf16) as gemm_wgmma_bf16_kernel sums it: each split's range
    of `wgmma_per` k-blocks one float32 sum; the splits of each cluster of
    `wgmma_cluster` blocks added in split order, the clusters' sums in cluster
    order; one rounding (none for float32)."""
    a, b = a.float(), b.float()
    chunk = fa.wgmma_per(a.shape[1], splits) * BK
    parts = [a[:, k0:k0 + chunk] @ b[k0:k0 + chunk]
             for k0 in range(0, a.shape[1], chunk)]
    total = None
    size = fa.wgmma_cluster(splits)
    for c0 in range(0, len(parts), size):
        cluster = parts[c0]
        for part in parts[c0 + 1:c0 + size]:
            cluster = cluster + part
        total = cluster if total is None else total + cluster
    return total.to(out_dtype)


def _bf16_normal(r, shape, scale):
    return torch.from_numpy(r.standard_normal(shape).astype(np.float32)
                            * scale).to(torch.bfloat16)


@pytest.mark.parametrize("b,s,c", [(64, 64, 96), (16, 16, 512),
                                   (16, 64, 512)])
def test_split_dw_sum_against_jax(b, s, c):
    """dW = dqkv^T seq in float32 at split shapes (the flagship's level 1:
    8 splits in one cluster; C 512 at S 16: one split; at S 64: 2, a pair),
    the kernel's order emulated,
    against `dw_plain` and `_bwd_kernel_proj`'s dot_general in jnp within
    K 2^-24 sum |products| (float32 sums of the same products in two
    orders); the split sum is not the unsplit one bit for bit."""
    r = rng(b + s + c)
    seq = _bf16_normal(r, (b, s, c), 0.5)
    dqkv = _bf16_normal(r, (b, s, 3 * c), 0.1)
    d2, s2 = dqkv.reshape(-1, 3 * c), seq.reshape(-1, c)
    splits = fa.wgmma_splits(3 * c, c, b * s)
    got = emulated_wgmma_gemm(d2.t(), s2, splits, torch.float32)
    spread = b * s * 2.0 ** -24 * (d2.float().abs().t() @ s2.float().abs())
    assert bool(((got - fa.dw_plain(dqkv, seq)).abs() <= spread).all())
    jd, js = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
              for x in (d2, s2))
    jdw = jax.lax.dot_general(jd, js, (((0,), (0,)), ((), ())),
                              preferred_element_type=jnp.float32)
    assert bool(((got - torch.from_numpy(np.array(jdw))).abs()
                 <= spread).all())
    if splits > 1:
        assert not torch.equal(got, emulated_wgmma_gemm(d2.t(), s2, 1,
                                                        torch.float32))


# -- the bf16 attention forward (attention_wgmma.cuh) ----------------------------
# One 4-D tensor map over the packed qkv serves q, K and V in boxes of
# kBoxCols values by kKeys rows; q (wgmma's A) and K (S's B) are read
# K-major, V (P V's B) MN-major, and the scores' accumulators become P V's
# register A fragments. Each width and rate has its own tiles (WgFwd).
FWD = (CSRC / "attention_wgmma.cuh").read_text()
FWD_FLAT = flat(FWD)
FWD_WIDTHS = (24, 128, 256)  # the widths built in bf16 (BF16_HEAD_DIMS)
# (B, S, C) of the forward on the paths: the flagship's 32-px levels and
# 64-px level 0, the C 192 step (Dh 48, run 128 wide), the CLIs' C 512 at
# the 32-px levels, C 1024 (Dh 256)
FWD_PATH_SHAPES = [(64, 256, 96), (64, 64, 96), (64, 16, 96), (64, 1024, 96),
                   (64, 64, 192), (16, 256, 512), (16, 64, 512),
                   (16, 16, 512), (4, 256, 1024)]


def c_value(expr, env):
    """A C constant expression of the header (integers, comparisons, &&,
    ||, !, ?:, arithmetic) evaluated in Python."""
    expr = expr.strip()
    depth = 0
    for i, ch in enumerate(expr):
        depth += (ch == "(") - (ch == ")")
        if ch == "?" and depth == 0:
            d, nest = 0, 0
            for j in range(i + 1, len(expr)):
                c = expr[j]
                d += (c == "(") - (c == ")")
                if d == 0 and c == "?":
                    nest += 1
                elif d == 0 and c == ":":
                    if nest == 0:
                        branch = expr[i + 1:j] if c_value(expr[:i], env) \
                            else expr[j + 1:]
                        return c_value(branch, env)
                    nest -= 1
    py = expr.replace("&&", " and ").replace("||", " or ")
    py = re.sub(r"!(?!=)", " not ", py)
    py = re.sub(r"(?<![/])/(?![/])", "//", py)
    return eval(py, {}, env)


def wg_fwd(dh, dropout):
    """WgFwd<DH, DROPOUT>'s constants, evaluated from the header."""
    body = FWD[FWD.index("struct WgFwd {"):]
    body = body[:body.index("\n};")]
    env = {"DH": dh, "DROPOUT": dropout}
    for name, expr in re.findall(
            r"static constexpr (?:int|bool) (\w+) =\s*([^;]*);", body):
        env[name] = c_value(" ".join(expr.split()), env)
    return env


def fwd_consumers(t, batch, s, heads):
    """`wgmma_fwd_consumers`: 2 warpgroups where S is above 64 and 128-row
    blocks give half the SMs a block (and the width takes 2), else 1."""
    blocks = -(-s // 128) * heads * batch
    return 2 if t["kMaxConsumers"] > 1 and s > 64 and blocks >= 132 // 2 \
        else 1


def fwd_bytes(t, consumers, stages):
    """WgFwd::bytes: the alignment slack, the warpgroups' q, the ring and
    its full and empty barriers and q's."""
    return 1024 + consumers * t["kQBytes"] + stages * t["kStageBytes"] + \
        8 * (2 * t["kMaxStages"] + 1)


def fwd_placed(t, operand):
    """{(row, col): byte} where the TMA boxes put a tile: q's 64 rows (a
    column box of 64 rows, loaded kKeys rows at a time, each row one
    swizzle span), or K's or V's kKeys keys; col the head's value."""
    span, cols = t["kSpan"], t["kBoxCols"]
    rows = t["kRows"] if operand == "q" else t["kKeys"]
    box = t["kQBoxBytes"] if operand == "q" else t["kBoxBytes"]
    base = t["kTileBytes"] if operand == "v" else 0
    return {(r, c): base + (c // cols) * box + swizzle(r * span + 2 * (c % cols),
                                                     span)
            for r in range(rows) for c in range(t["kWidth"])}


def fwd_mismatches(t, operand, lbo_sbo_swap=False, span=None):
    """Elements of the operand that the kernel's descriptors read elsewhere
    than the TMA put them, over every k16 step: q and K K-major (step kk at
    column 16 kk, in box 16 kk / kBoxCols, 2 (16 kk % kBoxCols) bytes in),
    V MN-major (step kp 16 kp rows of keys in, each half of the output
    columns NV halves apart)."""
    span = span or t["kSpan"]
    sbo = 8 * span
    placed = fwd_placed(t, operand)
    bad = []
    if operand in ("q", "k"):
        rows = t["kRows"] if operand == "q" else t["kKeys"]
        box = t["kQBoxBytes"] if operand == "q" else t["kBoxBytes"]
        for step in range(t["kWidth"] // 16):
            col = 16 * step
            start = (col // t["kBoxCols"]) * box + 2 * (col % t["kBoxCols"])
            for j in range(rows):
                for kk in range(16):
                    if desc_read(start, 16, sbo, span, False, j, kk) != \
                            placed[(j, col + kk)]:
                        bad.append((step, j, kk))
        return bad
    nv = 1 if t["kWidth"] <= 128 else 2
    lbo = t["kBoxBytes"]
    if lbo_sbo_swap:
        lbo, sbo = sbo, lbo
    for half in range(nv):
        for kp in range(t["kKeys"] // 16):
            start = t["kTileBytes"] + half * (t["kBoxes"] // nv) * \
                t["kBoxBytes"] + kp * 16 * t["kSpan"]
            for n in range(t["kWidth"] // nv):
                for kk in range(16):
                    if desc_read(start, lbo, sbo, span, True, n, kk) != \
                            placed[(16 * kp + kk, half * t["kWidth"] // nv
                                    + n)]:
                        bad.append((half, kp, n, kk))
    return bad


def test_forward_constants_match_the_source():
    """The tiles each width and rate takes, the boxes and descriptors the
    kernel is written with (the layout the tests below model), the tensor
    map's box and swizzle, the 64-byte swizzle's descriptor code."""
    got = {(dh, drop): tuple(wg_fwd(dh, drop)[k] for k in (
        "kWidth", "kSpan", "kBoxCols", "kBoxes", "kKeys", "kMaxConsumers",
        "kMinBlocks", "kPvFromZero"))
        for dh in FWD_WIDTHS for drop in (False, True)}
    assert got == {(24, False): (32, 64, 32, 1, 64, 2, 2, True),
                   (24, True): (32, 64, 32, 1, 32, 1, 3, True),
                   (128, False): (128, 128, 64, 2, 64, 2, 1, False),
                   (128, True): (128, 128, 64, 2, 32, 2, 1, False),
                   (256, False): (256, 128, 64, 4, 32, 1, 1, False),
                   (256, True): (256, 128, 64, 4, 32, 1, 1, False)}
    for line in (
            "return wg::make_desc(q_tile + (col / T::kBoxCols) * "
            "T::kQBoxBytes + 2 * (col % T::kBoxCols), 16, kSbo, kSwz);",
            "return wg::make_desc(ring + st * T::kStageBytes + (col / "
            "T::kBoxCols) * T::kBoxBytes + 2 * (col % T::kBoxCols), 16, "
            "kSbo, kSwz);",
            "return wg::make_desc(ring + st * T::kStageBytes + T::kTileBytes "
            "+ half * (T::kBoxes / NV) * T::kBoxBytes + kp * 16 * T::kSpan, "
            "T::kBoxBytes, kSbo, kSwz);",
            "constexpr uint32_t kSbo = 8 * T::kSpan;",
            "constexpr wg::Swizzle kSwz = T::kSpan == 128 ? wg::kSwizzle128 "
            ": wg::kSwizzle64;",
            "constexpr int NV = W <= 128 ? 1 : 2;",
            "wg::tma_load_4d(base + g * T::kQBytes + c * T::kQBoxBytes + r * "
            "T::kSpan, &tmap, c * T::kBoxCols, 2 * lay.heads + h, i0 + "
            "T::kRows * g + r, b, qbar);",
            "wg::tma_load_4d(k_dst + c * T::kBoxBytes, &tmap, c * "
            "T::kBoxCols, h, t * KT, b, bar);",
            "wg::tma_load_4d(k_dst + T::kTileBytes + c * T::kBoxBytes, &tmap, "
            "c * T::kBoxCols, lay.heads + h, t * KT, b, bar);",
            "const int box[4] = {T::kBoxCols, 1, T::kKeys, 1};",
            "const long long dims[4] = {DH, 3LL * lay.heads, lay.seq_len, "
            "batch};",
            "const long long strides[3] = {DH * 2, row, row * lay.seq_len};",
            "T::kSpan == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : "
            "CU_TENSOR_MAP_SWIZZLE_64B",
            "const uint32_t base = (raw + 1023) & ~1023u;",
            "wg::mma_m64k16<KT, 0, 0>(s, q_desc(kk), k_desc(st, kk), kk > 0);",
            "wg::mma_rs_m64k16<W / NV, 1>(acc[x], pc[kp], v_desc(st, kp, x), "
            "1);",
            "wg::mma_rs_m64k16<W / NV, 1>(pv[x], pc[kp], v_desc(st, kp, x), "
            "kp > 0);"):
        assert line in FWD_FLAT, line
    assert "kSwizzle128 = 1, kSwizzle64 = 2" in HEADER
    for form in ("m64n32k16", "m64n64k16"):
        assert f"wgmma.mma_async.sync.aligned.{form}.f32.bf16.bf16" in HEADER
    # the register-A form: P V at N 32 and 128 (256 as two of 128)
    assert HEADER.count("}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;") == 1
    assert HEADER.count("}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;") == 1
    # the head stride of the map: Dh 24's 48 bytes are a multiple of 16
    assert all(dh * 2 % 16 == 0 for dh in FWD_WIDTHS)


@pytest.mark.parametrize("operand", ["q", "k", "v"])
@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("dh", FWD_WIDTHS)
def test_forward_descriptors_read_what_the_tma_wrote(dh, dropout, operand):
    """For each width and rate, every element of the forward's q tile (S's
    A), its K tile (S's B) and its V tile (P V's B) at every k16 step lands,
    by the TMA box's swizzle (64 bytes at W 32, 128 above), at the byte the
    descriptor reads for it; every box on its swizzle's period."""
    t = wg_fwd(dh, dropout)
    period = 8 * t["kSpan"]
    assert t["kQBoxBytes"] % period == 0 and t["kBoxBytes"] % period == 0
    assert fwd_mismatches(t, operand) == []


@pytest.mark.parametrize("wrong", ["lbo_sbo_swapped", "swizzle_128"])
def test_forward_wrong_descriptors_would_read_elsewhere(wrong):
    """The forward's model is not vacuous: V's LBO and SBO swapped (W 128,
    two boxes of output columns) or W 32's tiles read as 128-byte
    swizzled."""
    if wrong == "lbo_sbo_swapped":
        assert fwd_mismatches(wg_fwd(128, False), "v", lbo_sbo_swap=True)
    else:
        for operand in ("q", "k", "v"):
            assert fwd_mismatches(wg_fwd(24, False), operand, span=128)


def wgmma_c(warp, lane, i):
    """(row, column) of accumulator i of lane `lane` of warp `warp` of a
    warpgroup: the m16n8 C fragment of each n8 block (wgmma_bf16.cuh)."""
    j, e = divmod(i, 4)
    return (16 * warp + lane // 4 + 8 * (e >> 1), 8 * j + 2 * (lane % 4)
            + (e & 1))


def rs_a(warp, lane, reg, half):
    """(row, k) of bf16 `half` of A-fragment register `reg` of a k16 step
    of wgmma's register-A form: a warp's 16 rows as mma.m16n8k16's A."""
    gr, tg = lane // 4, lane % 4
    return (16 * warp + gr + 8 * (reg & 1), 2 * tg + half + 8 * (reg >> 1))


@pytest.mark.parametrize("keys", [32, 64])
def test_score_accumulators_are_the_rs_a_fragments(keys):
    """P's repack: pa[n / 2][2 (n % 2)] packs accumulators 4 n, 4 n + 1 and
    pa[n / 2][2 (n % 2) + 1] 4 n + 2, 4 n + 3 of n8 key block n; each
    packed value sits where P V's A fragment of k16 step n / 2 wants that
    (row, key)."""
    for line in ("pa[n >> 1][2 * (n & 1)] = pack_bf16(s[4 * n], s[4 * n + "
                 "1]);",
                 "pa[n >> 1][2 * (n & 1) + 1] = pack_bf16(s[4 * n + 2], s[4 "
                 "* n + 3]);"):
        assert line in FWD_FLAT, line
    for warp in range(4):
        for lane in range(32):
            for n in range(keys // 8):
                for reg_off, (i0, i1) in enumerate(((4 * n, 4 * n + 1),
                                                    (4 * n + 2, 4 * n + 3))):
                    kp, reg = n >> 1, 2 * (n & 1) + reg_off
                    for half, i in enumerate((i0, i1)):
                        row, key = wgmma_c(warp, lane, i)
                        a_row, a_k = rs_a(warp, lane, reg, half)
                        assert (row, key) == (a_row, 16 * kp + a_k)


def fragment_keep_words(seed, b, h, row0, j):
    """attention_tiled.cuh's `fragment_keep_words` for the 32 lanes of a
    warp: {lane: the four words of its m16n8 fragment of rows row0 ..,
    keys j .. j + 7}, one Philox call a lane and two words traded with
    lane ^ 1."""
    calls = {}
    for lane in range(32):
        gr, tg = lane >> 2, lane & 3
        odd = tg & 1
        calls[lane] = [int(w) for w in fa.philox4x32_10(
            j // 4 + (tg >> 1), row0 + gr + (8 if odd else 0), h, b, seed,
            0)]
    out = {}
    for lane in range(32):
        r, other = calls[lane], calls[lane ^ 1]
        odd = lane & 1
        own0, own1 = (r[2], r[3]) if odd else (r[0], r[1])
        # the even lane sends its z and w, the odd one its x and y
        got0, got1 = (other[2], other[3]) if odd else (other[0], other[1])
        out[lane] = ([got0, got1, own0, own1] if odd
                     else [own0, own1, got0, got1])
    return out


@pytest.mark.parametrize("group", [0, 1])
def test_each_accumulator_draws_todays_keep_word(group):
    """The keep bit of each score accumulator (warpgroup `group` of a block
    at query row i0, warp w, n8 key block n of a tile at key j0) is the
    word of Philox at its own (b, h, row, key): word key & 3 of the call at
    counter (key >> 2, row, h, b), the word `dropout_keep_plain` and the
    bf16 backward draw for that score; the kernel hands the warp's first
    row and the block's first key to `fragment_keep_words`."""
    for line in ("const int row0 = i0 + T::kRows * g + 16 * (warp & 3);",
                 "fragment_keep_words(bits, seed, b, h, row0, j0 + 8 * n, "
                 "lane);",
                 "wgmma_fwd_softmax<false, DROPOUT>(s, pa, m, l, corr_next, "
                 "t * KT, seq_len, seed, b, h, row0, lane, threshold, "
                 "keep_scale);"):
        assert line in FWD_FLAT, line
    seed, b, h, i0, j0 = 987654321, 3, 2, 128, 64
    for warp in range(4):
        row0 = i0 + 64 * group + 16 * warp
        for n in (0, 3, 7):
            words = fragment_keep_words(seed, b, h, row0, j0 + 8 * n)
            for lane in range(32):
                for e in range(4):
                    row, col = wgmma_c(warp, lane, 4 * n + e)
                    row, key = i0 + 64 * group + row, j0 + col
                    want = int(fa.philox4x32_10(key >> 2, row, h, b, seed,
                                                0)[key & 3])
                    assert words[lane][e] == want, (warp, n, lane, e)


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("dh", FWD_WIDTHS)
def test_forward_fit_and_rows_a_block(dh, dropout):
    """At every path shape of the width: the rows a block (two warpgroups
    at the S > 64 levels where 128-row blocks still fill half the card,
    one at the 32-px levels 1 and 2, with dropout at W 32, and at W 256),
    the ring (as many stages as key tiles, at most kMaxStages), and the
    shared memory of the kMinBlocks blocks an SM is asked to hold within
    the H100's 228 KB (227 KB a block, 1 KB each reserved)."""
    assert flat("return most > 1 && seq_len > 64 && blocks >= 132 / 2 ? 2 "
                ": 1;") in FWD_FLAT
    assert flat("return 1024 + static_cast<size_t>(consumers) * kQBytes + "
                "static_cast<size_t>(stages) * kStageBytes + 8 * (2 * "
                "kMaxStages + 1);") in FWD_FLAT
    t = wg_fwd(dh, dropout)
    assert t["kThreads"] == 128 * t["kMaxConsumers"] + 32
    for b, s, c in FWD_PATH_SHAPES:
        width = fa.padded_head_dim(c // 4, fa.BF16_HEAD_DIMS)
        if width != dh:
            continue
        consumers = fwd_consumers(t, b, s, 4)
        want = 2 if (dh == 128 and s > 64) or (
            dh == 24 and not dropout and s > 64) else 1
        assert consumers == want, (b, s, c)
        stages = min(-(-s // t["kKeys"]), t["kMaxStages"])
        size = fwd_bytes(t, consumers, stages)
        assert size <= 232448
        assert t["kMinBlocks"] * (size + 1024) <= 228 * 1024, (b, s, c)


def test_bench_counts_a_tiles_scores_as_the_source():
    """bench_attention's per-score count of the forward's key loop divides
    by the scores a thread holds of a key tile: kKeys / 2 for each
    instantiation of attention_wgmma_fwd_kernel (a warpgroup's 64 rows by
    kKeys keys over 128 threads)."""
    from gpnf_tpu_torch import bench_attention

    for dh in FWD_WIDTHS:
        for drop in (0, 1):
            name = (f"_ZN4gpnf26attention_wgmma_fwd_kernelINS_9PackedQkvILi"
                    f"{dh}EEELb{drop}ELb0EEEv14CUtensorMap_st")
            assert bench_attention.fwd_scores_a_tile(name) == \
                wg_fwd(dh, bool(drop))["kKeys"] // 2
