"""The layout and arithmetic of the bf16 kernels (the GEMM of
gpnf_tpu_torch/csrc/attention_gemm.cu, which computes qkv, dseq and dW,
the attention forward of attention_wgmma.cuh, on TMA and wgmma, and the dq
and dK/dV kernels of attention_tiled.cuh, on mma_bf16.cuh), checked on the
CPU: the shared-memory banks of every ldmatrix fragment load at the padded
row strides the kernels use, at every tile, layout and width, the
constants against the sources, and the kernels' rounding points emulated
in their tile order and held to the plain versions and the JAX package
within the kernels' bars: the forward (q * scale rounded to bf16, p and
its correction as 2^(s log2e - m log2e), the unnormalised P rounded to
bf16, each key tile's P V summed in fp32, and the (m, 1/l) it keeps for
the backward),
the backward (the dq kernel's D pass and dS pass over its key tiles from
the forward's (m, 1/l), dS rounded for dq, the dK/dV kernel's query tiles
with Pd and dS rounded, dq by either recipe; the keep-bit buffer the dq
kernel writes and both kernels read, bit for bit; and why D is sum_j P dP
and not rowsum(g * out)), and the GEMM (each split of K one fp32 sum,
the splits added in order, one rounding, dW in fp32; the ldmatrix banks
of its kernel for operands TMA cannot take). The
padded widths are held to the true ones. The kernels themselves are held
against the plain versions on the card by tests/test_torch_cuda.py and
chip_smoke.py."""
import importlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpnf_tpu.ops.pallas import fused_attention as jfa
from gpnf_tpu_torch.ops import kernels
from torch_parity import rng

fa = importlib.import_module("gpnf_tpu_torch.ops.kernels.fused_attention")

CSRC = Path(fa.__file__).resolve().parents[2] / "csrc"
GEMM = (CSRC / "attention_gemm.cu").read_text()
TILED = (CSRC / "attention_tiled.cuh").read_text()
WGFWD = (CSRC / "attention_wgmma.cuh").read_text()
MMA = (CSRC / "mma_bf16.cuh").read_text()
BF16 = torch.bfloat16


def const(name, text):
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


PAD = const("kBf16Pad", MMA)
GEMM_KC = const("kBf16Kc", GEMM)
# {"large" / "small": (BM, BN, WM, WN, stages)}, the fp32 GEMM's tiles
GEMM_TILES = {name: tuple(map(int, re.search(
    rf"using {name.capitalize()} = Tile<(\d+), (\d+), (\d+), (\d+), "
    rf"(\d+)>;", GEMM).groups())) for name in ("large", "small")}
# (trans_a, trans_b) of the three products: qkv = seq w^T, dseq = dqkv w,
# dW = dqkv^T seq
LAYOUTS = {"qkv": (False, True), "dseq": (False, False), "dw": (True, False)}


def struct(name):
    """The body of `struct name` in attention_tiled.cuh."""
    body = TILED[TILED.index(f"struct {name} {{"):]
    return body[:body.index("};")]


def ternary(expr, width):
    """A tile constant's C expression (`kWidth <= A ? X : ...` or a
    number) at kWidth = width."""
    expr = expr.strip()
    m = re.fullmatch(r"kWidth <= (\d+) \? (\d+) : (.*)", expr)
    if m is None:
        return int(expr)
    return int(m.group(2)) if width <= int(m.group(1)) else ternary(
        m.group(3), width)


def tile_const(struct_name, name, width):
    expr = re.search(rf"static constexpr int {name} =\s*([^;]*);",
                     struct(struct_name)).group(1)
    return ternary(expr, width)


def fwd_width(dh):
    """The bf16 kernels' kWidth: Dh rounded up to a whole k16 step."""
    return -(-dh // 16) * 16


def wgfwd_const(name, width, dropout):
    """A WgFwd<DH, DROPOUT> constant of attention_wgmma.cuh (the forward on
    TMA + wgmma) at kWidth = width: `kWidth <= A && !DROPOUT ? X : Y`."""
    body = WGFWD[WGFWD.index("struct WgFwd {"):]
    expr = re.search(rf"static constexpr int {name} =\s*([^;]*);",
                     body[:body.index("\n};")]).group(1)
    m = re.fullmatch(r"kWidth <= (\d+) && !DROPOUT \? (\d+) : (\d+)",
                     " ".join(expr.split()))
    if m is None:
        return int(expr)
    return int(m.group(2)) if width <= int(m.group(1)) and not dropout \
        else int(m.group(3))


FWD_ROWS = int(re.search(r"static constexpr int kRows = (\d+);",
                         WGFWD).group(1))  # a warpgroup's


def fwd_keys(dh, dropout=False):
    """The forward's key tile: 64 at W 32 and 128 without dropout, else 32."""
    return wgfwd_const("kKeys", fwd_width(dh), dropout)


def dq_keys(dh):
    return tile_const("MmaDqBf16", "kKeys", fwd_width(dh))


def dkv_queries(dh):
    return tile_const("MmaDkvBf16", "kQueries", fwd_width(dh))


FWD_KEYS = fwd_keys(24)
DKV_STAGES = tile_const("MmaDkvBf16", "kStages", 32)


# -- banks --------------------------------------------------------------------
def ldmatrix_conflicts(byte_addrs):
    """The bank conflicts of one ldmatrix.x4: its four phases each read the
    16-byte rows that lanes 8j .. 8j + 7 address; a phase is conflict-free
    when its 8 rows cover the 32 banks once."""
    assert all(a % 16 == 0 for a in byte_addrs), "ldmatrix rows are 16 bytes"
    worst = 0
    for j in range(4):
        banks = [(a // 4 + w) % 32 for a in byte_addrs[8 * j: 8 * j + 8]
                 for w in range(4)]
        worst = max(worst, len(banks) - len(set(banks)))
    return worst


def frag_a(base, ld, r0, c0):
    """Lane addresses (bytes) of `frag_a_bf16<LD>`."""
    return [base + 2 * ((r0 + (lane & 15)) * ld + c0 + ((lane >> 4) << 3))
            for lane in range(32)]


def frag_b_pair(base, ld, n0, c0):
    """Of `frag_b_bf16_pair<LD>`."""
    return [base + 2 * ((n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + c0 +
                        (((lane >> 3) & 1) << 3)) for lane in range(32)]


def frag_b_trans_pair(base, ld, k0, c0):
    """Of `frag_b_bf16_trans_pair<LD>`."""
    return [base + 2 * ((k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld +
                        c0 + ((lane >> 4) << 3)) for lane in range(32)]


def test_constants_match_the_sources():
    assert PAD == 8 and GEMM_KC % 16 == 0 and FWD_KEYS % 16 == 0
    assert "struct MmaFwdBf16" not in TILED
    assert (GEMM_KC, FWD_KEYS, FWD_ROWS) == (32, 64, 64)
    assert GEMM_TILES == {"large": (128, 128, 64, 32, 3),
                          "small": (64, 64, 32, 32, 3)}
    assert {k: v[:2] for k, v in GEMM_TILES.items()} == fa.GEMM_TILES
    # the packed bf16 entries (the long one's and `fused_attention_qkv`'s)
    # call the headers' helpers, which take the widths built in bf16
    for helper in ("attention_packed_fwd_bf16", "attention_packed_bwd_bf16"):
        body = WGFWD[WGFWD.index(f"inline int {helper}("):]
        body = body[:body.index("\n}\n")]
        cases = tuple(int(x) for x in re.findall(r"case (\d+):", body))
        assert cases == fa.BF16_HEAD_DIMS == (24, 128, 256), helper
        for cu in ("fused_attention_long.cu", "fused_attention_bf16.cu"):
            assert f"gpnf::{helper}(" in (CSRC / cu).read_text(), (cu, helper)
    assert "gpnf_attention_gemm_bf16" in GEMM
    assert "m16n8k16.row.col.f32.bf16.bf16.f32" in MMA
    # the tiles by width: keys of the forward (without and with dropout)
    # and of dq, queries of dK/dV
    assert [fwd_keys(d) for d in fa.BF16_HEAD_DIMS] == [64, 64, 32]
    assert [fwd_keys(d, True) for d in fa.BF16_HEAD_DIMS] == [32, 32, 32]
    assert [dq_keys(d) for d in fa.BF16_HEAD_DIMS] == [64, 32, 16]
    assert [dkv_queries(d) for d in fa.BF16_HEAD_DIMS] == [64, 32, 16]
    # dK/dV: a warp to 16 keys (two at W 256, half the columns each), 64
    # keys a block, the query tiles in a ring of DKV_STAGES
    assert [tile_const("MmaDkvBf16", "kColSplit", fwd_width(d))
            for d in fa.BF16_HEAD_DIMS] == [1, 1, 2]
    assert (tile_const("MmaDkvBf16", "kKeys", 32), DKV_STAGES) == (64, 2)
    assert "static constexpr int kWarps = 4 * kColSplit;" in struct(
        "MmaDkvBf16")
    # the keep-bit buffer's rows and keys, S rounded up to a whole tile of
    # either kernel (64), as `keep_bits_scratch` sizes it
    assert "return (seq_len + 63) / 64 * 64;" in TILED
    assert fa.keep_bits_scratch(2, 4, 100, 0.2, "cpu").numel() == \
        2 * 4 * 128 * 128 // 32
    assert fa.keep_bits_scratch(2, 4, 100, 0.0, "cpu") is None
    # the rounding points the emulations below model: the backward's
    for line in ("x = __bfloat162float(__float2bfloat16_rn(x));",
                 "pack_bf16(x * dq_scale, y * dq_scale);",
                 "fmaf(expf(s[n][e] - m[e >> 1]), dp[n][e], dpart[e >> 1]);",
                 "big_d[r] = dt * inv_l[r];",
                 "expf(sx[n][e] - (odd ? ml.z : ml.x)) * (odd ? ml.w : ml.y);",
                 "pd = kept ? p * keep_scale : 0.f;",
                 "dx[n][e] = p * (dpv - (odd ? dd.y : dd.x));",
                 "scale_rows_bf16<LD>(q_t, QT, DH, q_scale, T::kThreads);",
                 "d[x][e] = expf(s[2 * kp + x][e] - m[r]) * inv_l[r] *"):
        assert line in TILED, line
    # the forward's: q * q_scale rounded once in shared memory, p and corr
    # as one FFMA and one ex2 (q comes scaled), pd rounded for P V, each
    # tile's P V from zero (W 32) or in place (wider), out = acc / l and
    # the (m, 1/l) store
    wgfwd = " ".join(WGFWD.split())
    for line in ("w[e] = pack_bf16(f.x * q_scale, f.y * q_scale);",
                 "ml[r] = mx * kLog2e;",
                 "corr[r] = ex2_approx(fmaf(m[r], kLog2e, -ml[r]));",
                 "l[r] *= corr[r];",
                 "const float p = ex2_approx(fmaf(s[4 * n + e], kLog2e, "
                 "-ml[e >> 1]));",
                 "l[e >> 1] += p;",
                 "s[4 * n + e] = !DROPOUT ? p : bits[e] >= threshold ? p * "
                 "keep_scale : 0.f;",
                 "asm(\"ex2.approx.ftz.f32 %0, %1;\" : \"=f\"(y) : \"f\"(x));",
                 "constexpr float kLog2e = 1.4426950408889634f;",
                 "acc[x][i] = fmaf(acc[x][i], (i >> 1) & 1 ? c1 : c0, "
                 "pv[x][i]);",
                 "acc[x][i] *= (i >> 1) & 1 ? c1 : c0;",
                 "static constexpr bool kPvFromZero = kWidth == 32;",
                 "const float inv_l = 1.f / lt;",
                 "pack_bf16(a[4 * jj + 2 * r] * inv_l, a[4 * jj + 2 * r + 1] "
                 "* inv_l);",
                 "stats + ((static_cast<size_t>(b) * lay.heads + h) * "
                 "seq_len + i) * 2) = make_float2(m[r], inv_l);"):
        assert line in wgfwd, line
    # the unaligned route's 32-deep chunks summed apart; the wgmma kernel's
    # splits added in order within a cluster, then rounded once
    for line in ("for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];",
                 "for (int z = 1; z < CS; ++z) {",
                 "*reinterpret_cast<uint32_t*>(half + off) = gpnf::pack_bf16("
                 "x, y);"):
        assert line in GEMM, line


def frag_a_trans(base, ld, k0, m0):
    """Of `frag_a_bf16_trans<LD>`."""
    return [base + 2 * ((k0 + (lane & 7) + ((lane >> 4) << 3)) * ld + m0 +
                        (((lane >> 3) & 1) << 3)) for lane in range(32)]


def gemm_loads(layout, tile):
    """Every fragment load of gemm_bf16_kernel at one layout and tile: each
    warp's A and B fragments at k steps 0 and 16 of a chunk, in every
    stage of the ring."""
    trans_a, trans_b = LAYOUTS[layout]
    bm, bn, wm_, wn_, stages = GEMM_TILES[tile]
    lda = bm + PAD if trans_a else GEMM_KC + PAD
    ldb = GEMM_KC + PAD if trans_b else bn + PAD
    size_a = GEMM_KC * lda if trans_a else bm * lda
    size_b = bn * ldb if trans_b else GEMM_KC * ldb
    loads = []
    for stage in range(stages):
        a_base = 2 * stage * (size_a + size_b)
        b_base = a_base + 2 * size_a
        for warp in range((bm // wm_) * (bn // wn_)):
            wm, wn = (warp // (bn // wn_)) * wm_, (warp % (bn // wn_)) * wn_
            for kk in range(0, GEMM_KC, 16):
                for i in range(wm_ // 16):
                    loads.append(frag_a_trans(a_base, lda, kk, wm + 16 * i)
                                 if trans_a else
                                 frag_a(a_base, lda, wm + 16 * i, kk))
                for jp in range(wn_ // 16):
                    loads.append(frag_b_pair(b_base, ldb, wn + 16 * jp, kk)
                                 if trans_b else
                                 frag_b_trans_pair(b_base, ldb, kk,
                                                   wn + 16 * jp))
    return loads


def dq_loads(dh):
    """Of attention_bf16_dq_kernel: each warp's q and g fragments (once, at
    W 32, or at every key tile), K's and V's pairs of key tiles, and K's
    transposed pairs for dq += dS K, in both stages."""
    w = fwd_width(dh)
    ld = w + PAD
    rows, keys = FWD_ROWS, dq_keys(dh)
    loads = [frag_a(base, ld, r0, 16 * ks)
             for base in (0, 2 * rows * ld) for r0 in range(0, rows, 16)
             for ks in range(w // 16)]
    for stage in range(2):
        k_base = 2 * (2 * rows + 2 * stage * keys) * ld
        v_base = k_base + 2 * keys * ld
        for base in (k_base, v_base):
            loads += [frag_b_pair(base, ld, 16 * np_, 16 * ks)
                      for ks in range(w // 16) for np_ in range(keys // 16)]
        loads += [frag_b_trans_pair(k_base, ld, 16 * kp, 16 * dp)
                  for kp in range(keys // 16) for dp in range(w // 16)]
    return loads


def dkv_loads(dh):
    """Of attention_bf16_dkv_kernel: each warp's K and V fragments (its 16
    keys), the query tiles' q and g pairs (S^T, dPd^T) and transposed pairs
    (dV, dK; each warp of a key's two at W 256 its half of the columns), in
    every stage of the ring."""
    w = fwd_width(dh)
    ld = w + PAD
    keys = tile_const("MmaDkvBf16", "kKeys", w)
    queries = dkv_queries(dh)
    loads = [frag_a(base, ld, k0, 16 * ks)
             for base in (0, 2 * keys * ld) for k0 in range(0, keys, 16)
             for ks in range(w // 16)]
    for stage in range(DKV_STAGES):
        q_base = 2 * (2 * keys + 2 * stage * queries) * ld
        for base in (q_base, q_base + 2 * queries * ld):
            loads += [frag_b_pair(base, ld, 16 * np_, 16 * ks)
                      for ks in range(w // 16)
                      for np_ in range(queries // 16)]
            loads += [frag_b_trans_pair(base, ld, 16 * kk, 16 * dp)
                      for kk in range(queries // 16)
                      for dp in range(w // 16)]
    return loads


@pytest.mark.parametrize("kernel", [
    "gemm", "dq_24", "dq_128", "dq_256", "dkv_24", "dkv_128", "dkv_256"])
def test_fragment_loads_are_conflict_free(kernel):
    """Every ldmatrix of every kernel: the GEMM at each layout and tile,
    the backward's attention kernels at each width built in bf16 (the
    forward reads its tiles by wgmma descriptors: tests/test_torch_wgmma.py
    models them)."""
    if kernel == "gemm":
        loads = [x for layout in LAYOUTS for tile in GEMM_TILES
                 for x in gemm_loads(layout, tile)]
    else:
        name, dh = kernel.split("_")
        loads = {"dq": dq_loads, "dkv": dkv_loads}[name](int(dh))
    assert loads and all(ldmatrix_conflicts(a) == 0 for a in loads)


@pytest.mark.parametrize("pad", [0, 16])
def test_other_pads_would_conflict(pad):
    """The bank count is not vacuous: rows of 32 values with no pad (64
    bytes, 4 groups of 16) or 16 more (96 bytes, 6) put two of a phase's
    rows on the same banks."""
    ld = 32 + pad
    assert ldmatrix_conflicts(frag_a(0, ld, 0, 0)) > 0


# -- arithmetic ------------------------------------------------------------------
def emulated_gemm_bf16(a, b, splits=1, out_dtype=BF16):
    """c = a b (a (m, k), b (k, n), bf16) as the bf16 GEMM on the paths
    (gemm_wgmma_bf16_kernel) sums it: each split's range of `wgmma_per`
    k-blocks one float32 sum (kept in the tensor core), the splits of each
    cluster (`wgmma_cluster`) added in split order and the clusters' sums in
    cluster order, then one rounding to bf16 (or none, out_dtype float32:
    dW)."""
    a, b = a.float(), b.float()
    chunk = fa.wgmma_per(a.shape[1], splits) * fa.WGMMA_BK
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
                            * scale).to(BF16)


@pytest.mark.parametrize("m,n,k", [(1024, 288, 96), (256, 1536, 512),
                                   (37, 30, 40)])
def test_gemm_emulation_is_within_an_ulp(m, n, k):
    """qkv = seq w^T (never split), within one bf16 ulp plus the float32
    sums' spread of the plain version and of the JAX `_proj`."""
    r = rng(1)
    a = _bf16_normal(r, (m, k), 0.5)
    b = _bf16_normal(r, (n, k), 0.1)
    got = emulated_gemm_bf16(a, b.t())
    assert fa.bf16_product_close(got, fa.bf16_matmul(a, b.t()), a, b)
    want = jfa._proj(jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)[None],
                     jnp.asarray(b.float().numpy()))[0]
    want = torch.from_numpy(np.array(want.astype(jnp.float32))).to(BF16)
    assert fa.bf16_product_close(got, want, a, b)


@pytest.mark.parametrize("b,s,c", [(16, 64, 96), (4, 256, 96), (2, 16, 512),
                                   (3, 37, 20)])
def test_gemm_backward_products_emulated(b, s, c):
    """dseq = dqkv w (bf16, rounded once) and dW = dqkv^T seq (float32),
    K split as `wgmma_splits` splits each shape (dW's K = B S), against the
    plain versions (`attention_dseq_gemm`, `attention_dw_gemm` on the CPU)
    and `_bwd_kernel_proj`'s formulas in jnp: dseq within one bf16 ulp plus
    the sums' spread, dW within 2^-22 of the sum of |products| (two
    float32 sums of B S products in different orders)."""
    r = rng(b * s + c)
    seq = _bf16_normal(r, (b, s, c), 0.5)
    w = _bf16_normal(r, (3 * c, c), 0.1)
    dqkv = _bf16_normal(r, (b, s, 3 * c), 0.1)
    d2, s2 = dqkv.reshape(-1, 3 * c), seq.reshape(-1, c)
    dseq = emulated_gemm_bf16(d2, w, fa.wgmma_splits(b * s, c, 3 * c))
    want = kernels.attention_dseq_gemm(dqkv, w).reshape(-1, c)
    assert fa.bf16_product_close(dseq, want, d2, w.t())
    jd, jw, js = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
                  for x in (d2, w, s2))
    jdseq = jax.lax.dot_general(jd, jw, (((1,), (0,)), ((), ())),
                                preferred_element_type=jnp.float32)
    jdseq = torch.from_numpy(np.array(jdseq.astype(jnp.bfloat16)
                                      .astype(jnp.float32))).to(BF16)
    assert fa.bf16_product_close(dseq, jdseq, d2, w.t())
    splits = fa.wgmma_splits(3 * c, c, b * s)
    dw = emulated_gemm_bf16(d2.t(), s2, splits, torch.float32)
    spread = 2.0 ** -22 * (d2.float().abs().t() @ s2.float().abs())
    want = kernels.attention_dw_gemm(dqkv, seq)
    assert want.dtype == dw.dtype == torch.float32
    assert bool(((dw - want).abs() <= spread).all())
    jdw = jax.lax.dot_general(jd, js, (((0,), (0,)), ((), ())),
                              preferred_element_type=jnp.float32)
    assert bool(((dw - torch.from_numpy(np.array(jdw))).abs()
                 <= spread).all())


def _fma32(a, b, c):
    """fmaf on float32 tensors: the exact a b + c (float64 holds the
    product of two float32 values) rounded once to float32."""
    return (a.double() * b + c.double()).float()


def emulated_fwd_bf16(qkv, heads, rate=0.0, seed=None, with_stats=False):
    """attention_wgmma_fwd_kernel's rounding points on the CPU, in its key
    tiles (`fwd_keys` at the rate): q * bf16(Dh^-1/2) rounded to bf16; per
    tile the float32 scores, the running max m, ml = m log2e and corr =
    2^fma(m_old, log2e, -ml), p = 2^fma(s, log2e, -ml) added unrounded to
    the denominator, pd = keep p / (1 - rate) rounded to bf16, the tile's
    pd V summed in float32 and added as out corr + pd V; out / l rounded
    once. `with_stats`: also the (B, H, S, 2) (m, 1/l) the kernel stores
    for the backward, its last running max and 1 / l."""
    b, s, c3 = qkv.shape
    c = c3 // 3
    dh = c // heads
    keys = fwd_keys(dh, rate > 0.0)
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    k, v, q = fa._split_qkv(qkv, heads)  # q * scale rounded, as the kernel
    q, k, v = q.float(), k.float(), v.float()
    keep = (fa.dropout_keep_plain(seed, b, heads, s, rate) if rate > 0.0
            else None)
    m = torch.full((b, heads, s, 1), -torch.inf)
    l = torch.zeros((b, heads, s, 1))
    acc = torch.zeros((b, heads, s, dh))
    for j0 in range(0, s, keys):
        sc = q @ k[:, :, j0:j0 + keys].transpose(-1, -2)
        mx = torch.maximum(m, sc.amax(-1, keepdim=True))
        ml = mx * log2e
        corr = torch.exp2(_fma32(m, log2e, -ml))
        p = torch.exp2(_fma32(sc, log2e, -ml))
        l = l * corr + p.sum(-1, keepdim=True)
        if keep is not None:
            p = torch.where(keep[..., j0:j0 + keys], p / (1.0 - rate), 0.0)
        pv = p.to(BF16).float() @ v[:, :, j0:j0 + keys]
        acc = acc * corr + pv
        m = mx
    out = fa._merge_heads((acc * (1.0 / l)).to(BF16))
    if with_stats:
        return out, torch.cat([m, 1.0 / l], dim=-1)
    return out


def _qkv(b, s, c, seed=2):
    return torch.from_numpy(rng(seed).standard_normal((b, s, 3 * c))
                            .astype(np.float32)).to(BF16)


@pytest.mark.parametrize("dh,s,rate", [(24, 256, 0.0), (24, 100, 0.2),
                                       (24, 64, 0.0), (128, 96, 0.0),
                                       (128, 70, 0.2), (256, 40, 0.0),
                                       (256, 35, 0.2)])
def test_forward_emulation_is_within_the_kernels_bar(dh, s, rate):
    """Within 2^-7 max|v| of `attention_long_plain` (which rounds the
    normalised p, as the JAX package does), and of the JAX `_reference_qkv`
    at rate 0."""
    heads, b = 4, 2
    c = heads * dh
    qkv = _qkv(b, s, c)
    seed = torch.tensor([5], dtype=torch.int32)
    got = emulated_fwd_bf16(qkv, heads, rate, seed)
    bar = 2.0 ** -7 * float(qkv[..., c:2 * c].float().abs().max())
    want = fa.attention_long_plain(qkv, heads, rate, seed)
    assert float((got.float() - want.float()).abs().max()) <= bar
    if rate == 0.0:
        jq = jnp.asarray(qkv.float().numpy()).astype(jnp.bfloat16)
        ref = jfa._reference_qkv(jnp.zeros((1,), jnp.int32), jq, heads, 0.0,
                                 True)
        ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
        assert float((got.float() - ref).abs().max()) <= bar


def emulated_bwd_bf16(qkv, g, heads, rate=0.0, seed=None,
                      scale_dq_in_fp32=False, d_from_out=False):
    """dqkv as attention_bf16_dq_kernel and attention_bf16_dkv_kernel round
    it, in their tiles, from the forward's (m, 1/l) (`emulated_fwd_bf16`).
    dq: q * bf16(Dh^-1/2) rounded; pass A over the key tiles sums
    exp(s - m) dP in float32, D its sum times 1/l; pass B forms dS =
    exp(s - m) / l (dP - D) per key tile, rounds it to bf16 and adds dS K in
    float32; dq leaves by the recipe. dK/dV: per query tile P from the
    stats, Pd = keep P keep_scale and dS = P (dP - D) rounded to bf16,
    dV += Pd^T g and dK += dS^T q in float32; each output rounded once.
    `d_from_out`: D = rowsum(g * out) of the forward's bf16 out instead,
    FlashAttention's recipe, which the kernels do not take."""
    b, s, c3 = qkv.shape
    c = c3 // 3
    dh = c // heads
    true = dh ** -0.5
    out, stats = emulated_fwd_bf16(qkv, heads, rate, seed, with_stats=True)
    m, inv_l = stats[..., :1], stats[..., 1:]
    k, v, q = fa._split_qkv(qkv, heads)
    q, k, v = q.float(), k.float(), v.float()
    gh = g.reshape(b, s, heads, dh).transpose(1, 2).float()
    keep_scale = float(np.float32(1.0) / np.float32(1.0 - rate))
    keep = (fa.dropout_keep_plain(seed, b, heads, s, rate) if rate > 0.0
            else torch.ones((b, heads, s, s), dtype=torch.bool))

    def tile(i, j):
        """Scores and dP of query rows i and key columns j."""
        sc = q[:, :, i] @ k[:, :, j].transpose(-1, -2)
        dp = gh[:, :, i] @ v[:, :, j].transpose(-1, -2)
        kept = keep[:, :, i][..., j]
        return sc, torch.where(kept, dp * keep_scale, 0.0), kept

    rows = slice(0, s)
    keys = dq_keys(dh)
    dsum = torch.zeros((b, heads, s, 1))
    for j0 in range(0, s, keys):
        sc, dp, _ = tile(rows, slice(j0, j0 + keys))
        dsum = dsum + (torch.exp(sc - m) * dp).sum(-1, keepdim=True)
    big_d = dsum * inv_l
    if d_from_out:
        oh = out.reshape(b, s, heads, dh).transpose(1, 2).float()
        big_d = (gh * oh).sum(-1, keepdim=True)
    dq = torch.zeros((b, heads, s, dh))
    for j0 in range(0, s, keys):
        sc, dp, _ = tile(rows, slice(j0, j0 + keys))
        ds = (torch.exp(sc - m) * inv_l * (dp - big_d)).to(BF16).float()
        dq = dq + ds @ k[:, :, j0:j0 + keys]
    if scale_dq_in_fp32:
        dq = (dq * float(np.float32(true))).to(BF16)
    else:
        dq = (dq.to(BF16).float() * fa.bf16_scale(true)).to(BF16)
    queries = dkv_queries(dh)
    dk = torch.zeros((b, heads, s, dh))
    dv = torch.zeros((b, heads, s, dh))
    for i0 in range(0, s, queries):
        i = slice(i0, i0 + queries)
        sc, dp, kept = tile(i, rows)
        p = torch.exp(sc - m[:, :, i]) * inv_l[:, :, i]
        pd = torch.where(kept, p * keep_scale, 0.0).to(BF16).float()
        ds = (p * (dp - big_d[:, :, i])).to(BF16).float()
        dv = dv + pd.transpose(-1, -2) @ gh[:, :, i]
        dk = dk + ds.transpose(-1, -2) @ q[:, :, i]
    return torch.cat([fa._merge_heads(dk.to(BF16)),
                      fa._merge_heads(dv.to(BF16)), fa._merge_heads(dq)], -1)


def _thirds_over_bar(got, want, c):
    """max |got - want| of each third of dqkv (dK, dV, dq) over its bar,
    2^-7 of the third's largest |want|."""
    return [float((got[..., i * c:(i + 1) * c].float()
                   - want[..., i * c:(i + 1) * c].float()).abs().max())
            / (2.0 ** -7 * float(want[..., i * c:(i + 1) * c].float()
                                 .abs().max())) for i in range(3)]


@pytest.mark.parametrize("dh,s,rate,in_fp32", [
    (24, 100, 0.0, True), (24, 64, 0.2, False), (128, 70, 0.0, False),
    (128, 48, 0.2, True), (256, 40, 0.0, True), (256, 33, 0.2, False)])
def test_backward_emulation_is_within_the_kernels_bar(dh, s, rate, in_fp32):
    """dK, dV and dq each within 2^-7 of the largest |plain| of their third
    of `attention_long_plain_bwd` (the kernels round the same values, in
    their tiles' order), at both recipes of dq."""
    heads, b = 4, 2
    c = heads * dh
    qkv = _qkv(b, s, c, seed=dh + s)
    g = torch.from_numpy(rng(s).standard_normal((b, s, c))
                         .astype(np.float32) * 0.5).to(BF16)
    seed = torch.tensor([11], dtype=torch.int32)
    got = emulated_bwd_bf16(qkv, g, heads, rate, seed, in_fp32)
    want = fa.attention_long_plain_bwd(qkv, g, heads, rate, seed, None,
                                       in_fp32)
    assert got.dtype == want.dtype == BF16
    assert max(_thirds_over_bar(got, want, c)) <= 1.0


def test_d_from_the_bf16_output_would_miss_the_bar():
    """Why the dq kernel sums D = sum_j P dP over the keys and does not take
    FlashAttention's D = rowsum(g * out): out is rounded to bf16 (its P
    before P V too), so that D is off by ~2^-9 of |g| |out|, and at the
    flagship's level 0 width and the training rate the emulated kernels
    with it miss the 2^-7 bar; with sum_j P dP they hold it by a wide
    margin."""
    heads, b, dh, s, rate = 4, 2, 24, 256, 0.2
    c = heads * dh
    qkv = _qkv(b, s, c, seed=dh + s)
    g = torch.from_numpy(rng(s).standard_normal((b, s, c))
                         .astype(np.float32) * 0.5).to(BF16)
    seed = torch.tensor([11], dtype=torch.int32)
    want = fa.attention_long_plain_bwd(qkv, g, heads, rate, seed, None, True)
    shipped = _thirds_over_bar(emulated_bwd_bf16(
        qkv, g, heads, rate, seed, True), want, c)
    from_out = _thirds_over_bar(emulated_bwd_bf16(
        qkv, g, heads, rate, seed, True, d_from_out=True), want, c)
    assert max(shipped) <= 0.25
    assert max(from_out) > 1.0


@pytest.mark.parametrize("dh,s,rate", [(24, 100, 0.2), (128, 70, 0.0),
                                       (256, 35, 0.2)])
def test_forward_keeps_each_rows_statistics(dh, s, rate):
    """The (m, 1/l) the forward kernel stores, emulated in its key tiles
    (the running max after the last tile, 1 / the rescaled sum), are each
    row's softmax statistics: m the largest score, m + log l its
    logsumexp, whatever the dropout; `attention_stats_plain` (the CPU's
    residual) gives the same; out is the same with or without them."""
    heads, b = 4, 2
    c = heads * dh
    qkv = _qkv(b, s, c, seed=dh + 1)
    seed = torch.tensor([7], dtype=torch.int32)
    out, stats = emulated_fwd_bf16(qkv, heads, rate, seed, with_stats=True)
    assert torch.equal(out, emulated_fwd_bf16(qkv, heads, rate, seed))
    assert stats.shape == (b, heads, s, 2) and stats.dtype == torch.float32
    k, _, q = fa._split_qkv(qkv, heads)
    scores = (q.float() @ k.float().transpose(-1, -2)).double()
    lse = torch.logsumexp(scores, -1)
    m, inv_l = stats[..., 0].double(), stats[..., 1].double()
    assert torch.allclose(m, scores.amax(-1), rtol=0, atol=1e-6)
    assert torch.allclose(m - torch.log(inv_l), lse, rtol=0, atol=1e-5)
    plain = fa.attention_stats_plain(qkv, heads)
    assert torch.allclose(plain.double(), stats.double(), rtol=1e-5,
                          atol=1e-6)


def keep_group(bh, padded, i, j):
    """attention_tiled.cuh's `keep_group`: the first of the four words of
    rows i .. i + 15 and keys j .. j + 7 of head bh."""
    return ((bh * (padded // 16) + i // 16) * (padded // 8) + j // 8) * 4


@pytest.mark.parametrize("s", [100, 64, 16])
def test_keep_bit_buffer_holds_the_mask_bit_for_bit(s):
    """The keep bits the dq kernel draws once and both kernels read back:
    the buffer filled as the dq kernel fills it (each warp's m16n8 C
    fragments of rows i0 + r0 .., keys j0 + 8 n ..: word e the ballot of
    element e over the lanes 4 gr + tg, one Philox word a score, the
    words of `dropout_keep_plain`), then read as the dK/dV kernel reads
    it (a thread's keys k0 + gr and k0 + gr + 8, queries i0 + 8 n + 2 tg
    and + 1, from words 2 ((i >> 3) & 1) + (gr & 1) and 4 past it, bit
    4 (2 tg + c) + (gr >> 1)) and as the dq kernel's pass B reads it: the
    mask, bit for bit, at a ragged S."""
    b, heads, rate = 2, 3, 0.2
    seed = torch.tensor([13], dtype=torch.int32)
    keep = fa.dropout_keep_plain(seed, b, heads, s, rate)
    padded = -(-s // 64) * 64
    assert fa.keep_bits_scratch(b, heads, s, rate, "cpu").numel() == \
        b * heads * padded * padded // 32
    buf = np.zeros(b * heads * padded * padded // 32, dtype=np.uint64)
    kp = np.zeros((b * heads, padded, padded), dtype=bool)
    kp[:, :s, :s] = keep.reshape(b * heads, s, s).numpy()
    lane = np.arange(32)
    gr, tg = lane >> 2, lane & 3
    # the writer: dq kernel warps (rows of 16) and n8 key tiles
    for bh in range(b * heads):
        for i in range(0, padded, 16):
            for j in range(0, padded, 8):
                at = keep_group(bh, padded, i, j)
                for e in range(4):
                    bits = kp[bh, i + gr + 8 * (e >> 1), j + 2 * tg + (e & 1)]
                    buf[at + e] = int(np.sum(bits.astype(np.uint64)
                                             << lane.astype(np.uint64)))
    # the dK/dV kernel's reads: warps of 16 keys, query tiles in n8 groups
    got = np.zeros_like(kp)
    for bh in range(b * heads):
        for k0 in range(0, padded, 16):
            for i8 in range(0, padded, 8):
                at = (keep_group(bh, padded, i8, k0) + 2 * ((i8 >> 3) & 1)
                      + (gr & 1))
                for e in range(4):
                    c, d = e & 1, e >> 1
                    word = buf[at + 4 * d]
                    bit = (word >> (4 * (2 * tg + c) + (gr >> 1)).astype(
                        np.uint64)) & 1
                    got[bh, i8 + 2 * tg + c, k0 + gr + 8 * d] = bit.astype(
                        bool)
    assert np.array_equal(got[:, :s, :s], kp[:, :s, :s])
    # the dq kernel's pass B: the word of its own element e, its lane's bit
    for bh in range(b * heads):
        for i in range(0, s, 16):
            for j in range(0, s, 8):
                at = keep_group(bh, padded, i, j)
                for e in range(4):
                    bit = (buf[at + e] >> lane.astype(np.uint64)) & 1
                    want = kp[bh, i + gr + 8 * (e >> 1), j + 2 * tg + (e & 1)]
                    assert np.array_equal(bit.astype(bool), want)


@pytest.mark.parametrize("entry", ["proj", "long"])
def test_bf16_autograd_saves_the_forward_statistics(entry):
    """A bf16 forward with a backward to come saves the forward's (B, H, S,
    2) statistics beside (seq, w, seed) (`attention_stats_plain` on the
    CPU, the kernel's store on the card), float32 and calls with no
    gradient to come save (seq, w, seed) alone, the JAX package's
    residuals; the gradients are the plain backward's either way."""
    heads, b, s, c = 4, 2, 24, 96
    r = rng(5)
    seq = torch.from_numpy(r.standard_normal((b, s, c)).astype(np.float32)
                           * 0.5)
    w = torch.from_numpy(r.standard_normal((3 * c, c)).astype(np.float32)
                         * 0.1)
    g = torch.from_numpy(r.standard_normal((b, s, c)).astype(np.float32))
    seed = torch.tensor([2], dtype=torch.int32)
    fn = {"proj": kernels.fused_attention_proj,
          "long": kernels.fused_attention_long}[entry]
    for dtype in (BF16, torch.float32):
        x, wt = (seq.to(dtype, copy=True).requires_grad_(),
                 w.to(dtype, copy=True).requires_grad_())
        out = fn(x, wt, heads, 0.2, seed)
        saved = out.grad_fn.saved_tensors
        assert saved[0] is x or torch.equal(saved[0], x)
        if dtype == BF16:
            assert len(saved) == 4
            qkv = fa.qkv_plain(x.detach(), wt.detach())
            assert torch.equal(saved[3], fa.attention_stats_plain(
                qkv, heads))
        else:
            assert len(saved) == 3
        out.backward(g.to(dtype))
        # the entry's backward at its boundary, on the CPU its plain version
        plain = {"proj": kernels.fused_attention_proj_bwd,
                 "long": kernels.fused_attention_long_bwd}[entry](
            x.detach(), wt.detach(), g.to(dtype), heads, 0.2, seed)
        assert torch.equal(x.grad, plain[0])
        assert torch.equal(wt.grad, plain[1])
    # no gradient to come: no statistics
    for grad in (False, True):
        x = seq.to(BF16).requires_grad_(grad)
        with torch.set_grad_enabled(not grad):
            out = fn(x, w.to(BF16), heads, 0.2, seed)
        assert out.grad_fn is None or len(out.grad_fn.saved_tensors) == 3


@pytest.mark.parametrize("dh", [4, 8, 16, 32, 48, 64])
def test_padded_heads_compute_the_true_widths_function(dh):
    """Each head zero-padded to the next of BF16_HEAD_DIMS (24 or 128) with q
    scaled by the true Dh's bf16 constant: the forward and the backward at
    the padded width, sliced back, within the kernels' bar of the plain
    versions at the true width (the zeros add nothing; only the float32
    sums' blocking differs)."""
    heads, b, s = 4, 2, 40
    width = fa.padded_head_dim(dh, fa.BF16_HEAD_DIMS)
    assert width == (24 if dh <= 24 else 128)
    c = heads * dh
    qkv = _qkv(b, s, c, seed=dh)
    g = torch.from_numpy(rng(dh + 1).standard_normal((b, s, c))
                         .astype(np.float32)).to(BF16)
    seed = torch.tensor([3], dtype=torch.int32)
    pad = lambda t: fa._pad_heads(t, dh, width)
    out = fa._unpad_heads(fa.attention_long_plain(
        pad(qkv), heads, 0.2, seed, dh ** -0.5), dh, width)
    want = fa.attention_long_plain(qkv, heads, 0.2, seed)
    bar = 2.0 ** -7 * float(qkv[..., c:2 * c].float().abs().max())
    assert float((out.float() - want.float()).abs().max()) <= bar
    dqkv = fa._unpad_heads(fa.attention_long_plain_bwd(
        pad(qkv), pad(g), heads, 0.2, seed, dh ** -0.5), dh, width)
    want = fa.attention_long_plain_bwd(qkv, g, heads, 0.2, seed)
    for part in range(3):
        x = dqkv[..., part * c:(part + 1) * c].float()
        y = want[..., part * c:(part + 1) * c].float()
        assert float((x - y).abs().max()) <= 2.0 ** -7 * float(
            y.abs().max()), part


def test_bf16_kernel_width_covers_every_head_width():
    widths = [24, 24, 24, 24, 128, 128, 128, 128, 256]
    assert [fa.padded_head_dim(d, fa.BF16_HEAD_DIMS)
            for d in fa.HEAD_DIMS] == widths
    # the route reports the width the bf16 kernels run, on either entry
    routes = [fa.attention_route(s, 4 * d, 4, torch.bfloat16)
              for d in fa.HEAD_DIMS for s in (16, 1024)]
    assert [r.kernel_head_dim for r in routes] == [
        w for w in widths for _ in range(2)]
    assert {r.entry for r in routes} == {"proj", "wide"}
    with pytest.raises(ValueError, match="256"):
        fa.padded_head_dim(257, fa.BF16_HEAD_DIMS)


def test_scale_is_the_bf16_constant():
    """q is scaled by Dh^-1/2 rounded to bf16, the JAX package's weakly
    typed `q * dh ** -0.5` on a bf16 q: not a power of two at Dh 24 or
    128, so q * scale is itself rounded (at 256 it is 1/16, exact)."""
    for dh in fa.BF16_HEAD_DIMS:
        scale = fa.bf16_scale(dh ** -0.5)
        want = float(jnp.asarray(dh ** -0.5).astype(jnp.bfloat16))
        assert scale == want
        assert (scale != dh ** -0.5) == (dh != 256)
        q = jnp.asarray(rng(3).standard_normal(64).astype(np.float32)) \
            .astype(jnp.bfloat16)
        jax_q = np.array((q * dh ** -0.5).astype(jnp.float32))
        port_q = (torch.from_numpy(np.array(q.astype(jnp.float32))).to(BF16)
                  * scale).float().numpy()
        np.testing.assert_array_equal(port_q, jax_q)
