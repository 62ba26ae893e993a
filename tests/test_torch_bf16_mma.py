"""The layout and arithmetic of the bf16 kernels (the qkv GEMM of
gpnf_tpu_torch/csrc/attention_gemm.cu and the attention forward of
attention_tiled.cuh, on mma_bf16.cuh), checked on the CPU: the
shared-memory banks of every ldmatrix fragment load at the padded row
strides the kernels use, the constants against the sources, and the
kernels' rounding points emulated (q * scale rounded to bf16, the
unnormalised P rounded to bf16, each key tile's P V summed in fp32; the
GEMM's 32-deep chunks summed apart in fp32, one rounding) and held to the
plain versions and the JAX package within the kernels' bars. The kernels
themselves are held against the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py."""
import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpnf_tpu.ops.pallas import fused_attention as jfa
from torch_parity import rng

fa = importlib.import_module("gpnf_tpu_torch.ops.kernels.fused_attention")

CSRC = Path(fa.__file__).resolve().parents[2] / "csrc"
GEMM = (CSRC / "attention_gemm.cu").read_text()
TILED = (CSRC / "attention_tiled.cuh").read_text()
MMA = (CSRC / "mma_bf16.cuh").read_text()
BF16 = torch.bfloat16


def const(name, text):
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


PAD = const("kBf16Pad", MMA)
GEMM_TILE = const("kBf16Tile", GEMM)
GEMM_WARP = const("kBf16Warp", GEMM)
GEMM_KC = const("kBf16Kc", GEMM)
FWD_KEYS = const("kKeys", TILED[TILED.index("struct MmaFwdBf16"):])
FWD_WARPS = const("kWarps", TILED[TILED.index("struct MmaFwdBf16"):])


def fwd_width(dh):
    """MmaFwdBf16's kWidth: Dh rounded up to a whole k16 step."""
    return -(-dh // 16) * 16


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
    assert (GEMM_TILE, GEMM_WARP, GEMM_KC, FWD_KEYS, FWD_WARPS) == (
        64, 32, 32, 64, 4)
    long_cu = (CSRC / "fused_attention_long.cu").read_text()
    body = long_cu[long_cu.index("int gpnf_attention_long_fwd_bf16"):]
    body = body[:body.index("\n}\n")]
    cases = tuple(int(x) for x in re.findall(r"case (\d+):", body))
    assert cases == fa.BF16_HEAD_DIMS == (24, 128)
    assert "gpnf_attention_gemm_bf16" in GEMM
    assert "m16n8k16.row.col.f32.bf16.bf16.f32" in MMA


def gemm_loads():
    """Every fragment load of gemm_bf16_kernel: 4 warps of 32 x 32 in a
    64 x 64 tile, k steps 0 and 16 of a chunk, in each of the 3 stages."""
    ld = GEMM_KC + PAD
    tile = 2 * GEMM_TILE * ld
    loads = []
    for stage in range(3):
        a_base, b_base = 2 * stage * tile, (2 * stage + 1) * tile
        for warp in range(4):
            wm, wn = (warp >> 1) * GEMM_WARP, (warp & 1) * GEMM_WARP
            for kk in range(0, GEMM_KC, 16):
                loads += [frag_a(a_base, ld, wm + 16 * i, kk)
                          for i in range(GEMM_WARP // 16)]
                loads += [frag_b_pair(b_base, ld, wn + 16 * jp, kk)
                          for jp in range(GEMM_WARP // 16)]
    return loads


def fwd_loads(dh):
    """Every fragment load of attention_bf16_fwd_kernel at width dh:
    each warp's q fragments, K's pairs of key tiles and V's transposed
    pairs, in both stages of the K / V double buffer."""
    w = fwd_width(dh)
    ld = w + PAD
    rows = 16 * FWD_WARPS
    loads = [frag_a(0, ld, 16 * warp, 16 * ks)
             for warp in range(FWD_WARPS) for ks in range(w // 16)]
    for stage in range(2):
        k_base = 2 * (rows + 2 * stage * FWD_KEYS) * ld
        v_base = k_base + 2 * FWD_KEYS * ld
        loads += [frag_b_pair(k_base, ld, 16 * np_, 16 * ks)
                  for ks in range(w // 16) for np_ in range(FWD_KEYS // 16)]
        loads += [frag_b_trans_pair(v_base, ld, 16 * kp, 16 * dp)
                  for kp in range(FWD_KEYS // 16) for dp in range(w // 16)]
    return loads


@pytest.mark.parametrize("kernel", ["gemm", "fwd_24", "fwd_128"])
def test_fragment_loads_are_conflict_free(kernel):
    loads = gemm_loads() if kernel == "gemm" else fwd_loads(
        int(kernel.split("_")[1]))
    assert loads and all(ldmatrix_conflicts(a) == 0 for a in loads)


@pytest.mark.parametrize("pad", [0, 16])
def test_other_pads_would_conflict(pad):
    """The bank count is not vacuous: rows of 32 values with no pad (64
    bytes, 4 groups of 16) or 16 more (96 bytes, 6) put two of a phase's
    rows on the same banks."""
    ld = 32 + pad
    assert ldmatrix_conflicts(frag_a(0, ld, 0, 0)) > 0


# -- arithmetic ------------------------------------------------------------------
def emulated_gemm_bf16(a, b):
    """c = a b^T as gemm_bf16_kernel sums it: chunks of GEMM_KC summed
    apart in float32 and added in order, then one rounding to bf16."""
    acc = torch.zeros(a.shape[0], b.shape[0])
    for k0 in range(0, a.shape[1], GEMM_KC):
        acc = acc + a[:, k0:k0 + GEMM_KC].float() @ b[:, k0:k0 + GEMM_KC] \
            .float().t()
    return acc.to(BF16)


@pytest.mark.parametrize("m,n,k", [(1024, 288, 96), (256, 1536, 512),
                                   (37, 30, 40)])
def test_gemm_emulation_is_within_an_ulp(m, n, k):
    r = rng(1)
    a = torch.from_numpy(r.standard_normal((m, k)).astype(np.float32)
                         * 0.5).to(BF16)
    b = torch.from_numpy(r.standard_normal((n, k)).astype(np.float32)
                         * 0.1).to(BF16)
    got = emulated_gemm_bf16(a, b)
    assert fa.bf16_product_close(got, fa.bf16_matmul(a, b.t()), a, b)
    want = jfa._proj(jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)[None],
                     jnp.asarray(b.float().numpy()))[0]
    want = torch.from_numpy(np.array(want.astype(jnp.float32))).to(BF16)
    assert fa.bf16_product_close(got, want, a, b)


def emulated_fwd_bf16(qkv, heads, rate=0.0, seed=None, keys=FWD_KEYS):
    """attention_bf16_fwd_kernel's rounding points on the CPU: q *
    bf16(Dh^-1/2) rounded to bf16; per tile of `keys` keys the float32
    scores, the running max m and corr = exp(m_old - m), p = exp(s - m)
    added unrounded to the denominator, pd = keep p / (1 - rate) rounded to
    bf16, the tile's pd V summed in float32 and added as out corr + pd V;
    out / l rounded once."""
    b, s, c3 = qkv.shape
    c = c3 // 3
    dh = c // heads
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
        corr = torch.exp(m - mx)
        p = torch.exp(sc - mx)
        l = l * corr + p.sum(-1, keepdim=True)
        if keep is not None:
            p = torch.where(keep[..., j0:j0 + keys], p / (1.0 - rate), 0.0)
        pv = p.to(BF16).float() @ v[:, :, j0:j0 + keys]
        acc = acc * corr + pv
        m = mx
    return fa._merge_heads((acc / l).to(BF16))


@pytest.mark.parametrize("dh,s,rate", [(24, 256, 0.0), (24, 100, 0.2),
                                       (24, 64, 0.0), (128, 96, 0.0),
                                       (128, 70, 0.2)])
def test_forward_emulation_is_within_the_kernels_bar(dh, s, rate):
    """Within 2^-7 max|v| of `attention_long_plain` (which rounds the
    normalised p, as the JAX package does), and of the JAX `_reference_qkv`
    at rate 0."""
    heads, b = 4, 2
    c = heads * dh
    qkv = torch.from_numpy(rng(2).standard_normal((b, s, 3 * c))
                           .astype(np.float32)).to(BF16)
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


def test_scale_is_the_bf16_constant():
    """q is scaled by Dh^-1/2 rounded to bf16, the JAX package's weakly
    typed `q * dh ** -0.5` on a bf16 q: not a power of two at Dh 24 or
    128, so q * scale is itself rounded."""
    for dh in fa.BF16_HEAD_DIMS:
        scale = fa.bf16_scale(dh ** -0.5)
        want = float(jnp.asarray(dh ** -0.5).astype(jnp.bfloat16))
        assert scale == want != dh ** -0.5
        q = jnp.asarray(rng(3).standard_normal(64).astype(np.float32)) \
            .astype(jnp.bfloat16)
        jax_q = np.array((q * dh ** -0.5).astype(jnp.float32))
        port_q = (torch.from_numpy(np.array(q.astype(jnp.float32))).to(BF16)
                  * scale).float().numpy()
        np.testing.assert_array_equal(port_q, jax_q)
