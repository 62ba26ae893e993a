"""The arithmetic of the tensor-core attention kernels
(gpnf_tpu_torch/csrc/mma_tf32.cuh and attention_tiled.cuh: the forward and
the backward at every width), emulated on the CPU: the TF32 rounding of
`tf32_bits`, the hi / lo split, the 3xTF32 product, the forward in its
kernel's order (key tiles, the quad's online max and partial
denominators, P split as the A fragment of Pd V, the tiles of each width
as the source sets them) against the JAX package's forward and the port's
plain one, and the whole backward in the kernels' tile order (key tiles
of the dq kernel's two passes, query tiles of the dK/dV kernel, k steps of
8 with three products each) against the JAX package's gradients and the
port's plain backward; the tiles' shared-memory banks; and the proj
forward's two stages (the projection, then the forward at the backward's
q scale) against the plain and JAX proj forwards and the backward's mask.
The kernels themselves are held against the plain versions on the card by
tests/test_torch_cuda.py."""
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
from torch_parity import close, mm3, normal, rng, split, t, tf32_round

fa = importlib.import_module("gpnf_tpu_torch.ops.kernels.fused_attention")

HEADS = 4
CSRC = Path(fa.__file__).resolve().parents[2] / "csrc"
TILED = (CSRC / "attention_tiled.cuh").read_text()
# attention_tiled.cuh's tiles by Dh, which
# test_tile_constants_match_the_cuda_source holds to the source (the
# emulations read them from the source, `cuda_const`): the forward's tile
# width, key tile and accumulator sets of S = q K^T; the backward's tile
# width, dq kernel's key tile and dK/dV kernel's query tile
FWD_TILES = {4: (8, 64, 1), 8: (8, 64, 1), 16: (16, 64, 1), 24: (24, 64, 1),
             32: (32, 32, 1), 48: (48, 32, 1), 64: (64, 32, 4),
             128: (128, 16, 4), 256: (256, 16, 2)}
BWD_TILES = {4: (8, 64, 64), 8: (8, 64, 64), 16: (16, 64, 64),
             24: (24, 64, 64), 32: (32, 32, 32), 48: (48, 32, 32),
             64: (64, 32, 32), 128: (128, 16, 32), 256: (256, 16, 16)}


def cuda_const(struct, name, dh):
    """Constant `name` of attention_tiled.cuh's `struct` at Dh = dh: an
    integer, DH, or a chain of `DH <op> n ? a : b`."""
    body = re.search(rf"struct {struct} \{{(.*?)\n\}};", TILED,
                     re.S).group(1)
    expr = re.search(rf"constexpr int {name} = ([^;]*);", body).group(1)
    while True:
        ternary = re.fullmatch(r"DH (==|<=|<|>=|>) (\d+) \? (\w+) : (.+)",
                               expr.strip())
        if not ternary:
            break
        op, n, a, b = ternary.groups()
        holds = {"==": dh == int(n), "<=": dh <= int(n), "<": dh < int(n),
                 ">=": dh >= int(n), ">": dh > int(n)}[op]
        expr = a if holds else b
    return dh if expr.strip() == "DH" else int(expr)


def _keep(seed, b, num_heads, s, rate):
    return (fa.dropout_keep_plain(seed, b, num_heads, s, rate) if rate > 0
            else None)


def emulated_fwd(qkv, num_heads, rate=0.0, seed=None, q_scale=None):
    """out (B, S, C) of the packed attention as the forward kernel computes
    it, in the source's tiles for the width (`MmaFwd`): rows of kWidth
    floats (Dh 4: four zero pad columns); key tiles of kKeys keys (past S:
    zero rows, scores at -inf); S = q K^T in 3xTF32 on unscaled q, its k
    steps dealt round kSplits accumulator sets, scaled by q_scale (default
    `head_scale`) after; per tile the row max, then the partial
    denominators of the quad's 4 threads (thread tg holds columns 2 tg,
    2 tg + 1 of every 8) rescaled by corr = exp(m_old - m_new); P = exp(s -
    m) added to the thread's partial in column order; Pd = keep P / (1 -
    rate), split hi / lo as the A fragment of the tile's Pd V, summed from
    zero and added as fmaf(acc, corr, Pd V); at the end the quad's partials
    added as (l0 + l1) + (l2 + l3) and out = acc * (1 / l), pad columns
    dropped."""
    b, s, c3 = qkv.shape
    c = c3 // 3
    dh = c // num_heads
    if q_scale is None:
        q_scale = fa.head_scale(dh)
    width = cuda_const("MmaFwd", "kWidth", dh)
    kt_n = cuda_const("MmaFwd", "kKeys", dh)
    sets = cuda_const("MmaFwd", "kSplits", dh)
    padded = -(-s // kt_n) * kt_n
    heads = lambda x: torch.nn.functional.pad(
        x.reshape(b, s, num_heads, dh).transpose(1, 2), (0, width - dh))
    pad = lambda x: torch.nn.functional.pad(x, (0, 0, 0, padded - s))
    k, v, q = (heads(x) for x in qkv.split(c, dim=-1))
    k, v = pad(k), pad(v)
    live = torch.arange(padded) < s
    keep = _keep(seed, b, num_heads, s, rate)
    if keep is not None:
        keep = torch.nn.functional.pad(keep, (0, padded - s))
    scale = 1.0 / (1.0 - rate)
    m = torch.full((b, num_heads, s), -torch.inf)
    lpart = torch.zeros((b, num_heads, s, 4))
    acc = torch.zeros_like(q)
    for j0 in range(0, padded, kt_n):
        cols = slice(j0, j0 + kt_n)
        kt = k[:, :, cols].transpose(-1, -2)
        sc = mm3(q, kt, sets) * q_scale
        sc = torch.where(live[cols], sc, -torch.inf)
        mx = torch.maximum(m, sc.amax(-1))
        corr = torch.exp(m - mx)[..., None]
        lpart = lpart * corr
        p = torch.exp(sc - mx[..., None])
        by_thread = p.reshape(b, num_heads, s, kt_n // 8, 4, 2)
        for n in range(kt_n // 8):
            for e in range(2):
                lpart = lpart + by_thread[..., n, :, e]
        pd = p if keep is None else torch.where(keep[..., cols], p * scale,
                                                0.0)
        pv = mm3(pd, v[:, :, cols])  # fmaf: one rounding of acc corr + pv
        acc = (acc.double() * corr.double() + pv.double()).float()
        m = mx
    l = (lpart[..., 0] + lpart[..., 1]) + (lpart[..., 2] + lpart[..., 3])
    out = acc[..., :dh] * (1.0 / l)[..., None]
    return out.transpose(1, 2).reshape(b, s, c)


def emulated_bwd(qkv, g, num_heads, rate=0.0, seed=None):
    """dqkv (B, S, 3C) packed [dK | dV | dq * q_scale] of the packed
    attention, as the two kernels compute it: the dq kernel's pass A over
    key tiles (online m, l, D), its pass B (dS, dq += dS K), then the dK/dV
    kernel over query tiles (P from the stats, dV += Pd^T g, dK += dS^T q,
    the k steps of S^T and dPd^T alternating between two accumulator sets,
    an odd last step alone); each width's tiles read from the source; q
    unscaled in every product, scores scaled after, dq and dK before the
    store."""
    b, s, c3 = qkv.shape
    c = c3 // 3
    dh = c // num_heads
    q_scale = fa.head_scale(dh)
    key_tile = cuda_const("MmaDq", "kKeys", dh)
    query_tile = cuda_const("MmaDkv", "kQueries", dh)
    heads = lambda x: x.reshape(b, s, num_heads, dh).transpose(1, 2)
    k, v, q = (heads(x) for x in qkv.split(c, dim=-1))
    gh = heads(g)
    keep = _keep(seed, b, num_heads, s, rate)
    scale = 1.0 / (1.0 - rate)

    def scores_and_dp(j0):  # the dq kernel's two products of one key tile
        kt, vt = k[:, :, j0:j0 + key_tile], v[:, :, j0:j0 + key_tile]
        sc = mm3(q, kt.transpose(-1, -2)) * q_scale
        dp = mm3(gh, vt.transpose(-1, -2))
        if keep is not None:
            dp = torch.where(keep[..., j0:j0 + key_tile], dp * scale, 0.0)
        return sc, dp, kt

    m = torch.full((b, num_heads, s), -torch.inf)
    l = torch.zeros((b, num_heads, s))
    dsum = torch.zeros((b, num_heads, s))
    for j0 in range(0, s, key_tile):
        sc, dp, _ = scores_and_dp(j0)
        mx = torch.maximum(m, sc.amax(-1))
        corr = torch.exp(m - mx)
        ex = torch.exp(sc - mx[..., None])
        l = l * corr + ex.sum(-1)
        dsum = dsum * corr + (ex * dp).sum(-1)
        m = mx
    inv_l = 1.0 / l
    big_d = dsum * inv_l
    dq = torch.zeros_like(q)
    for j0 in range(0, s, key_tile):
        sc, dp, kt = scores_and_dp(j0)
        ds = (torch.exp(sc - m[..., None]) * inv_l[..., None]
              * (dp - big_d[..., None]))
        dq = dq + mm3(ds, kt)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for i0 in range(0, s, query_tile):
        rows = slice(i0, i0 + query_tile)
        qt, gt = q[:, :, rows], gh[:, :, rows]
        st = mm3(k, qt.transpose(-1, -2), sets=2) * q_scale
        dpt = mm3(v, gt.transpose(-1, -2), sets=2)
        p = (torch.exp(st - m[:, :, None, rows])
             * inv_l[:, :, None, rows])
        pd = p
        if keep is not None:
            kept = keep[:, :, rows].transpose(-1, -2)
            pd = torch.where(kept, p * scale, 0.0)
            dpt = torch.where(kept, dpt * scale, 0.0)
        ds = p * (dpt - big_d[:, :, None, rows])
        dv = dv + mm3(pd, gt)
        dk = dk + mm3(ds, qt)
    merge = lambda x: x.transpose(1, 2).reshape(b, s, c)
    return torch.cat([merge(dk * q_scale), merge(dv), merge(dq * q_scale)],
                     dim=-1)


# -- TF32 rounding and the split ---------------------------------------------------
TIE = 1 + 2.0 ** -11  # halfway between 1 and 1 + 2^-10, the TF32 step at 1
ROUNDING = [
    (1.0, 1.0),
    (TIE, 1 + 2.0 ** -10),  # a tie goes away from zero (to even: 1)
    (-TIE, -(1 + 2.0 ** -10)),
    (np.nextafter(np.float32(TIE), np.float32(0)), 1.0),  # just below
    (1 + 3 * 2.0 ** -11, 1 + 2.0 ** -9),  # a tie whose even side is up too
    (2 - 2.0 ** -23, 2.0),  # the carry reaches the exponent
    (2.0 ** -149, 0.0),  # the least subnormal, below half a TF32 step
    (2.0 ** -137, 2.0 ** -136),  # a subnormal tie: away from zero
    (-(2.0 ** -137), -(2.0 ** -136)),
    (float(np.finfo(np.float32).max), np.inf),  # past the largest TF32
    (np.inf, np.inf), (-np.inf, -np.inf)]


@pytest.mark.parametrize("x,want", ROUNDING)
def test_tf32_round_hand_checked(x, want):
    got = tf32_round(np.float32(x))[0]
    assert got == np.float32(want) and np.signbit(got) == np.signbit(want)
    assert got.view(np.uint32) & np.uint32(0x1FFF) == 0


def test_tf32_round_keeps_nan():
    assert np.isnan(tf32_round(np.float32(np.nan))[0])


def test_split_reconstructs_within_2_to_the_minus_21():
    """hi + lo is x within 2^-21 |x| (the split's own bound is 2^-22: lo
    rounds a remainder below 2^-11 |x| to 11 bits), over 60 binades and
    both signs; hi and lo are TF32 values."""
    r = rng(3)
    x = (r.standard_normal(20000) * 2.0 ** r.integers(-30, 30, 20000)
         ).astype(np.float32)
    hi, lo = split(torch.from_numpy(x))
    for part in (hi, lo):
        assert not (part.numpy().view(np.uint32) & np.uint32(0x1FFF)).any()
    err = np.abs(hi.double().numpy() + lo.double().numpy() - x)
    assert (err <= 2.0 ** -21 * np.abs(x)).all()
    assert np.abs(hi.double().numpy() - x).max() > 0  # hi alone is not x


@pytest.mark.parametrize("k", [128, 256])
def test_3xtf32_product_against_float64(k):
    """mm3 within (K + 16) 2^-24 (|A| |B|) of the float64 product, element
    by element: each term is within ~3 2^-22 |a||b| of exact (the split's
    2^-22 on each side and the dropped lo*lo), and a float32 sum of K terms
    adds at most ~K 2^-24 sum |a||b|. A single TF32 product (hi*hi), whose
    terms are off by ~2^-11, fails the same bar."""
    r = rng(k)
    a = torch.from_numpy(normal(r, (64, k)))
    b = torch.from_numpy(normal(r, (k, 32)))
    exact = a.double() @ b.double()
    bar = (k + 16) * 2.0 ** -24 * (a.double().abs() @ b.double().abs())
    assert ((mm3(a, b).double() - exact).abs() <= bar).all()
    ah, bh = split(a)[0], split(b)[0]
    assert ((ah @ bh).double() - exact).abs().gt(bar).any()


# -- the forward in its kernel's order -----------------------------------------------
def _inputs(s, batch=2, c=512, seed=0):
    r = rng(seed + s)
    return normal(r, (batch, s, 3 * c), 0.5), normal(r, (batch, s, c))


@pytest.mark.parametrize("s,c", [(16, 512), (17, 512), (64, 512), (17, 1024)])
def test_emulated_forward_matches_jax(s, c):
    """Dh 128 (C 512) and Dh 256 (C 1024), 4 heads, batch 2, rate 0: the
    emulated forward kernel against the JAX package's fused_attention_qkv
    on the CPU, at the bar of tests/test_torch_attention_widths.py."""
    qkv, _ = _inputs(s, c=c)
    want = jfa.fused_attention_qkv(jnp.zeros((1,), jnp.int32),
                                   jnp.asarray(qkv), HEADS, 0.0, False)
    close(emulated_fwd(t(qkv), HEADS), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("s,c", [(16, 512), (17, 512), (64, 512), (33, 1024)])
def test_emulated_forward_matches_the_plain_forward(s, c, rate):
    """The same against `attention_long_plain`, the plain version the card's
    kernel is held to, at rate 0 and 0.2 (the port's mask at one seed)."""
    qkv, _ = (t(x) for x in _inputs(s, c=c, seed=5))
    seed = torch.tensor([31 + s], dtype=torch.int32)
    want = kernels.attention_long_plain(qkv, HEADS, rate, seed)
    close(emulated_fwd(qkv, HEADS, rate, seed), want, rtol=1e-4, atol=1e-5)


# the narrow widths of the forward: Dh 4 (tile width 8), 8 (one k step), 24
# (the flagship's, three k steps: an odd last one) and 64 (the widest).
# Against the JAX package (~2 s a case) each width at S 100, which spans
# several key tiles; against the plain forward at S 17 and 100, and at Dh 16,
# 32 and 48 too
NARROW_FWD_JAX = [(4, 100), (8, 100), (24, 100), (64, 100)]
NARROW_FWD = [(dh, s) for dh in (4, 8, 16, 24, 32, 48, 64) for s in (17, 100)]


@pytest.mark.parametrize("dh,s", NARROW_FWD_JAX)
def test_emulated_narrow_forward_matches_jax(dh, s):
    """Dh 4, 8, 24 and 64 (4 heads), batch 2, rate 0: the emulated forward
    kernel, in each width's tiles, against the JAX package's
    fused_attention_qkv on the CPU, at the bar of
    tests/test_torch_attention_widths.py (rtol 1e-4, atol 1e-5)."""
    qkv, _ = _inputs(s, c=HEADS * dh, seed=dh)
    want = jfa.fused_attention_qkv(jnp.zeros((1,), jnp.int32),
                                   jnp.asarray(qkv), HEADS, 0.0, False)
    close(emulated_fwd(t(qkv), HEADS), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dh,s", NARROW_FWD)
def test_emulated_narrow_forward_matches_the_plain_forward(dh, s, rate):
    """The same at every narrow width against `attention_long_plain`, the
    plain version the card's kernel is held to, at rate 0 and 0.2 (the
    port's mask at one seed: a single differing keep bit would show far
    above the bar)."""
    qkv, _ = (t(x) for x in _inputs(s, c=HEADS * dh, seed=dh + 3))
    seed = torch.tensor([55 + s + dh], dtype=torch.int32)
    want = kernels.attention_long_plain(qkv, HEADS, rate, seed)
    close(emulated_fwd(qkv, HEADS, rate, seed), want, rtol=1e-4, atol=1e-5)


# -- the proj forward as two stages -----------------------------------------------
def _proj_inputs(s, seed):
    r = rng(seed + s)
    return (t(normal(r, (2, s, 96), 0.5)), t(normal(r, (288, 96), 0.1)),
            t(normal(r, (2, s, 96))))


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("s", [16, 64])
def test_proj_forward_stages_match_the_plain_and_jax_forward(s, rate):
    """C 96 (the flagship's), 4 heads, batch 2: the proj forward's stages on
    the CPU, attention_long_plain(seq w^T) at the kernels' q scale
    `head_scale` (1.f / sqrtf(24), one ulp from 24 ** -0.5), against
    `attention_proj_plain`; the kernels' order of the second stage
    (`emulated_fwd`) against both; and at rate 0 against the JAX
    package's fused_attention_proj (its masks come from the TPU's
    generator)."""
    seq, w, _ = _proj_inputs(s, 17)
    seed = torch.tensor([9 + s], dtype=torch.int32)
    qkv = torch.matmul(seq, w.t())
    stages = fa._proj_fwd_stages(seq, w, HEADS, rate, seed)
    close(stages, kernels.attention_long_plain(qkv, HEADS, rate, seed,
                                               fa.head_scale(24)), 0, 0)
    want = kernels.attention_proj_plain(seq, w, HEADS, rate, seed)
    close(stages, want, rtol=1e-6, atol=1e-7)
    close(emulated_fwd(qkv, HEADS, rate, seed), want, rtol=1e-4, atol=1e-5)
    if rate == 0.0:
        jax_out = jfa.fused_attention_proj(
            jnp.zeros((1,), jnp.int32), jnp.asarray(seq.numpy()),
            jnp.asarray(w.numpy()), HEADS, 0.0, False)
        close(stages, jax_out, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("s", [16, 64])
def test_proj_forward_mask_is_the_one_its_backward_regenerates(s):
    """Rate 0.2, one seed: the gradients of the forward's stages (autograd
    through the CPU composition, which draws its mask once, in the
    forward) equal `attention_proj_plain_bwd`, which regenerates the mask
    from the seed; a forward that dropped other scores would give other
    gradients. Another seed does not match."""
    seq, w, g = _proj_inputs(s, 23)
    seed = torch.tensor([41 + s], dtype=torch.int32)
    leaves = [x.clone().requires_grad_() for x in (seq, w)]
    fa._proj_fwd_stages(*leaves, HEADS, 0.2, seed).backward(g)
    want = kernels.attention_proj_plain_bwd(seq, w, g, HEADS, 0.2, seed)
    for leaf, x in zip(leaves, want):
        close(leaf.grad, x, rtol=1e-5, atol=1e-6)
    other = kernels.attention_proj_plain_bwd(seq, w, g, HEADS, 0.2, seed + 1)
    assert (leaves[0].grad - other[0]).abs().max() > 1e-3


# -- the whole backward in the kernels' tile order ----------------------------------


@pytest.mark.parametrize("s", [16, 17, 64])
def test_emulated_backward_matches_jax_grads(s):
    """Dh 128 (C 512, 4 heads), batch 2, rate 0: the emulated kernels'
    dqkv against jax.grad of the JAX package's fused_attention_qkv on the
    CPU, at the bar of tests/test_torch_attention_widths.py."""
    qkv, g = _inputs(s)
    seed = jnp.zeros((1,), jnp.int32)
    want = jax.grad(lambda x: jnp.sum(jfa.fused_attention_qkv(
        seed, x, HEADS, 0.0, False) * g))(jnp.asarray(qkv))
    close(emulated_bwd(t(qkv), t(g), HEADS), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("s", [16, 17, 64])
def test_emulated_backward_matches_the_plain_backward(s, rate):
    """The same against `attention_long_plain_bwd`, the plain version the
    card's kernels are held to, at rate 0 and 0.2 (the port's mask at one
    seed)."""
    qkv, g = (t(x) for x in _inputs(s, seed=7))
    seed = torch.tensor([99 + s], dtype=torch.int32)
    want = kernels.attention_long_plain_bwd(qkv, g, HEADS, rate, seed)
    close(emulated_bwd(qkv, g, HEADS, rate, seed), want, rtol=1e-4,
          atol=1e-5)


# the narrow widths: Dh 24 (the flagship's C = 96), 48 (C = 192) and 8 (C =
# 32; one k step, and 24 three: the dK/dV kernel's odd last step). Against
# the JAX package (~2 s a case, its compile) each width at the ragged S 17;
# against the plain backward (which tests/test_torch_attention_long.py
# holds to the JAX package) every case
NARROW = [(dh, s) for dh in (24, 48, 8) for s in (16, 17, 64)]
NARROW_JAX = [(24, 17), (48, 17), (8, 17)]


@pytest.mark.parametrize("dh,s", NARROW_JAX)
def test_emulated_narrow_backward_matches_jax_grads(dh, s):
    """Dh 24, 48 and 8 (4 heads), batch 2, rate 0: the emulated kernels'
    dqkv, in each width's tiles, against jax.grad of the JAX package's
    fused_attention_qkv on the CPU, at the bar of
    tests/test_torch_attention_widths.py."""
    qkv, g = _inputs(s, c=HEADS * dh, seed=dh)
    seed = jnp.zeros((1,), jnp.int32)
    want = jax.grad(lambda x: jnp.sum(jfa.fused_attention_qkv(
        seed, x, HEADS, 0.0, False) * g))(jnp.asarray(qkv))
    close(emulated_bwd(t(qkv), t(g), HEADS), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dh,s", NARROW)
def test_emulated_narrow_backward_matches_the_plain_backward(dh, s, rate):
    """The same against `attention_long_plain_bwd`, the plain version the
    card's kernels are held to, at rate 0 and 0.2."""
    qkv, g = (t(x) for x in _inputs(s, c=HEADS * dh, seed=dh + 7))
    seed = torch.tensor([77 + s + dh], dtype=torch.int32)
    want = kernels.attention_long_plain_bwd(qkv, g, HEADS, rate, seed)
    close(emulated_bwd(qkv, g, HEADS, rate, seed), want, rtol=1e-4,
          atol=1e-5)


def test_fragment_loads_hit_32_banks_at_every_width():
    """Each shared-memory load of `tile_frag_a`, `tile_frag_bt` and
    `tile_frag_b` (mma_tf32.cuh: lane = 4 gr + tg, the address `tile_at`'s
    r (W + kTilePad) + c) touches 32 distinct banks, at every built width's
    tile width W (one for the forward, the dq and the dK/dV kernels), for
    every row block and k step of the tile: no conflicts."""
    header = (CSRC / "mma_tf32.cuh").read_text()
    pad = int(re.search(r"constexpr int kTilePad = (\d+);", header).group(1))
    assert "return r * (W + kTilePad) + c;" in header
    lanes = [(lane >> 2, lane & 3) for lane in range(32)]
    for dh in fa.HEAD_DIMS:
        w = cuda_const("MmaDq", "kWidth", dh)
        assert w == cuda_const("MmaDkv", "kWidth", dh) and w % 8 == 0
        assert w == cuda_const("MmaFwd", "kWidth", dh)
        at = lambda r, c: r * (w + pad) + c
        for r0 in (0, 8, 16, 40):
            for c0 in range(0, w, 8):
                loads = [  # each (r, c) of a lane, one load instruction
                    lambda gr, tg: at(r0 + gr, c0 + tg),          # a0, b^T 0
                    lambda gr, tg: at(r0 + gr + 8, c0 + tg),      # a1
                    lambda gr, tg: at(r0 + gr, c0 + tg + 4),      # a2, b^T 1
                    lambda gr, tg: at(r0 + gr + 8, c0 + tg + 4),  # a3
                    lambda gr, tg: at(r0 + 2 * tg, c0 + gr),      # b 0
                    lambda gr, tg: at(r0 + 2 * tg + 1, c0 + gr)]  # b 1
                for load in loads:
                    banks = {load(gr, tg) % 32 for gr, tg in lanes}
                    assert len(banks) == 32, (dh, w, r0, c0)


def test_tile_constants_match_the_cuda_source():
    """FWD_TILES and BWD_TILES are attention_tiled.cuh's own, by width (the
    forward's tile width, key tile and sets of S's sums; the backward's
    tile width, dq's key tile, dK/dV's query tile), and the header's split
    is the rounding `tf32_round` emulates."""
    assert sorted(FWD_TILES) == sorted(fa.HEAD_DIMS)
    for dh, tiles in FWD_TILES.items():
        assert (cuda_const("MmaFwd", "kWidth", dh),
                cuda_const("MmaFwd", "kKeys", dh),
                cuda_const("MmaFwd", "kSplits", dh)) == tiles, dh
    assert sorted(BWD_TILES) == sorted(fa.HEAD_DIMS)
    for dh, tiles in BWD_TILES.items():
        assert (cuda_const("MmaDq", "kWidth", dh),
                cuda_const("MmaDq", "kKeys", dh),
                cuda_const("MmaDkv", "kQueries", dh)) == tiles, dh
    header = (CSRC / "mma_tf32.cuh").read_text()
    assert "return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;" in header
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in header
