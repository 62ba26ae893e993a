"""The core attention entries on bf16 operands, `fused_attention` (q, k, v
(B, H, S, Dh), q already scaled) and `fused_attention_qkv` (packed qkv
(B, S, 3C)), forward and backward, against the JAX package on the CPU; and
GatedAttn above S = 2048.

- The plain bf16 versions against the Pallas kernels in interpret mode on
  bf16 operands at rate 0 (`_fwd_kernel`, `_bwd_kernel`, `_fwd_kernel_qkv`,
  `_bwd_kernel_qkv`), compiled with XLA's `xla_allow_excess_precision` off
  (tests/test_torch_bf16_train.py says why): the forwards bit for bit; the
  split backward within one bf16 ulp of the largest |want| with at most 5%
  of the values differing (the port rounds at the kernels' points, and
  only the order of the float32 sums differs: ≤ 0.08% differ here), the
  packed one bit for bit (no sum's order moves a bit at these sizes).
- The two recipes the CPU wrappers once took wrongly: `fused_attention_bwd`
  rounded Pd and dS to bf16 before their products (`_bwd_kernel_bh`'s
  recipe, where `_bwd_kernel` widens every operand and rounds only dq, dk
  and dv), and `fused_attention_qkv_bwd` rounded dq and then scaled it in
  bf16 (where `_bwd_kernel_qkv` scales the float32 sum and rounds once).
- The CPU wrappers take the plain versions without counting a launch;
  operands of two dtypes raise on every device.
- GatedAttn at 48 x 48 (S 2304, above the 2048 the kernels once stopped
  at) against the JAX GatedAttn in float32 on the same weights.
- The split backward's kernels on bf16 operands (attention_tiled.cuh):
  a widened bf16 value splits with lo = 0, so the passes they drop add
  nothing; their bf16 tiles' fragment reads hit no bank twice.
The CUDA kernels are held against the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py's phase 17."""
import functools
import importlib
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpnf_tpu.ops import mixlogcdf as j_mix
from gpnf_tpu.ops.pallas import fused_attention as j_fa
from gpnf_tpu_torch import convert
from gpnf_tpu_torch.ops import kernels, mixlogcdf
from torch_parity import close, load, mm3, normal, rng, split, t

fa = importlib.import_module("gpnf_tpu_torch.ops.kernels.fused_attention")
BF16 = torch.bfloat16
SEED = jnp.zeros((1,), jnp.int32)
HEADS = 2
S = 40
# no float32 -> bf16 -> float32 round trip removed: the kernels' own rounding
EXACT = {"xla_allow_excess_precision": False}
MAX_DIFFERING = 0.05  # of the values


def _torch(a):
    """The bf16 value of a numpy array as a torch bf16 tensor."""
    return torch.from_numpy(np.array(
        jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))).to(BF16)


def _f32(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x).astype(jnp.float32))


def top_ulp(want):
    """One bf16 ulp at the largest |want|."""
    return 2.0 ** (math.floor(math.log2(float(np.abs(want).max()))) - 7)


def _held(got, want):
    """(largest difference, share of differing values), asserted within
    the module's bar."""
    got, want = _f32(got), _f32(want)
    diff = np.abs(got - want)
    share = float((diff > 0).mean())
    assert diff.max() <= top_ulp(want) and share <= MAX_DIFFERING, (
        float(diff.max()), top_ulp(want), share)
    return float(diff.max()), share


def _pallas(kernel, args, out_shapes):
    """`kernel` on a grid of batch rows (one a program) in interpret mode on
    the bf16 values of `args`, compiled with excess precision off; its
    outputs bf16 of `out_shapes`."""
    from jax.experimental import pallas as pl

    def block(shape):
        return pl.BlockSpec((1, *shape[1:]),
                            lambda i: (i,) + (0,) * (len(shape) - 1))

    def run(seed, *xs):
        return pl.pallas_call(
            kernel, grid=(xs[0].shape[0],),
            in_specs=[pl.BlockSpec(memory_space=None)]
            + [block(x.shape) for x in xs],
            out_specs=[block(o) for o in out_shapes],
            out_shape=[jax.ShapeDtypeStruct(o, jnp.bfloat16)
                       for o in out_shapes],
            interpret=True)(seed, *xs)

    xs = [jnp.asarray(a).astype(jnp.bfloat16) for a in args]
    return jax.jit(run).lower(SEED, *xs).compile(
        compiler_options=EXACT)(SEED, *xs)


def _split_inputs(dh, seed):
    """q (pre-scaled), k, v and a cotangent (B 2, H 2, S 40, Dh) as float32
    numpy arrays."""
    r = rng(seed)
    shape = (2, HEADS, S, dh)
    return (normal(r, shape, 0.4), normal(r, shape, 0.6), normal(r, shape),
            normal(r, shape, 0.5))


def _packed_inputs(dh, seed):
    """qkv (2, S, 3C) laid out [k | v | q] and its cotangent (2, S, C)."""
    r = rng(seed)
    c = HEADS * dh
    return normal(r, (2, S, 3 * c), 0.6), normal(r, (2, S, c), 0.5)


def _pallas_split_bwd(q, k, v, g):
    shape = q.shape
    return _pallas(functools.partial(j_fa._bwd_kernel, rate=0.0),
                   (q, k, v, g), [shape] * 3)


def _pallas_qkv_bwd(qkv, g):
    return _pallas(functools.partial(j_fa._bwd_kernel_qkv, rate=0.0,
                                     heads=HEADS), (qkv, g),
                   [qkv.shape])[0]


# -- the plain versions against the Pallas kernels ------------------------------
@pytest.mark.parametrize("dh", [8, 24])
def test_plain_forwards_match_the_pallas_kernels_bit_for_bit(dh):
    """`attention_plain` against `_fwd_kernel` and `attention_long_plain`
    against `_fwd_kernel_qkv` on bf16 operands: the same bits, and the CPU
    wrappers give them."""
    q, k, v, _ = _split_inputs(dh, seed=dh)
    want = _pallas(functools.partial(j_fa._fwd_kernel, rate=0.0), (q, k, v),
                   [q.shape])[0]
    got = kernels.attention_plain(_torch(q), _torch(k), _torch(v))
    assert got.dtype == BF16
    np.testing.assert_array_equal(_f32(got), _f32(want))
    assert torch.equal(kernels.fused_attention(_torch(q), _torch(k),
                                               _torch(v)), got)
    qkv, _ = _packed_inputs(dh, seed=dh + 1)
    c = HEADS * dh
    want = _pallas(functools.partial(j_fa._fwd_kernel_qkv, rate=0.0,
                                     heads=HEADS), (qkv,), [(2, S, c)])[0]
    got = kernels.attention_long_plain(_torch(qkv), HEADS)
    np.testing.assert_array_equal(_f32(got), _f32(want))
    assert torch.equal(kernels.fused_attention_qkv(_torch(qkv), HEADS), got)


@pytest.mark.parametrize("dh", [8, 24])
def test_plain_split_bwd_matches_the_pallas_bwd_kernel(dh):
    """`attention_plain_bwd` against `_bwd_kernel` on bf16 q, k, v, g: dq,
    dk and dv within the module's bar (each a float32 sum rounded once;
    only the sums' order differs)."""
    q, k, v, g = _split_inputs(dh, seed=10 + dh)
    want = _pallas_split_bwd(q, k, v, g)
    got = kernels.attention_plain_bwd(*map(_torch, (q, k, v, g)))
    for a, b in zip(got, want):
        assert a.dtype == BF16
        _held(a, b)


@pytest.mark.parametrize("dh", [8, 24])
def test_plain_packed_bwd_matches_the_pallas_bwd_kernel_qkv(dh):
    """`attention_long_plain_bwd` with the proj recipe's dq (scaled in
    float32, rounded once) against `_bwd_kernel_qkv` on bf16 qkv and g:
    dqkv bit for bit (the same rounding points and, at this size, no sum
    whose order moves a bit)."""
    qkv, g = _packed_inputs(dh, seed=20 + dh)
    want = _pallas_qkv_bwd(qkv, g)
    got = kernels.attention_long_plain_bwd(_torch(qkv), _torch(g), HEADS,
                                           scale_dq_in_fp32=True)
    np.testing.assert_array_equal(_f32(got), _f32(want))


# -- the wrappers' recipes: the faults repaired ---------------------------------
@pytest.mark.parametrize("dh", [8, 24])
def test_fused_attention_bwd_takes_the_bwd_kernel_recipe(dh):
    """`fused_attention_bwd` on bf16 CPU tensors, and the gradient through
    `fused_attention`'s autograd, hold `_bwd_kernel`'s bar. The recipe of
    `_bwd_kernel_bh` (Pd and dS rounded before their products), which the
    wrapper once took, puts 39-42% of dq, dk and dv off by up to an ulp
    of the largest."""
    q, k, v, g = _split_inputs(dh, seed=30 + dh)
    want = _pallas_split_bwd(q, k, v, g)
    got = kernels.fused_attention_bwd(*map(_torch, (q, k, v, g)))
    for a, b in zip(got, want):
        _held(a, b)
    leaves = [_torch(x).requires_grad_() for x in (q, k, v)]
    kernels.fused_attention(*leaves).backward(_torch(g))
    for leaf, a in zip(leaves, got):
        assert torch.equal(leaf.grad, a)
    old = fa._attention_plain_bwd_bf16(*map(_torch, (q, k, v, g)), 0.0, None,
                                       None)
    shares = [float((_f32(a) != _f32(b)).mean()) for a, b in zip(old, want)]
    assert min(shares) > MAX_DIFFERING, shares


@pytest.mark.parametrize("dh", [8, 24])
def test_fused_attention_qkv_bwd_scales_dq_in_float32(dh):
    """`fused_attention_qkv_bwd` on bf16 CPU tensors, and the gradient
    through `fused_attention_qkv`'s autograd, give `_bwd_kernel_qkv`'s
    bits. The long entry's dq (rounded, then scaled by the bf16 constant),
    which the wrapper once took, puts 26% of dq one ulp off, dK and dV
    the same bits."""
    qkv, g = _packed_inputs(dh, seed=40 + dh)
    want = _pallas_qkv_bwd(qkv, g)
    got = kernels.fused_attention_qkv_bwd(_torch(qkv), _torch(g), HEADS)
    c = HEADS * dh
    np.testing.assert_array_equal(_f32(got), _f32(want))
    leaf = _torch(qkv).requires_grad_()
    kernels.fused_attention_qkv(leaf, HEADS).backward(_torch(g))
    assert torch.equal(leaf.grad, got)
    old = kernels.attention_long_plain_bwd(_torch(qkv), _torch(g), HEADS)
    dq_share = float((_f32(old)[..., 2 * c:] != _f32(want)[..., 2 * c:])
                     .mean())
    assert dq_share > MAX_DIFFERING, dq_share


def test_autograd_keeps_the_forward_statistics_for_bf16_qkv():
    """A bf16 `fused_attention_qkv` with a backward to come saves the
    forward's (m, 1/l) beside (qkv, seed), as the proj and long entries do;
    float32, and bf16 without grad, save none."""
    qkv, _ = _packed_inputs(24, seed=50)
    for dtype, grad, saved in ((BF16, True, 3), (BF16, False, 0),
                               (torch.float32, True, 2)):
        x = _torch(qkv).to(dtype).requires_grad_(grad)
        out = kernels.fused_attention_qkv(x, HEADS)
        if not grad:
            assert out.grad_fn is None
            continue
        tensors = out.grad_fn.saved_tensors
        assert len(tensors) == saved
        if saved == 3:
            assert torch.equal(tensors[2],
                               fa.attention_stats_plain(x.detach(), HEADS))


def test_wrappers_take_plain_versions_on_cpu_without_counting():
    q, k, v, g = map(_torch, _split_inputs(24, seed=60))
    qkv, g3 = map(_torch, _packed_inputs(24, seed=61))
    seed = torch.tensor([3], dtype=torch.int32)
    kernels.reset_launch_counts()
    assert torch.equal(kernels.fused_attention(q, k, v, 0.2, seed),
                       kernels.attention_plain(q, k, v, 0.2, seed))
    for a, b in zip(kernels.fused_attention_bwd(q, k, v, g, 0.2, seed),
                    kernels.attention_plain_bwd(q, k, v, g, 0.2, seed)):
        assert torch.equal(a, b)
    assert torch.equal(kernels.fused_attention_qkv(qkv, HEADS, 0.2, seed),
                       kernels.attention_long_plain(qkv, HEADS, 0.2, seed))
    assert torch.equal(
        kernels.fused_attention_qkv_bwd(qkv, g3, HEADS, 0.2, seed),
        kernels.attention_long_plain_bwd(qkv, g3, HEADS, 0.2, seed,
                                         scale_dq_in_fp32=True))
    counts = kernels.launch_counts()
    assert counts == dict.fromkeys(counts, 0)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_mixed_dtypes_raise(device):
    """bf16 beside float32 raises on the CPU and before any launch (a meta
    tensor takes the kernels' path), for every core entry."""
    q = torch.zeros((1, HEADS, 16, 24), dtype=BF16, device=device)
    f = q.float()
    qkv = torch.zeros((1, 16, 3 * HEADS * 24), dtype=BF16, device=device)
    g3 = torch.zeros((1, 16, HEADS * 24), device=device)
    for call in (lambda: kernels.fused_attention(q, f, q),
                 lambda: kernels.fused_attention_bwd(q, q, q, f),
                 lambda: kernels.fused_attention_bwd(f, q, q, q),
                 lambda: kernels.fused_attention_qkv_bwd(qkv, g3, HEADS)):
        with pytest.raises(TypeError, match="dtype"):
            call()


def test_bf16_core_limits_are_the_float32_ones():
    """On bf16 the core entries take the float32 entries' widths and S,
    the long entry's: S above MAX_S_LONG and a width above 256 raise
    before the device, and so do float16 operands."""
    for s, dh, dtype, error, match in (
            (fa.MAX_S_LONG + 1, 24, BF16, ValueError, str(fa.MAX_S_LONG)),
            (64, 260, BF16, ValueError, "head width"),
            (64, 24, torch.float16, TypeError, "bfloat16")):
        q = torch.zeros((1, HEADS, s, dh), dtype=dtype, device="meta")
        qkv = torch.zeros((1, s, 3 * HEADS * dh), dtype=dtype, device="meta")
        g3 = torch.zeros((1, s, HEADS * dh), dtype=dtype, device="meta")
        for call in (lambda: kernels.fused_attention(q, q, q),
                     lambda: kernels.fused_attention_bwd(q, q, q, q),
                     lambda: kernels.fused_attention_qkv(qkv, HEADS),
                     lambda: kernels.fused_attention_qkv_bwd(qkv, g3, HEADS)):
            with pytest.raises(error, match=match):
                call()


# -- GatedAttn above S = 2048 -----------------------------------------------------
def test_route_takes_s_above_2048():
    """S 2304 (a 48 x 48 level) and S 4096 take the wide route at every
    width; only S above MAX_S_LONG, the kernels' own limit, raises."""
    for c in (8, 96, 512):
        for s in (2304, 4096):
            assert kernels.attention_route(s, c, 4).entry == "wide"
    with pytest.raises(ValueError, match=str(fa.MAX_S_LONG)):
        kernels.attention_route(fa.MAX_S_LONG + 1, 96, 4)


def test_gated_attn_at_48px_matches_jax():
    """C 8 (4 heads of Dh 2, padded to 4) at 48 x 48, batch 1, float32:
    the output and the gradients of x and of every weight against the JAX
    GatedAttn (its `_reference_qkv` above 2048) on the same weights."""
    c, side = 8, 48
    r = rng(70)
    x, g = normal(r, (1, side, side, c)), normal(r, (1, side, side, c), 0.5)
    j = j_mix.GatedAttn(c)
    params = j.init(jax.random.PRNGKey(0))
    out, vjp = jax.vjp(lambda p, a: j.apply(p, a), params, jnp.asarray(x))
    want_dparams, want_dx = vjp(jnp.asarray(g))
    attn = load(mixlogcdf.GatedAttn(c), params)
    assert attn.route(side * side) == ("wide", 2, 4)
    x_t = t(x).requires_grad_()
    got = attn(x_t)
    close(got, out, 1e-4, 1e-5)
    got.backward(t(g))
    close(x_t.grad, want_dx, 1e-4, 1e-5)
    want = convert.jax_to_state_dict(jax.device_get(want_dparams))
    grads = {k: p.grad for k, p in attn.named_parameters()}
    assert set(grads) == set(want)
    for name, grad in grads.items():
        close(grad, want[name], 1e-4, 1e-5)


# -- the split backward's kernels on widened bf16 ----------------------------------
def test_widened_bf16_splits_with_lo_zero_and_drops_only_zero_passes():
    """A bf16 value widened to float32 is exact in TF32: its split is (x,
    0). So 3xTF32 of a float32 intermediate by a widened operand (dS K) is
    its two passes lo hi + hi hi bit for bit, and of two widened operands
    (q K^T) its one pass hi hi: the kernels drop only products of zeros."""
    r = rng(80)
    a = torch.from_numpy(normal(r, (16, 64)))  # a float32 intermediate
    b = _torch(normal(r, (64, 8)) * 3.0).float()  # widened bf16
    c = _torch(normal(r, (16, 64))).float()
    hi, lo = split(b)
    assert torch.equal(hi, b) and not lo.any()
    ah, al = split(a)
    two = torch.zeros(16, 8)
    one = torch.zeros(16, 8)
    for k0 in range(0, 64, 8):
        two = two + al[:, k0:k0 + 8] @ b[k0:k0 + 8]
        two = two + ah[:, k0:k0 + 8] @ b[k0:k0 + 8]
        one = one + c[:, k0:k0 + 8] @ b[k0:k0 + 8]
    assert torch.equal(mm3(a, b), two)
    assert torch.equal(mm3(c, b), one)


TILED = (Path(fa.__file__).resolve().parents[2] / "csrc" /
         "attention_tiled.cuh").read_text()


@pytest.mark.parametrize("dh", [d for d in fa.HEAD_DIMS if d % 8 == 0])
def test_bf16_tile_reads_hit_no_bank_twice(dh):
    """The split backward's bf16 tiles (`tile_ld`: W rounded down to 16 plus
    8 values a row, W = Dh): rows start on 16 bytes (cp.async), and each
    widened fragment read (A or B^T: rows r0 + gr (+ 8), columns c0 + tg
    (+ 4); B: rows r0 + 2 tg (+ 1), column c0 + gr) touches no bank at two
    32-bit words, at every row block and k step."""
    assert re.search(r"return std::is_same<In, bf16>::value \? W / 16 \* 16 "
                     r"\+ 8 : W \+ kTilePad;", TILED)
    ld = dh // 16 * 16 + 8
    assert ld >= dh and (2 * ld) % 16 == 0
    lanes = [(lane >> 2, lane & 3) for lane in range(32)]
    at = lambda row, col: row * ld + col  # in bf16 values
    for r0 in (0, 8, 16, 40):
        for c0 in range(0, dh, 8):
            loads = [lambda gr, tg: at(r0 + gr, c0 + tg),
                     lambda gr, tg: at(r0 + gr + 8, c0 + tg),
                     lambda gr, tg: at(r0 + gr, c0 + tg + 4),
                     lambda gr, tg: at(r0 + gr + 8, c0 + tg + 4),
                     lambda gr, tg: at(r0 + 2 * tg, c0 + gr),
                     lambda gr, tg: at(r0 + 2 * tg + 1, c0 + gr)]
            for load_ in loads:
                words = {load_(gr, tg) // 2 for gr, tg in lanes}
                banks = {}
                for w in words:
                    banks.setdefault(w % 32, set()).add(w)
                assert all(len(v) == 1 for v in banks.values()), (dh, r0, c0)
