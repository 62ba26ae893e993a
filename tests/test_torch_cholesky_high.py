"""The port's Cholesky with trailing_precision="high" against the JAX
package (CPU), and the core attention entries at the shapes the card now
takes (S above 512, head widths padded to a built one).

"high" is `pallas_cholesky_hbm`'s mode of that name: its trailing GEMM as
`_dot_bf16x3`, three bf16 products summed in float32. The port's plain
version (`cholesky_plain(a, "high", P)`) forms the same products at the
same P: its hi and lo splits are JAX's bit for bit, `bf16x3_plain` is
`_dot_bf16x3` to its float32 sums, and the factor is JAX's interpret-mode
"high" to rtol = atol = 1e-5 and to well inside JAX's own high-vs-highest
gap, which shows the mode is engaged. The CUDA kernel is held against the
plain version on the card by tests/test_torch_cuda.py (-k cholesky_high).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpnf_tpu.ops.pallas import cholesky as j_chol
from gpnf_tpu.ops.pallas import fused_attention as j_fa
from gpnf_tpu_torch.ops import kernels
from torch_parity import close, normal, rng, t

ch = importlib.import_module("gpnf_tpu_torch.ops.kernels.cholesky")
SEED = jnp.zeros((1,), jnp.int32)


def _spd(n, seed=0, dtype=np.float32):
    """X X^T / n + I (eigenvalues in [1, 5])."""
    x = rng(seed).standard_normal((n, n))
    return (x @ x.T / n + np.eye(n)).astype(dtype)


@pytest.fixture
def x64():
    """JAX in float64 for one test."""
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _bits(x):
    """bf16 values (torch or JAX) as their uint16 bit patterns."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _split_values(dtype):
    """Random values over six decades, both signs, and the rounding's edge
    cases: ties to even (1 + 2^-8 -> 1, 1 + 3 2^-8 -> 1 + 2^-6), a value
    one float32 ulp past a tie, and in float64 1 + 2^-8 + 2^-30, which
    goes to 1 through float32 (directly it would be 1 + 2^-7)."""
    r = rng(11)
    x = r.standard_normal(4096) * 10.0 ** r.uniform(-3, 3, 4096)
    edges = [1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 0.0, 1.0,
             float(np.nextafter(np.float32(1 + 2 ** -8), np.float32(2)))]
    if dtype == np.float64:
        edges.append(1 + 2 ** -8 + 2 ** -30)
    return np.concatenate([x, edges]).astype(dtype)


# -- the splits and the product -----------------------------------------------------
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bf16_split_matches_jax_casts(dtype, x64):
    """hi and lo of `bf16_split` against the casts of `_dot_bf16x3` (its
    first two lines, in float64 under x64), bit for bit."""
    x = _split_values(dtype)
    xj = jnp.asarray(x)
    assert xj.dtype == dtype
    want_hi = xj.astype(jnp.bfloat16)
    want_lo = (xj - want_hi.astype(jnp.float32)).astype(jnp.bfloat16)
    hi, lo = ch.bf16_split(torch.from_numpy(x))
    np.testing.assert_array_equal(_bits(hi), _bits(want_hi))
    np.testing.assert_array_equal(_bits(lo), _bits(want_lo))
    # the edge cases: ties to even, and float64 through float32
    assert float(hi[4096]) == 1.0 and float(hi[4097]) == 1 + 2 ** -6
    if dtype == np.float64:
        assert float(hi[-1]) == 1.0 and float(lo[-1]) == 2 ** -8


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bf16x3_plain_matches_jax_dot_bf16x3(dtype, x64):
    """Elementwise within K 2^-24 sum_k |x_ik y_kj| (the float32 sums'
    spread), K = 96."""
    r = rng(12)
    x = (r.standard_normal((64, 96)) * 3).astype(dtype)
    y = r.standard_normal((96, 80)).astype(dtype)
    want = np.asarray(j_chol._dot_bf16x3(jnp.asarray(x), jnp.asarray(y)))
    got = ch.bf16x3_plain(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    spread = 96 * 2.0 ** -24 * (np.abs(x) @ np.abs(y))
    assert np.all(np.abs(got.numpy().astype(np.float64) - want) <= spread)


# -- the factorization against pallas_cholesky_hbm -----------------------------------
def test_high_plain_matches_pallas_hbm_high_interpret():
    """n = 256, P = 64 (every trailing product bf16x3 in both packages):
    rtol = atol = 1e-5, and the port within 0.4 of JAX's own gap between
    "high" and "highest" from JAX's "high" (0.21 here)."""
    a = _spd(256, seed=2)
    run = lambda mode: np.asarray(j_chol.pallas_cholesky_hbm(
        jnp.asarray(a), panel_width=64, interpret=True,
        trailing_precision=mode))
    high, highest = run("high"), run("highest")
    got = kernels.cholesky_plain(t(a), "high", panel_width=64).numpy()
    close(got, high, rtol=1e-5, atol=1e-5)
    gap = np.abs(high - highest).max()
    assert gap > 0
    assert np.abs(got - high).max() <= 0.4 * gap
    # the CPU wrapper is the plain version
    assert torch.equal(kernels.cholesky(t(a), "high", panel_width=64),
                       torch.from_numpy(got))


def test_high_plain_default_panel_width_matches_pallas_hbm():
    """n = 512 at the default P, `hbm_panel_width(512)` = 256, as JAX's."""
    a = _spd(512, seed=3)
    assert ch.hbm_panel_width(512) == j_chol._hbm_panel_width(512) == 256
    want = j_chol.pallas_cholesky_hbm(jnp.asarray(a), interpret=True,
                                      trailing_precision="high")
    close(kernels.cholesky_plain(t(a), "high"), want, rtol=1e-5, atol=1e-5)


def test_high_plain_float64_matches_pallas_hbm(x64):
    """float64, n = 256, P = 64: the bf16 products summed in float32,
    subtracted in float64. Within 1e-8, and within 0.4 of JAX "high"'s
    distance to the float64 factor from JAX's "high"."""
    a = _spd(256, seed=4, dtype=np.float64)
    want = np.asarray(j_chol.pallas_cholesky_hbm(
        jnp.asarray(a), panel_width=64, interpret=True,
        trailing_precision="high"))
    assert want.dtype == np.float64
    got = kernels.cholesky_plain(torch.from_numpy(a), "high", 64).numpy()
    close(got, want, rtol=1e-8, atol=1e-8)
    gap = np.abs(want - np.linalg.cholesky(a)).max()
    assert gap > 1e-12
    assert np.abs(got - want).max() <= 0.4 * gap


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_high_ragged_n_by_residual(dtype):
    """n = 200 (a ragged last tile), P = 64 and 128: max |L L^T - A| /
    max |A| and |L - L64| / max |L64| (L64 the float64 factor) within
    1e-5; the upper triangle zero; not the "highest" factor."""
    a = torch.from_numpy(_spd(200, seed=5, dtype=np.float64))
    l64 = torch.linalg.cholesky(a)
    for p in (64, 128):
        l = kernels.cholesky_plain(a.to(dtype), "high", p).double()
        assert float((l @ l.T - a).abs().max() / a.abs().max()) <= 1e-5
        assert float((l - l64).abs().max() / l64.abs().max()) <= 1e-5
        assert int(torch.count_nonzero(torch.triu(l, 1))) == 0
        assert not torch.equal(l, kernels.cholesky_plain(a.to(dtype)).double())


def test_high_gives_nan_when_not_positive_definite():
    a = _spd(200, seed=6)
    a[130, 130] = -1.0
    l = kernels.cholesky(t(a), "high", panel_width=64)  # raises nothing
    assert torch.isnan(l).any() and torch.isfinite(l[:130, :130]).all()


def test_high_gradient_is_the_two_solve_rule():
    """The backward does not depend on the forward's precision: the same
    rule on the "high" factor, close to the "highest" gradient."""
    a, g = t(_spd(130, seed=7)), t(normal(rng(8), (130, 130)))
    grads = []
    for mode in ("high", "highest"):
        leaf = a.clone().requires_grad_()
        out = kernels.cholesky(leaf, mode)
        grads.append(torch.autograd.grad(out, leaf, g)[0])
    scale = float(grads[1].abs().max())
    close(grads[0], grads[1], rtol=1e-4, atol=1e-4 * scale)


def test_trailing_high_plain_takes_bf16x3_across_p_blocks():
    """The test entry's plain version, one tile column at a time: panel j's
    update of tile column J is `bf16x3_plain` iff floor(64 j / P) <
    floor(64 J / P), the float32 product otherwise (n = 320, P = 128,
    j = 0, 1, 2), then tile (j + 1, j + 1) is its lower factor."""
    n, p = 320, 128
    a = t(10 * np.eye(n) + normal(rng(10), (n, n), 0.1))
    for j in range(3):
        s = 64 * (j + 1)
        got = ch.trailing_high_plain(a, j, p)
        want = a.clone()
        panel = a[:, s - 64:s]
        for col in range(s, n, 64):
            x, y = panel[col:], panel[col:col + 64]
            cross = (64 * j) // p < col // p
            want[col:, col:col + 64] -= (ch.bf16x3_plain(x, y.T) if cross
                                         else x @ y.T)
        e = min(n, s + 64)
        want[s:e, s:e] = torch.linalg.cholesky(
            torch.tril(want[s:e, s:e]) + torch.tril(want[s:e, s:e], -1).T)
        low = torch.tril(torch.ones(n - s, n - s, dtype=torch.bool))
        close(got[s:, s:][low], want[s:, s:][low], rtol=1e-6, atol=1e-6)
        assert torch.equal(got[:, :s], a[:, :s])


def test_high_flops_split_by_the_p_blocks():
    """`cholesky_high_flops`: no bf16x3 product at P >= n, every trailing
    product at P = 64 (tile column J takes J panels' updates of its lower
    entries), fewer as P grows; the two parts sum to n^3 / 3."""
    n = 1024
    assert ch.cholesky_high_flops(n, n)[0] == 0
    crosses = [ch.cholesky_high_flops(n, p)[0] for p in (64, 256, 512)]
    assert crosses[0] == sum(big_j * 2 * 64 * (64 * (n - 64 * big_j) - 2016)
                             for big_j in range(1, n // 64))
    assert crosses[0] > crosses[1] > crosses[2] > 0
    assert sum(ch.cholesky_high_flops(n, 256)) == pytest.approx(n ** 3 / 3)


@pytest.mark.parametrize("fault,kwargs", [
    ("unknown precision", dict(trailing_precision="HIGH")),
    ("default string", dict(trailing_precision="default")),
    ("P not a multiple of 64", dict(trailing_precision="high",
                                    panel_width=96)),
    ("P zero", dict(trailing_precision="high", panel_width=0)),
    ("P negative", dict(trailing_precision="high", panel_width=-64)),
    ("P a float", dict(trailing_precision="high", panel_width=64.0)),
    ("P with highest", dict(trailing_precision="highest", panel_width=64))])
def test_refusals(fault, kwargs):
    """The JAX package treats an unknown string as HIGHEST; the port
    raises, on every device and in the plain version."""
    a = t(_spd(64))
    for fn in (kernels.cholesky, kernels.cholesky_plain):
        with pytest.raises(ValueError):
            fn(a, **kwargs)
    with pytest.raises(ValueError):
        kernels.cholesky(a.to("meta"), **kwargs)


def test_trailing_entry_refuses_a_panel_without_a_trailing_matrix():
    a = t(_spd(256))
    for j in (-1, 3):
        with pytest.raises(ValueError, match="trailing"):
            ch.trailing_high(a, j, 64)
    with pytest.raises(ValueError, match="multiple"):
        ch.trailing_high(a, 0, 32)


# -- the core attention entries where the card now computes too ----------------------
@pytest.mark.parametrize("layout", ["split", "packed"])
@pytest.mark.parametrize("shape", [(1, 2, 576, 24), (2, 2, 64, 40)])
def test_core_entries_beyond_512_and_at_padded_widths_match_jax(shape,
                                                                layout):
    """S 576 (the JAX package's jnp reference on every backend) and Dh 40
    (a width the kernels pad to 48): the public entries and their backward
    entries against the JAX ones, float32, rate 0; values within 1e-5 /
    1e-6, gradients within 1e-4 / 1e-5."""
    b, h, s, dh = shape
    r = rng(s + dh)
    g = normal(r, shape if layout == "split" else (b, s, h * dh), 0.5)
    if layout == "split":
        args = tuple(normal(r, shape, sc) for sc in (0.3, 0.3, 1.0))
        j_fn = lambda *x: j_fa.fused_attention(SEED, *x, 0.0, False)
        t_fn = kernels.fused_attention
        t_bwd = lambda *x: kernels.fused_attention_bwd(*x)
    else:
        args = (normal(r, (b, s, 3 * h * dh), 0.3),)
        j_fn = lambda x: j_fa.fused_attention_qkv(SEED, x, h, 0.0, False)
        t_fn = lambda x: kernels.fused_attention_qkv(x, h)
        t_bwd = lambda x, g_: (kernels.fused_attention_qkv_bwd(x, g_, h),)
    j_args = tuple(map(jnp.asarray, args))
    want, vjp = jax.vjp(j_fn, *j_args)
    want_grads = vjp(jnp.asarray(g))
    leaves = [t(x).requires_grad_() for x in args]
    out = t_fn(*leaves)
    close(out, want, 1e-5, 1e-6)
    out.backward(t(g))
    for leaf, got, w in zip(leaves, t_bwd(*map(t, args), t(g)), want_grads):
        close(leaf.grad, w, 1e-4, 1e-5)
        close(got, w, 1e-4, 1e-5)


def test_core_split_entry_bf16_beyond_512_matches_jax():
    """bf16 q, k, v at S 576, Dh 40: the split entry's forward against the
    JAX one (its `_reference` on bf16) within 2^-7 max |v|, the card's bar
    for the bf16 forwards."""
    r = rng(13)
    shape = (1, 2, 576, 40)
    q, k, v = (normal(r, shape, sc) for sc in (0.3, 0.3, 1.0))
    bf = lambda x: jnp.asarray(x).astype(jnp.bfloat16)
    want = j_fa.fused_attention(SEED, bf(q), bf(k), bf(v), 0.0, False)
    got = kernels.fused_attention(*(t(x).to(torch.bfloat16)
                                    for x in (q, k, v)))
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - np.asarray(want.astype(jnp.float32)))
    assert diff.max() <= 2.0 ** -7 * np.abs(v).max()
