"""The port's three kernel modules: plain versions vs the JAX package (its
public dispatch and, for two of them, the Pallas body in interpret mode),
their gradients vs jax.vjp, the dropout mask's generator, and the
wrappers' dispatch and checks. The CUDA kernels themselves are held
against the plain versions on the card by tests/test_torch_cuda.py."""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpnf_tpu.ops import logistic as j_logistic
from gpnf_tpu.ops.pallas import fused_attention as j_fa
from gpnf_tpu.ops.pallas import fused_mixlogcdf as j_fm
from gpnf_tpu.ops.pallas import fused_mixture_inverse as j_fmi
from gpnf_tpu_torch.ops import kernels
from gpnf_tpu_torch.ops.kernels import _native
from torch_parity import close, normal, rng, t

# the module (the package's name `fused_attention` is the entry point)
fa = importlib.import_module("gpnf_tpu_torch.ops.kernels.fused_attention")
SEED = jnp.zeros((1,), jnp.int32)


def _seq_w(s=32, c=96, seed=0):
    r = rng(seed)
    return normal(r, (2, s, c), 0.5), normal(r, (3 * c, c), 0.1)


def _mix_inputs(b=8, k=4, d=256, seed=1):
    r = rng(seed)
    return (normal(r, (b, d), 0.5), normal(r, (b, d), 0.1),
            normal(r, (b, d), 0.1), normal(r, (b, k, d)), normal(r, (b, k, d)),
            normal(r, (b, k, d), 0.3))


def _inverse_inputs(b=8, k=4, d=128, seed=2):
    """Well-conditioned y: the mixture CDF of moderate x, clipped."""
    r = rng(seed)
    pi, mu, s = (normal(r, (b, k, d)), normal(r, (b, k, d), 2.0),
                 normal(r, (b, k, d), 0.4))
    x_true = normal(r, (b, d), 2.0)
    y = np.clip(np.exp(np.asarray(j_logistic.mixture_log_cdf(
        jnp.asarray(x_true), jnp.asarray(pi), jnp.asarray(mu),
        jnp.asarray(s)))), 1e-5, 1 - 1e-5).astype(np.float32)
    return y, pi, mu, s, x_true


@pytest.mark.parametrize("s,heads", [(32, 4), (16, 4), (64, 2)])
def test_attention_plain_matches_jax(s, heads):
    seq, w = _seq_w(s)
    want = j_fa.fused_attention_proj(SEED, jnp.asarray(seq), jnp.asarray(w),
                                     heads, 0.0, False)
    close(kernels.attention_proj_plain(t(seq), t(w), heads), want)


def test_attention_plain_matches_pallas_interpret():
    from jax.experimental import pallas as pl

    seq, w = _seq_w()
    b, s, c = seq.shape
    blk = pl.BlockSpec((1, s, c), lambda i: (i, 0, 0))
    w_spec = pl.BlockSpec((3 * c, c), lambda i: (0, 0))
    want = pl.pallas_call(
        functools.partial(j_fa._fwd_kernel_proj, rate=0.0, heads=4),
        grid=(b,), in_specs=[pl.BlockSpec(memory_space=None), blk, w_spec],
        out_specs=blk, out_shape=jax.ShapeDtypeStruct((b, s, c), jnp.float32),
        interpret=True,
    )(SEED, jnp.asarray(seq), jnp.asarray(w))
    close(kernels.attention_proj_plain(t(seq), t(w), 4), want)


def test_mixlogcdf_plain_matches_jax():
    args = _mix_inputs()
    got = kernels.mixlogcdf_plain(*map(t, args))
    for g, w in zip(got, j_fm.mixlogcdf_forward(*map(jnp.asarray, args))):
        close(g, w)


def test_mixlogcdf_plain_matches_pallas_interpret():
    from jax.experimental import pallas as pl

    args = _mix_inputs(k=4, d=256)
    el = pl.BlockSpec((8, 128), lambda i, j: (i, j))
    mix = pl.BlockSpec((8, 4, 128), lambda i, j: (i, 0, j))
    want = pl.pallas_call(
        j_fm._kernel, grid=(1, 2), in_specs=[el, el, el, mix, mix, mix],
        out_specs=[el, el],
        out_shape=[jax.ShapeDtypeStruct((8, 256), jnp.float32)] * 2,
        interpret=True,
    )(*map(jnp.asarray, args))
    for g, w in zip(kernels.mixlogcdf_plain(*map(t, args)), want):
        close(g, w)


def test_mixture_inverse_plain_matches_jax():
    y, pi, mu, s, x_true = _inverse_inputs()
    got = kernels.mixture_inverse_plain(t(y), t(pi), t(mu), t(s))
    want = j_fmi.mixture_inverse(*map(jnp.asarray, (y, pi, mu, s)))
    close(got, want, rtol=0, atol=1e-4)
    # and it inverts: CDF(x) = y
    y_rec = np.exp(np.asarray(j_logistic.mixture_log_cdf(
        jnp.asarray(got.numpy()), *map(jnp.asarray, (pi, mu, s)))))
    close(y_rec, y, rtol=0, atol=2e-6)


@pytest.mark.parametrize("name", ["fused_attention_proj",
                                  "fused_attention_proj_bwd",
                                  "mixlogcdf_forward", "mixture_inverse"])
def test_wrapper_takes_plain_version_on_cpu_without_counting(name):
    kernels.reset_launch_counts()
    if name == "fused_attention_proj":
        seq, w = map(t, _seq_w())
        close(kernels.fused_attention_proj(seq, w, 4),
              kernels.attention_proj_plain(seq, w, 4), 0, 0)
    elif name == "fused_attention_proj_bwd":
        seq, w = map(t, _seq_w())
        g = t(normal(rng(9), seq.shape))
        seed = torch.tensor([3], dtype=torch.int32)
        for got, want in zip(
                kernels.fused_attention_proj_bwd(seq, w, g, 4, 0.2, seed),
                kernels.attention_proj_plain_bwd(seq, w, g, 4, 0.2, seed)):
            close(got, want, 0, 0)
    elif name == "mixlogcdf_forward":
        args = list(map(t, _mix_inputs()))
        for g, w in zip(kernels.mixlogcdf_forward(*args),
                        kernels.mixlogcdf_plain(*args)):
            close(g, w, 0, 0)
    else:
        args = list(map(t, _inverse_inputs()[:4]))
        close(kernels.mixture_inverse(*args),
              kernels.mixture_inverse_plain(*args), 0, 0)
    assert kernels.launch_counts()[name] == 0


def test_wrappers_reject_bad_calls():
    seq, w = map(t, _seq_w())
    with pytest.raises(ValueError, match="seed"):  # dropout needs a seed
        kernels.fused_attention_proj(seq, w, 4, rate=0.1)
    with pytest.raises(ValueError):
        kernels.fused_attention_proj(seq, w[:-1], 4)
    x, a, b, pi, mu, s = map(t, _mix_inputs())
    with pytest.raises(ValueError):
        kernels.mixlogcdf_forward(x, a, b[:, :-1], pi, mu, s)
    with pytest.raises(ValueError):
        kernels.mixture_inverse(x, pi, mu[:, :-1], s)


def test_cuda_input_checks_raise_for_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors only"):
        _native.check_cuda_inputs("k", x=torch.zeros(2))
    seq, w = map(t, _seq_w())
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kernels.fused_attention_proj(seq, w.to("meta"), 4)


def test_native_build_names_every_source():
    assert set(_native.SOURCES) == set(_native.SIGNATURES)
    for name in _native.SOURCES:
        assert (_native.CSRC / f"{name}.cu").exists()
        assert _native.library_path(name).parent == _native.BUILD_DIR



# -- gradients and dropout -------------------------------------------------------
def _attention_grad_inputs():
    seq, w = _seq_w()  # B=2, S=32, C=96, 4 heads
    return seq, w, normal(rng(3), seq.shape, 0.5)


def test_attention_plain_fwd_bwd_match_jax_vjp():
    seq, w, g = _attention_grad_inputs()
    out, vjp = jax.vjp(lambda a, b: j_fa.fused_attention_proj(
        SEED, a, b, 4, 0.0, False), jnp.asarray(seq), jnp.asarray(w))
    want_dseq, want_dw = vjp(jnp.asarray(g))
    close(kernels.attention_proj_plain(t(seq), t(w), 4), out, 1e-4, 1e-5)
    dseq, dw = kernels.attention_proj_plain_bwd(t(seq), t(w), t(g), 4)
    close(dseq, want_dseq, 1e-4, 1e-5)
    close(dw, want_dw, 1e-4, 1e-5)
    # and through torch autograd of the wrapper (the autograd.Function)
    seq_t, w_t = t(seq).requires_grad_(), t(w).requires_grad_()
    kernels.fused_attention_proj(seq_t, w_t, 4).backward(t(g))
    close(seq_t.grad, want_dseq, 1e-4, 1e-5)
    close(w_t.grad, want_dw, 1e-4, 1e-5)


def test_attention_plain_bwd_matches_pallas_bwd_kernel_interpret():
    """`_bwd_kernel_proj` on a 2-program grid, so that dW accumulates across
    programs, as tests/test_fused_attention.py runs it."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    seq, w, g = _attention_grad_inputs()
    b, s, c = seq.shape
    blk = pl.BlockSpec((1, s, c), lambda i: (i, 0, 0))
    w_spec = pl.BlockSpec((3 * c, c), lambda i: (0, 0))
    want_dseq, want_dw = pl.pallas_call(
        functools.partial(j_fa._bwd_kernel_proj, rate=0.0, heads=4),
        grid=(b,),
        in_specs=[pl.BlockSpec(memory_space=None), blk, w_spec, blk],
        out_specs=[blk, w_spec],
        out_shape=[jax.ShapeDtypeStruct((b, s, c), jnp.float32),
                   jax.ShapeDtypeStruct((3 * c, c), jnp.float32)],
        scratch_shapes=[pltpu.VMEM((1, s, 3 * c), jnp.float32)],
        interpret=True,
    )(SEED, jnp.asarray(seq), jnp.asarray(w), jnp.asarray(g))
    dseq, dw = kernels.attention_proj_plain_bwd(t(seq), t(w), t(g), 4)
    close(dseq, want_dseq, 1e-4, 1e-5)
    close(dw, want_dw, 1e-4, 1e-5)


def test_attention_plain_bwd_with_dropout_matches_autograd():
    """At rate 0.2 the explicit backward against autograd of the plain
    forward, both drawing the mask from the same seed."""
    seq, w, g = _attention_grad_inputs()
    seed = torch.tensor([77], dtype=torch.int32)
    seq_t, w_t = t(seq).requires_grad_(), t(w).requires_grad_()
    out = kernels.attention_proj_plain(seq_t, w_t, 4, 0.2, seed)
    out.backward(t(g))
    dseq, dw = kernels.attention_proj_plain_bwd(t(seq), t(w), t(g), 4, 0.2,
                                                seed)
    close(dseq, seq_t.grad, 1e-5, 1e-6)
    close(dw, w_t.grad, 1e-5, 1e-6)
    # dropout changed the output: the mask is in effect
    assert not torch.allclose(out, kernels.attention_proj_plain(
        t(seq), t(w), 4), atol=1e-3)


def test_philox_matches_known_answers():
    """Philox4x32-10 known-answer vectors of the Random123 distribution."""
    cases = [((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c,
                                      0x9b00dbd8)),
             ((0xffffffff,) * 4, (0xffffffff,) * 2,
              (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
             ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
              (0xa4093822, 0x299f31d0),
              (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]
    philox = fa.philox4x32_10
    for ctr, key, want in cases:
        ctr = [torch.tensor([v], dtype=torch.int64) for v in ctr]
        got = philox(*ctr, torch.tensor([key[0]], dtype=torch.int64), key[1])
        assert [int(x) for x in got] == list(want)


def test_dropout_keep_fraction_within_5_sigma():
    keep = fa.dropout_keep_plain(
        torch.tensor([2024], dtype=torch.int32), 16, 4, 128, 0.2)
    n = keep.numel()
    assert n >= 1_000_000
    sigma = (0.2 * 0.8 / n) ** 0.5
    assert abs(float(keep.float().mean()) - 0.8) < 5 * sigma


def test_dropout_masks_differ_across_seeds_and_heads():
    mask = lambda seed: fa.dropout_keep_plain(
        torch.tensor([seed], dtype=torch.int32), 2, 2, 64, 0.5)
    a, b = mask(1), mask(2)
    assert torch.equal(a, mask(1))  # a pure function of the seed
    assert not torch.equal(a, b)
    assert not torch.equal(a[0, 0], a[0, 1])  # heads
    assert not torch.equal(a[0, 0], a[1, 0])  # batch rows
    # about half the bits differ between unrelated masks
    assert 0.45 < float((a != b).float().mean()) < 0.55
    assert bool(fa.dropout_keep_plain(
        torch.tensor([1], dtype=torch.int32), 1, 1, 8, 0.0).all())


def test_mixlogcdf_forward_grads_match_jax_vjp():
    args = _mix_inputs(b=4, k=4, d=64)
    r = rng(5)
    gy, gl = normal(r, (4, 64)), normal(r, (4, 64))
    _, vjp = jax.vjp(j_fm.mixlogcdf_forward, *map(jnp.asarray, args))
    want = vjp((jnp.asarray(gy), jnp.asarray(gl)))
    inputs = [t(a).requires_grad_() for a in args]
    y, ldj = kernels.mixlogcdf_forward(*inputs)
    got = torch.autograd.grad([y, ldj], inputs, [t(gy), t(gl)])
    for g_, w_ in zip(got, want):
        close(g_, w_, 1e-4, 1e-5)


def test_mixture_inverse_grads_match_jax_vjp():
    y, pi, mu, s, _ = _inverse_inputs(b=4, k=4, d=32)
    g = normal(rng(6), y.shape)
    _, vjp = jax.vjp(j_fmi.mixture_inverse, *map(jnp.asarray, (y, pi, mu, s)))
    want = vjp(jnp.asarray(g))
    inputs = [t(a).requires_grad_() for a in (y, pi, mu, s)]
    got = torch.autograd.grad(kernels.mixture_inverse(*inputs), inputs, t(g))
    for g_, w_ in zip(got, want):
        close(g_, w_, 1e-4, 1e-5)
