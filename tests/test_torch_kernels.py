"""The port's three kernel modules: plain versions vs the JAX package (its
public dispatch and, for two of them, the Pallas body in interpret mode),
and the wrappers' dispatch and checks. The CUDA kernels themselves are
held against the plain versions on the card by tests/test_torch_cuda.py."""
import functools

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


@pytest.mark.parametrize("name", ["fused_attention_proj", "mixlogcdf_forward",
                                  "mixture_inverse"])
def test_wrapper_takes_plain_version_on_cpu_without_counting(name):
    kernels.reset_launch_counts()
    if name == "fused_attention_proj":
        seq, w = map(t, _seq_w())
        close(kernels.fused_attention_proj(seq, w, 4),
              kernels.attention_proj_plain(seq, w, 4), 0, 0)
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
    with pytest.raises(NotImplementedError):
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

