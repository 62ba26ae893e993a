"""The GP head's kernels and the exact GP against the JAX package (CPU).

The port's plain Cholesky, triangular solve and affine transform against
the JAX package's CPU paths and against the Pallas kernels in interpret
mode; their gradients (the port's autograd.Functions) against jax.vjp; and
GPRegression's median-heuristic init, NLML, posterior and a 20-step Adam
trajectory against the JAX module with the same data. The CUDA kernels
themselves are held against the plain versions on the card by
tests/test_torch_cuda.py."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gpnf_tpu.models.gp import GPConfig as JaxGPConfig
from gpnf_tpu.models.gp import GPRegression as JaxGP
from gpnf_tpu.ops.pallas import cholesky as j_chol
from gpnf_tpu.ops.pallas import fused_coupling as j_fc
from gpnf_tpu.ops.pallas import trisolve as j_tri
from gpnf_tpu_torch import convert
from gpnf_tpu_torch.models.gp import GPConfig, GPRegression
from gpnf_tpu_torch.ops import kernels
from torch_parity import close, normal, rng, t

KEY = jax.random.PRNGKey(0)


def _spd(size, seed=0):
    """X X^T / n + I (eigenvalues in [1, 5]) in float32."""
    x = rng(seed).standard_normal((size, size))
    return (x @ x.T / size + np.eye(size)).astype(np.float32)


def _lower(size, seed=1):
    return np.linalg.cholesky(_spd(size, seed).astype(np.float64)).astype(
        np.float32)


# -- Cholesky --------------------------------------------------------------------
@pytest.mark.parametrize("size", [1, 63, 65, 129, 200, 256])
def test_cholesky_plain_matches_jax_blocked(size):
    a = _spd(size)
    close(kernels.cholesky_plain(t(a)),
          j_chol.cholesky_blocked(jnp.asarray(a), use_pallas=False),
          rtol=1e-5, atol=1e-5)


def test_cholesky_plain_matches_pallas_kernels_interpret():
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    a = _spd(128)
    want = pl.pallas_call(
        j_chol._chol_kernel,
        out_shape=jax.ShapeDtypeStruct((128, 128), jnp.float32),
        scratch_shapes=[pltpu.VMEM((128, 128), jnp.float32)],
        interpret=True)(jnp.asarray(a))
    close(kernels.cholesky_plain(t(a)), want, rtol=1e-5, atol=1e-5)
    a = _spd(256, seed=2)
    want = j_chol.pallas_cholesky_hbm(jnp.asarray(a), panel_width=64,
                                      interpret=True)
    close(kernels.cholesky_plain(t(a)), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("row", [70, 64, 128])
def test_cholesky_plain_gives_nan_when_not_positive_definite(row):
    a = _spd(130)
    a[row, row] = -1.0
    l = kernels.cholesky(t(a))  # raises nothing
    assert torch.isnan(l).any() and torch.isfinite(l[:row, :row]).all()
    assert torch.count_nonzero(torch.triu(torch.nan_to_num(l), 1)) == 0


def test_cholesky_grad_matches_jax_vjp():
    a, g = _spd(200), normal(rng(3), (200, 200))
    at = t(a).requires_grad_()
    got = torch.autograd.grad(kernels.cholesky(at), at, t(g))[0]
    _, vjp = jax.vjp(lambda m: j_chol.cholesky_blocked(m, use_pallas=False),
                     jnp.asarray(a))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    close(got, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))


# -- triangular solve ---------------------------------------------------------------
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("p", [1, 5])
def test_tril_solve_plain_matches_jax(p, trans):
    from jax.experimental import pallas as pl

    l, b = _lower(200), normal(rng(4), (200, p))
    want = j_tri.tril_solve(jnp.asarray(l), jnp.asarray(b), trans=trans,
                            use_pallas=False)
    close(kernels.tril_solve_plain(t(l), t(b), trans=trans), want,
          rtol=1e-5, atol=1e-5)
    # the Pallas body in interpret mode, on the padding `tril_solve` applies
    l_p = np.eye(256, dtype=np.float32)
    l_p[:200, :200] = l
    b_p = np.zeros((256, p), np.float32)
    b_p[:200] = b
    got = pl.pallas_call(partial(j_tri._solve_kernel, trans=trans),
                         out_shape=jax.ShapeDtypeStruct((256, p), jnp.float32),
                         interpret=True)(jnp.asarray(l_p), jnp.asarray(b_p))
    close(kernels.tril_solve_plain(t(l), t(b), trans=trans),
          np.asarray(got)[:200], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("trans", [False, True])
def test_tril_solve_vector_and_grads_match_jax_vjp(trans):
    l, b = _lower(200), normal(rng(5), (200,))
    g = normal(rng(6), (200,))
    lt, bt = t(l).requires_grad_(), t(b).requires_grad_()
    x = kernels.tril_solve(lt, bt, trans=trans)
    got = torch.autograd.grad(x, (lt, bt), t(g))
    fn = lambda l_, b_: j_tri.tril_solve(l_, b_, trans=trans, use_pallas=False)
    x_j, vjp = jax.vjp(fn, jnp.asarray(l), jnp.asarray(b))
    close(x, x_j, rtol=1e-5, atol=1e-5)
    for got_, want in zip(got, vjp(jnp.asarray(g))):
        want = np.asarray(want)
        close(got_, want, rtol=1e-4, atol=1e-5 * float(np.abs(want).max()))


# -- affine coupling kernel -----------------------------------------------------------
def _affine_inputs(b=8, d=256):
    r = rng(7)
    return normal(r, (b, d)), normal(r, (b, d), 0.1), normal(r, (b, d), 0.5)


def test_fused_affine_plain_matches_jax_and_pallas_interpret():
    from jax.experimental import pallas as pl

    x2, shift, raw = _affine_inputs()
    y, ldj = kernels.fused_affine_plain(t(x2), t(shift), t(raw))
    y_j, ldj_j = j_fc.fused_affine_forward(*map(jnp.asarray, (x2, shift, raw)))
    close(y, y_j, rtol=1e-6, atol=1e-6)
    close(ldj, ldj_j, rtol=1e-5, atol=1e-5)
    spec = pl.BlockSpec((j_fc.TILE_B, 256), lambda i: (i, 0))
    ldj_spec = pl.BlockSpec((j_fc.TILE_B, j_fc.LANES), lambda i: (i, 0))
    y_k, ldj128 = pl.pallas_call(
        j_fc._fwd_kernel, grid=(1,), in_specs=[spec, spec, spec],
        out_specs=[spec, ldj_spec],
        out_shape=[jax.ShapeDtypeStruct((8, 256), jnp.float32),
                   jax.ShapeDtypeStruct((8, j_fc.LANES), jnp.float32)],
        interpret=True)(*map(jnp.asarray, (x2, shift, raw)))
    close(y, y_k, rtol=1e-6, atol=1e-6)
    close(ldj, jnp.sum(ldj128, -1), rtol=1e-5, atol=1e-5)


def test_fused_affine_grads_match_jax_vjp():
    x2, shift, raw = _affine_inputs(b=6, d=40)  # a shape the TPU kernel refuses
    gy, gl = normal(rng(8), (6, 40)), normal(rng(9), (6,))
    args = [t(a).requires_grad_() for a in (x2, shift, raw)]
    got = torch.autograd.grad(kernels.fused_affine_forward(*args), args,
                              (t(gy), t(gl)))
    _, vjp = jax.vjp(j_fc.fused_affine_forward,
                     *map(jnp.asarray, (x2, shift, raw)))
    for got_, want in zip(got, vjp((jnp.asarray(gy), jnp.asarray(gl)))):
        close(got_, want, rtol=1e-5, atol=1e-6)


def test_gp_wrappers_take_plain_versions_on_cpu_and_check_shapes():
    kernels.reset_launch_counts()
    a = t(_spd(64))
    kernels.tril_solve(kernels.cholesky(a), a[:, :3])
    kernels.fused_affine_forward(*map(t, _affine_inputs()))
    counts = kernels.launch_counts()
    assert counts["cholesky"] == counts["tril_solve"] == 0
    assert counts["fused_affine_forward"] == 0
    with pytest.raises(ValueError):
        kernels.cholesky(a[:, :10])
    with pytest.raises(ValueError):
        kernels.tril_solve(a, a[:10])
    with pytest.raises(ValueError):
        kernels.fused_affine_forward(a, a, a[:, :3])
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kernels.cholesky(a.to("meta"))


# -- exact GP ---------------------------------------------------------------------
def _gp_data(size=16, dim=3, seed=10):
    """n = 16: 120 distinct pairs, an even count (the median averages the
    two middle values)."""
    r = rng(seed)
    x = r.uniform(-2, 2, (size, dim)).astype(np.float32)
    y = (np.sin(x[:, 0]) + 0.1 * r.standard_normal(size)).astype(np.float32)
    return x, y


def _pair(kernel="rbf", ard=True, size=16, dim=3):
    x, y = _gp_data(size, dim)
    jgp = JaxGP(JaxGPConfig(kernel=kernel, ard=ard, use_pallas_cholesky=False,
                            use_pallas_trisolve=False), dim)
    params = jgp.init_from_data(KEY, jnp.asarray(x), jnp.asarray(y))
    tgp = GPRegression(GPConfig(kernel=kernel, ard=ard), dim, device="cpu")
    tgp.init_from_data(t(x), t(y))
    return x, y, jgp, params, tgp


@pytest.mark.parametrize("kernel", ["rbf", "matern12", "matern32", "matern52"])
def test_gp_init_nlml_posterior_match_jax(kernel):
    x, y, jgp, params, tgp = _pair(kernel)
    for key, value in params.items():
        close(getattr(tgp, key).detach(), np.broadcast_to(
            value, getattr(tgp, key).shape), rtol=1e-6, atol=1e-6)
    x_te = rng(11).uniform(-2, 2, (5, 3)).astype(np.float32)
    with torch.no_grad():
        close(tgp.neg_log_marginal_likelihood(t(x), t(y)),
              jgp.neg_log_marginal_likelihood(params, jnp.asarray(x),
                                              jnp.asarray(y)),
              rtol=1e-5, atol=1e-5)
        mean, var = tgp.posterior(t(x), t(y), t(x_te))
    mean_j, var_j = jgp.posterior(params, *map(jnp.asarray, (x, y, x_te)))
    close(mean, mean_j, rtol=1e-4, atol=1e-5)
    close(var, var_j, rtol=1e-4, atol=1e-6)


def test_gp_params_load_from_jax():
    x, y, jgp, params, _ = _pair(ard=False)
    tgp = GPRegression(GPConfig(ard=False), 3, device="cpu")
    convert.gp_params_from_jax(tgp, jax.device_get(params))
    with torch.no_grad():
        close(tgp.neg_log_marginal_likelihood(t(x), t(y)),
              jgp.neg_log_marginal_likelihood(params, jnp.asarray(x),
                                              jnp.asarray(y)),
              rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        convert.gp_params_from_jax(tgp, {"log_noise": np.zeros(())})


def test_gp_fit_trajectory_matches_jax_adam():
    """20 Adam steps from the same init: the NLML before each update (the
    JAX module's lax.scan body, run step by step) and the final
    hyperparameters."""
    x, y, jgp, params, tgp = _pair(size=32)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    opt = optax.adam(0.05)
    state = opt.init(params)
    step = jax.jit(jax.value_and_grad(jgp.neg_log_marginal_likelihood))
    want = []
    for _ in range(20):
        loss, grads = step(params, xj, yj)
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        want.append(float(loss))
    got = tgp.fit(t(x), t(y), steps=20, lr=0.05)
    assert got.shape == (20,) and got[-1] < got[0]
    close(got, np.asarray(want), rtol=1e-4, atol=1e-4)
    for key, value in params.items():
        close(getattr(tgp, key).detach(), np.broadcast_to(
            value, getattr(tgp, key).shape), rtol=1e-3, atol=1e-4)
