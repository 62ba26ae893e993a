"""The flow -> GP slice against the JAX package (CPU).

A tiny affine flow with Gaussian split priors and no attention (8x8x3, L=2,
K=1, hidden 8), initialised by the JAX package and perturbed so that every
zero-initialised conv is live, is carried into the port by convert.py:
encode, ddi, eps_std=0 sampling and the inverse round trip are compared in
float32; the joint NLML and the gradient of every parameter of the flow
and the GP in float64 (jax_enable_x64, as tests/test_flow_gp.py), plus
central differences on a few coordinates of the port alone. Then the
FlowGP fit modes and the train_gp CLI at a tiny size."""
import copy
import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpnf_tpu.models.gp import FlowGP as JaxFlowGP
from gpnf_tpu.models.gp import GPConfig as JaxGPConfig
from gpnf_tpu.models.gp import GPRegression as JaxGP
from gpnf_tpu.models.gp import flow_feature_fn as jax_feature_fn
from gpnf_tpu.models.marscf import MarScfConfig as JaxConfig
from gpnf_tpu.models.marscf import MarScfFlow as JaxFlow
from gpnf_tpu_torch import convert, train_gp
from gpnf_tpu_torch.models.gp import FlowGP, GPConfig, GPRegression
from gpnf_tpu_torch.models.marscf import MarScfConfig, MarScfFlow
from torch_parity import close, n, rng, t

TINY = dict(image_shape=(8, 8, 3), L=2, K=1, hidden_channels=8,
            coupling="affine", use_attention=False, prior="gaussian",
            drop_prob=0.0)
NUM_DIMS = 8 * 8 * 3


def _perturbed(params, scale=0.05, seed=0):
    """Every leaf plus N(0, scale) noise (the invconv's permutation and
    signs kept), so the zero-init convs of the couplings and splits are
    live."""
    r = rng(seed)
    flat = convert.flatten(jax.device_get(params))
    out = {}
    for key, value in flat.items():
        keep = key.endswith(("invconv/p", "invconv/sign_s"))
        out[key] = value if keep else (
            value + scale * r.standard_normal(value.shape)).astype(value.dtype)
    return out


def _images(batch=4, seed=1, dtype=np.float32):
    return (rng(seed).random((batch, 3, 8, 8)) - 0.5).astype(dtype)


@pytest.fixture(scope="module")
def models():
    jm = JaxFlow(JaxConfig(**TINY))  # K-stacked steps
    flat = _perturbed(jm.init(jax.random.PRNGKey(0)))
    params = jm.init(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map_with_path(
        lambda path, _: jnp.asarray(flat["/".join(
            str(getattr(k, "key", getattr(k, "idx", k))) for k in path)]),
        params)
    tm = MarScfFlow(MarScfConfig(**TINY), device="cpu").eval()
    convert.load_jax_params(tm, flat)
    return jm, params, tm


def test_affine_flow_encode_matches_jax(models):
    jm, params, tm = models
    z = _images()
    logdet = np.full((4,), -math.log(256.0) * NUM_DIMS, np.float32)
    zf_j, obj_j = jm.encode(params, jnp.asarray(z), jnp.asarray(logdet))
    with torch.no_grad():
        zf, obj = tm.encode(t(z), t(logdet))
    bpd = lambda o: -n(o) / (math.log(2.0) * NUM_DIMS)
    close(bpd(obj), bpd(obj_j), rtol=0, atol=1e-5)
    close(zf, zf_j, rtol=1e-5, atol=1e-5)


def test_affine_flow_ddi_matches_jax(models):
    jm, params, tm = models
    x = _images(batch=8, seed=2)
    key = jax.random.PRNGKey(3)
    want = convert.jax_to_state_dict(
        jax.device_get(jm.ddi(params, jnp.asarray(x), key)))
    noise = np.asarray(jax.random.uniform(key, x.shape, jnp.float32))
    fresh = copy.deepcopy(tm)
    fresh.ddi(t(x), noise=t(noise))
    got = fresh.state_dict()
    assert set(got) == set(want)
    touched = ("actnorm.bias", "actnorm.logs", "an_bias", "an_logs")
    for key_ in want:
        if key_.endswith(touched):
            close(got[key_], want[key_], rtol=1e-4, atol=1e-5)
        else:  # ddi touches nothing else
            close(got[key_], want[key_], 0, 0)


def test_affine_flow_sample_and_round_trip(models):
    jm, params, tm = models
    want = jm.sample(params, jax.random.PRNGKey(1), batch=2, eps_std=0.0)
    with torch.no_grad():
        got = tm.sample(2, eps_std=0.0)
        drawn = tm.sample(2, eps_std=0.7,
                          generator=torch.Generator().manual_seed(0))
    assert got.shape == drawn.shape == (2, 3, 8, 8)
    assert torch.isfinite(drawn).all()
    close(got, want, rtol=0, atol=1e-4)
    for level, (c, h, w) in zip(tm.levels, tm.level_shapes):
        z = t(rng(4).standard_normal((2, c, h, w)) * 0.5)
        with torch.no_grad():
            y, ld = level(z, torch.zeros(2))
            z2, ld2 = level.inverse(y, ld)
        close(z2, z, rtol=0, atol=1e-5)
        close(ld2, np.zeros(2), rtol=0, atol=1e-4)


def _joint_float64():
    """The JAX package's joint tree, NLML and gradients in float64, and the
    port's FlowGP with the same weights."""
    jflow = JaxFlow(JaxConfig(**TINY, scan_steps=False, remat=False))
    flat = _perturbed(jflow.init(jax.random.PRNGKey(0)), seed=5)
    x = _images(batch=10, seed=6, dtype=np.float64)
    y = np.tanh(x.sum(axis=(1, 2, 3)))
    fparams = jflow.init(jax.random.PRNGKey(0))
    fparams = jax.tree_util.tree_map_with_path(
        lambda path, _: jnp.asarray(flat["/".join(
            str(getattr(k, "key", getattr(k, "idx", k))) for k in path)],
            jnp.float64), fparams)
    feat = jax_feature_fn(jflow)
    z0 = feat(fparams, jnp.asarray(x))
    jgp = JaxGP(JaxGPConfig(ard=False, use_pallas_cholesky=False,
                            use_pallas_trisolve=False), z0.shape[-1])
    joint = {"gp": jgp.init_from_data(jax.random.PRNGKey(0), z0,
                                      jnp.asarray(y)),
             "flow": fparams}
    fgp = JaxFlowGP(feat, jgp)
    val, grads = jax.jit(jax.value_and_grad(fgp.joint_nlml))(
        joint, jnp.asarray(x), jnp.asarray(y))
    port = FlowGP(MarScfFlow(MarScfConfig(**TINY), device="cpu").double(),
                  GPRegression(GPConfig(ard=False), int(z0.shape[-1]),
                               device="cpu", dtype=torch.float64))
    convert.load_jax_params(port, jax.device_get(joint), dtype=None)
    return (x, y, float(val), convert.jax_to_state_dict(jax.device_get(grads)),
            port)


def test_joint_nlml_and_every_gradient_match_jax_float64():
    try:
        jax.config.update("jax_enable_x64", True)
        x, y, val, want, port = _joint_float64()
    finally:
        jax.config.update("jax_enable_x64", False)
    loss = port.joint_nlml(torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    assert loss.dtype == torch.float64
    # The JAX package's `_sqdist` asks for a float32 accumulator
    # (preferred_element_type) even under x64, so its float64 Gram carries
    # ~2e-8 relative error: the two agree to ~1e-8, not to float64 rounding
    # (measured 8.4e-10 on the NLML, 1.9e-8 of the largest gradient). The
    # central differences below hold the port to float64 on its own.
    close(loss, val, rtol=1e-7, atol=0)
    named = dict(port.named_parameters())
    assert set(named) <= set(want) and len(named) == 34
    scale = max(float(np.abs(want[k]).max()) for k in named)
    for key, p in named.items():
        # the split priors and the first level's coupling change only the
        # split-off half: no gradient reaches them from the features
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        close(grad, want[key], rtol=0, atol=1e-7 * scale)
    # central differences on the port alone, in float64
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    picks = [("gp.log_lengthscale", 0), ("gp.log_noise", 0),
             ("flow.levels.0.steps.0.actnorm.bias", 1),
             ("flow.levels.0.steps.0.invconv.l", 5),
             ("flow.levels.1.steps.0.coupling.net.conv1.w", 7),
             ("flow.levels.1.steps.0.coupling.net.conv3.w", 11),
             ("flow.levels.1.steps.0.coupling.net.conv3.logs", 2)]
    h = 1e-5
    with torch.no_grad():
        for key, i in picks:
            flat = named[key].view(-1)
            old = float(flat[i])
            flat[i] = old + h
            up = float(port.joint_nlml(xt, yt))
            flat[i] = old - h
            down = float(port.joint_nlml(xt, yt))
            flat[i] = old
            fd = (up - down) / (2 * h)
            grad = float(named[key].grad.view(-1)[i])
            assert abs(fd - grad) < 1e-7 + 1e-5 * abs(fd), (key, fd, grad)


def test_flowgp_fit_frozen_keeps_flow_and_joint_moves_it():
    x = t(_images(batch=16, seed=7))
    y = torch.tanh(x.sum(dim=(1, 2, 3)))
    flow = MarScfFlow(MarScfConfig(**TINY), device="cpu")
    flow.ddi(x)
    gp = GPRegression(GPConfig(ard=False), 96, device="cpu")
    with torch.no_grad():
        gp.init_from_data(FlowGP(flow, gp).feature_fn(x), y)
    before = copy.deepcopy(flow.state_dict())
    frozen = FlowGP(flow, copy.deepcopy(gp))
    losses = frozen.fit(x, y, steps=10, lr=0.05, train_flow=False)
    assert losses[-1] < losses[0]
    for key, value in flow.state_dict().items():
        assert torch.equal(value, before[key]), key
    joint = FlowGP(copy.deepcopy(flow), copy.deepcopy(gp))
    losses_j = joint.fit(x, y, steps=10, lr=0.05, flow_lr=0.005)
    assert losses_j[0] == pytest.approx(losses[0]) and losses_j[-1] < losses[-1]
    delta = max(float((a - before[k]).abs().max())
                for k, a in joint.flow.state_dict().items())
    assert delta > 1e-5
    with torch.no_grad():
        mean, var = joint.posterior(x, y, x[:4])
    assert torch.isfinite(mean).all() and (var > 0).all()


def test_train_gp_cli_on_cpu():
    tab = train_gp.main(["--device", "cpu", "--n_train", "64", "--n_test",
                         "16", "--steps", "20"])
    assert np.isfinite(tab["losses"]).all()
    assert tab["nlml_end"] < tab["nlml_start"] and tab["min_var"] > 0
    out = train_gp.main(["--device", "cpu", "--flow", "--n_train", "32",
                         "--n_test", "8", "--steps", "5", "--image_size", "8",
                         "--flow_C", "8", "--flow_pretrain_steps", "2"])
    assert out["flow_dim"] == 96 and out["raw_dim"] == 192
    assert len(out["pretrain_losses"]) == 2
    for mode in ("raw", "frozen", "joint"):
        r = out[mode]
        assert np.isfinite(r["losses"]).all() and r["min_var"] > 0
        assert r["nlml_end"] < r["nlml_start"] and np.isfinite(r["rmse"])
    assert out["joint"]["nlml_end"] < out["frozen"]["nlml_end"]


def test_gp_entry_points_default_to_cuda(monkeypatch):
    assert inspect.signature(GPRegression).parameters["device"].default == "cuda"
    assert train_gp.parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPRegression(GPConfig(), 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_gp.main(["--flow"])
