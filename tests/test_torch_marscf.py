"""Whole-slice parity at a small size: the JAX package's initialised mAR-SCF
(MixLogCDF couplings, invertible attentions, ConvLSTM prior, K-stacked
steps) carried into the port by convert.py, then encode, forward with the
same dequantisation noise, eps_std=0 sampling and ddi compared (float32,
CPU). Also the parameter bridge's forms and errors, and the port's
default device."""
import copy
import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpnf_tpu.models.marscf import MarScfConfig as JaxConfig
from gpnf_tpu.models.marscf import MarScfFlow as JaxFlow
from gpnf_tpu.models.marscf import unstack_params
from gpnf_tpu.training.checkpoints import _flatten
from gpnf_tpu_torch import convert, eval_marscf
from gpnf_tpu_torch.models.marscf import MarScfConfig, MarScfFlow
from torch_parity import close, n, rng, t

SMALL = dict(image_shape=(16, 16, 3), L=2, K=2, hidden_channels=16,
             num_blocks=2, num_components=4, prior_hidden=8, prior_layers=3)
NUM_DIMS = 16 * 16 * 3


@pytest.fixture(scope="module")
def models():
    jm = JaxFlow(JaxConfig(**SMALL))  # scan_steps=True: K-stacked steps
    params = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    # eval mode: the JAX calls below run with train=False (no dropout)
    tm = MarScfFlow(MarScfConfig(**SMALL), device="cpu").eval()
    convert.load_jax_params(tm, params)
    return jm, params, tm


def _images(batch=2, seed=0):
    return (rng(seed).random((batch, 3, 16, 16), dtype=np.float32) - 0.5)


def test_encode_matches_jax(models):
    jm, params, tm = models
    z = _images()
    logdet = np.full((2,), -math.log(256.0) * NUM_DIMS, np.float32)
    zf_j, obj_j = jm.encode(params, jnp.asarray(z), jnp.asarray(logdet))
    with torch.no_grad():
        zf, obj = tm.encode(t(z), t(logdet))
    bpd = lambda o: -n(o) / (math.log(2.0) * NUM_DIMS)
    close(bpd(obj), bpd(obj_j), rtol=0, atol=1e-4)
    close(zf, zf_j, rtol=0, atol=1e-4)


def test_forward_with_jax_noise_matches_jax(models):
    jm, params, tm = models
    x = _images(seed=1)
    key = jax.random.PRNGKey(5)
    _, nll_j = jm.forward(params, jnp.asarray(x), rng=key)
    rng_deq, _ = jax.random.split(key)
    noise = np.asarray(jax.random.uniform(rng_deq, x.shape, jnp.float32))
    with torch.no_grad():
        _, nll = tm(t(x), noise=t(noise))
    close(nll, nll_j, rtol=0, atol=1e-4)


def test_sample_eps_std_zero_matches_jax(models):
    jm, params, tm = models
    want = jm.sample(params, jax.random.PRNGKey(1), batch=2, eps_std=0.0)
    with torch.no_grad():
        got = tm.sample(2, eps_std=0.0)
    assert got.shape == (2, 3, 16, 16)
    close(got, want, rtol=0, atol=1e-3)


def test_ddi_matches_jax(models):
    jm, params, tm = models
    x = _images(batch=4, seed=2)
    key = jax.random.PRNGKey(3)
    want = convert.jax_to_state_dict(
        jax.device_get(jm.ddi(params, jnp.asarray(x), key)))
    noise = np.asarray(jax.random.uniform(key, x.shape, jnp.float32))
    fresh = copy.deepcopy(tm)
    fresh.ddi(t(x), noise=t(noise))
    got = fresh.state_dict()
    for key_ in want:
        if key_.endswith(("actnorm.bias", "actnorm.logs")):
            close(got[key_], want[key_], rtol=1e-5, atol=1e-5)
        else:  # ddi touches nothing else
            close(got[key_], want[key_], 0, 0)
    with torch.no_grad():  # the initialised flow normalises its input
        _, nll = fresh(t(x), noise=t(noise))
    assert np.all(np.isfinite(n(nll))) and float(nll.mean()) < 30.0


def test_attn_heads_and_actnorm_scale_match_jax():
    """A config with both fields off their defaults (L=2, K=1, C=8): the
    JAX model's weights go through convert.py; ddi's actnorm parameters
    within 1e-5 and encode bits/dim after ddi within 1e-4 of the JAX
    model's."""
    fields = dict(SMALL, K=1, hidden_channels=8, attn_heads=2,
                  actnorm_scale=0.5)
    jm = JaxFlow(JaxConfig(**fields))
    params = jax.device_get(jm.init(jax.random.PRNGKey(1)))
    tm = MarScfFlow(MarScfConfig(**fields), device="cpu").eval()
    convert.load_jax_params(tm, params)
    assert tm.levels[0].steps[0].attn1.num_heads == 2
    x = _images(batch=4, seed=5)
    key = jax.random.PRNGKey(6)
    ddi_params = jax.device_get(jm.ddi(params, jnp.asarray(x), key))
    want = convert.jax_to_state_dict(ddi_params)
    noise = np.asarray(jax.random.uniform(key, x.shape, jnp.float32))
    tm.ddi(t(x), noise=t(noise))
    got = tm.state_dict()
    names = [k_ for k_ in want if k_.endswith(("actnorm.bias", "actnorm.logs"))]
    assert names
    for name in names:
        close(got[name], want[name], rtol=1e-5, atol=1e-5)
    z = _images(seed=7)
    logdet = np.full((2,), -math.log(256.0) * NUM_DIMS, np.float32)
    _, obj_j = jm.encode(ddi_params, jnp.asarray(z), jnp.asarray(logdet))
    with torch.no_grad():
        _, obj = tm.encode(t(z), t(logdet))
    bpd = lambda o: -n(o) / (math.log(2.0) * NUM_DIMS)
    close(bpd(obj), bpd(obj_j), rtol=0, atol=1e-4)


def test_levels_round_trip(models):
    _, _, tm = models
    for level, (c, h, w) in zip(tm.levels, tm.level_shapes):
        z = t(rng(4).standard_normal((2, c, h, w)) * 0.5)
        with torch.no_grad():
            y, ld = level(z, torch.zeros(2))
            z2, ld2 = level.inverse(y, ld)
        close(z2, z, rtol=0, atol=1e-3)
        close(ld2, np.zeros(2), rtol=0, atol=1e-2)


def test_convert_accepts_flat_checkpoint_and_step_lists(models):
    _, params, tm = models
    want = tm.state_dict()
    flat = _flatten({"params": params})  # what best.npz holds
    listed = dict(params, levels=[
        {"steps": unstack_params(lvl["steps"], SMALL["K"])}
        for lvl in params["levels"]])
    for form in (flat, listed):
        arrays = convert.jax_to_state_dict(form)
        assert set(arrays) == set(want)
        for key, value in arrays.items():
            close(value, want[key], 0, 0)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_convert_raises_on_mismatch(models, fault):
    _, params, tm = models
    flat = _flatten(params)
    if fault == "missing":
        flat.pop("prior/levels/0/encoder/embed_b")
    elif fault == "extra":
        flat["prior/levels/0/encoder/unused"] = np.zeros(3, np.float32)
    else:
        flat["prior/levels/0/encoder/embed_b"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="stale checkpoint"):
        convert.load_jax_params(copy.deepcopy(tm), flat)


def test_default_device_is_cuda_and_raises_without_a_card(monkeypatch):
    assert inspect.signature(MarScfFlow).parameters["device"].default == "cuda"
    assert eval_marscf.parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MarScfFlow(MarScfConfig(**SMALL))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_marscf.main(["--dataset_name", "synthetic"])
