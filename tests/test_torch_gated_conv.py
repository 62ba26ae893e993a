"""The fused GatedConv (`MarScfConfig.fused_gated_conv`) of the port against
the JAX package (float32, CPU): the plain forward and backward against the
Pallas `_fwd_kernel` / `_bwd_kernel` in interpret mode on a 2-program grid
and against the JAX `fused_gated_conv` and `jax.vjp`, the Dropout2d mask,
the fused GatedConv and ConvAttnBlock on converted weights, a small whole
model with the flag (encode, a training step, sampling), and the wrapper's
checks. The CUDA kernels are held against the plain versions on the card
by tests/test_torch_cuda.py."""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpnf_tpu.models.marscf import MarScfConfig as JaxConfig
from gpnf_tpu.models.marscf import MarScfFlow as JaxFlow
from gpnf_tpu.ops import mixlogcdf as j_mix
from gpnf_tpu.ops.pallas import fused_gated_conv as j_fgc
from gpnf_tpu_torch import convert
from gpnf_tpu_torch.models.marscf import MarScfConfig, MarScfFlow
from gpnf_tpu_torch.ops import kernels, mixlogcdf
from torch_parity import close, load, n, normal, rng, t

SEED = jnp.zeros((1,), jnp.int32)
# tests/test_fused_gated_conv.py's whole-model configuration
BASE = dict(image_shape=(8, 8, 3), L=2, K=2, hidden_channels=16,
            coupling="mixlogcdf", num_blocks=2, num_components=4,
            drop_prob=0.0, use_attention=True)
NUM_DIMS = 8 * 8 * 3


def _inputs(c=16, b=4, h=8, w=8, seed=0):
    """x (B, H, W, C), w1 (3, 3, 2C, C), b1, wg (2C, 2C), bg, a cotangent."""
    r = rng(seed)
    return (normal(r, (b, h, w, c)),
            normal(r, (3, 3, 2 * c, c), 1.0 / math.sqrt(18 * c)),
            normal(r, (c,), 0.1), normal(r, (2 * c, 2 * c), 1.0 / math.sqrt(2 * c)),
            normal(r, (2 * c,), 0.1), normal(r, (b, h, w, c)))


def _pallas(kernel, x, w1, b1, wg, bg, g=None, programs=2):
    """`_run`'s pallas_call on a grid of `programs` batch blocks, in
    interpret mode, at rate 0."""
    from jax.experimental import pallas as pl

    b, hh, ww, c = x.shape
    mb = b // programs
    xblk = pl.BlockSpec((mb, hh, ww, c), lambda i: (i, 0, 0, 0))
    w1s = pl.BlockSpec((3, 3, 2 * c, c), lambda i: (0, 0, 0, 0))
    vec_c = pl.BlockSpec((c,), lambda i: (0,))
    wgs = pl.BlockSpec((2 * c, 2 * c), lambda i: (0, 0))
    vec_2c = pl.BlockSpec((2 * c,), lambda i: (0,))
    specs = [pl.BlockSpec(memory_space=None), xblk, w1s, vec_c, wgs, vec_2c]
    args = [SEED] + [jnp.asarray(a) for a in (x, w1, b1, wg, bg)]
    f32 = lambda shape: jax.ShapeDtypeStruct(shape, jnp.float32)
    if g is None:
        return pl.pallas_call(
            functools.partial(kernel, rate=0.0), grid=(programs,),
            in_specs=specs, out_specs=xblk, out_shape=f32(x.shape),
            interpret=True)(*args)
    return pl.pallas_call(
        functools.partial(kernel, rate=0.0), grid=(programs,),
        in_specs=specs + [xblk], out_specs=[xblk, w1s, vec_c, wgs, vec_2c],
        out_shape=[f32(a.shape) for a in (x, w1, b1, wg, bg)],
        interpret=True)(*args, jnp.asarray(g))


def test_plain_forward_matches_jax_and_the_pallas_fwd_kernel_interpret():
    x, w1, b1, wg, bg, _ = _inputs()
    got = kernels.gated_conv_plain(*map(t, (x, w1, b1, wg, bg)))
    args = [jnp.asarray(a) for a in (x, w1, b1, wg, bg)]
    close(got, j_fgc.fused_gated_conv(SEED, *args, 0.0, False))
    close(got, _pallas(j_fgc._fwd_kernel, x, w1, b1, wg, bg))


def test_plain_backward_matches_the_pallas_bwd_kernel_interpret_and_vjp():
    """dx, dw1, db1, dwg, dbg; the 2-program grid sums the weight gradients
    across programs, as the TPU's sequential grid does."""
    x, w1, b1, wg, bg, g = _inputs(seed=1)
    got = kernels.gated_conv_plain_bwd(*map(t, (x, w1, b1, wg, bg, g)))
    want = _pallas(j_fgc._bwd_kernel, x, w1, b1, wg, bg, g)
    for a, b in zip(got, want):
        close(a, b, 1e-4, 1e-5)
    _, vjp = jax.vjp(lambda *a: j_fgc.fused_gated_conv(SEED, *a, 0.0, False),
                     *(jnp.asarray(a) for a in (x, w1, b1, wg, bg)))
    for a, b in zip(got, vjp(jnp.asarray(g))):
        close(a, b, 1e-4, 1e-5)


def test_plain_backward_with_dropout_matches_autograd_of_plain_forward():
    x, w1, b1, wg, bg, g = map(t, _inputs(c=8, seed=2))
    seed = torch.tensor([77], dtype=torch.int32)
    args = [a.clone().requires_grad_() for a in (x, w1, b1, wg, bg)]
    out = kernels.gated_conv_plain(*args, 0.2, seed)
    want = torch.autograd.grad(out, args, g)
    got = kernels.gated_conv_plain_bwd(x, w1, b1, wg, bg, g, 0.2, seed)
    for a, b in zip(got, want):
        close(a, b, 1e-5, 1e-6)
    assert not torch.allclose(out, kernels.gated_conv_plain(
        x, w1, b1, wg, bg), atol=1e-3)


def test_dropout_mask_is_per_channel_a_function_of_the_seed_at_its_rate():
    """One keep per (b, channel), constant over space: the forward at rate
    0.5 is the Pallas `_forward_math` with that mask spread over the
    pixels; the mask is a pure function of the seed, and its keep fraction
    is within 4 sigma of 1 - rate over many draws."""
    x, w1, b1, wg, bg, _ = _inputs(c=8, seed=3)
    b, hh, ww, c = x.shape
    seed = torch.tensor([123], dtype=torch.int32)
    keep = kernels.gated_conv_keep_plain(seed, b, 2 * c, 0.5)
    assert keep.shape == (b, 2 * c) and keep.dtype == torch.bool
    assert torch.equal(keep, kernels.gated_conv_keep_plain(seed, b, 2 * c, 0.5))
    assert not torch.equal(keep, kernels.gated_conv_keep_plain(
        torch.tensor([124], dtype=torch.int32), b, 2 * c, 0.5))
    drop = np.repeat(np.where(n(keep), 2.0, 0.0).astype(np.float32),
                     hh * ww, axis=0)  # (B*S, 2C), rows b-major
    *_, want = j_fgc._forward_math(*(jnp.asarray(a) for a in (
        x, w1, b1, wg, bg)), jnp.asarray(drop))
    close(kernels.gated_conv_plain(*map(t, (x, w1, b1, wg, bg)), 0.5, seed),
          want)
    rate, draws = 0.2, 400
    kept = sum(int(kernels.gated_conv_keep_plain(
        torch.tensor([s], dtype=torch.int32), 8, 32, rate).sum())
        for s in range(draws))
    total = draws * 8 * 32
    sigma = math.sqrt(total * rate * (1 - rate))
    assert abs(kept - total * (1 - rate)) <= 4 * sigma


def _sin_loss_grads_jax(fn, params, x):
    return jax.grad(lambda p, xx: jnp.sum(jnp.sin(fn(p, xx))),
                    argnums=(0, 1))(params, x)


def test_fused_gated_conv_module_matches_jax_apply_fused():
    """Values, and the gradients into x, v, g and b of both WN layers."""
    c = 16
    x = normal(rng(4), (2, 8, 8, c))
    j = j_mix.GatedConv(c)
    p = j.init(jax.random.PRNGKey(0))
    port = load(mixlogcdf.GatedConv(c), p)
    x_t = t(x).requires_grad_()
    out = port.apply_fused(x_t)
    close(out, j.apply_fused(p, jnp.asarray(x)))
    torch.sin(out).sum().backward()
    gp, gx = _sin_loss_grads_jax(lambda pp, xx: j.apply_fused(pp, xx), p,
                                 jnp.asarray(x))
    close(x_t.grad, gx, 1e-4, 1e-5)
    want = convert.jax_to_state_dict(jax.device_get(gp))
    for name, param in port.named_parameters():
        close(param.grad, want[name], 1e-4, 1e-5)


def test_convattnblock_fused_matches_jax_fused_block():
    c = 16
    x = normal(rng(5), (2, 8, 8, c))
    j = j_mix.ConvAttnBlock(c, 0.0, use_attn=True, fused_gconv=True)
    p = j.init(jax.random.PRNGKey(1))
    port = load(mixlogcdf.ConvAttnBlock(c, True, fused_gconv=True), p)
    x_t = t(x).requires_grad_()
    out = port(x_t.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    fn = lambda pp, xx: j.apply(pp, xx, mark_ckpt=False, layout="NHWC")
    close(out, fn(p, jnp.asarray(x)))
    torch.sin(out).sum().backward()
    gp, gx = _sin_loss_grads_jax(fn, p, jnp.asarray(x))
    close(x_t.grad, gx, 1e-4, 1e-5)
    want = convert.jax_to_state_dict(jax.device_get(gp))
    for name, param in port.named_parameters():
        close(param.grad, want[name], 1e-4, 1e-5)


@functools.lru_cache(maxsize=None)
def _models(prior):
    """The JAX model with the flag, its parameters, and the port's fused and
    unfused models on them (the tree loads as it is)."""
    cfg = dict(BASE, prior=prior)
    jm = JaxFlow(JaxConfig(**cfg, fused_gated_conv=True, remat=False))
    params = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    fused = MarScfFlow(MarScfConfig(**cfg, fused_gated_conv=True),
                       device="cpu")
    plain = MarScfFlow(MarScfConfig(**cfg), device="cpu")
    convert.load_jax_params(fused, params)
    convert.load_jax_params(plain, params)
    return jm, params, fused, plain


def _batch(seed=0):
    r = rng(seed)
    return (r.random((4, 3, 8, 8), dtype=np.float32) - 0.5,
            r.random((4, 3, 8, 8), dtype=np.float32))


@pytest.mark.parametrize("prior", ["convlstm", "gaussian"])
def test_fused_model_encode_matches_jax_and_the_unfused_port(prior):
    """Bits/dim within 1e-4 of the JAX fused model; the port's fused and
    unfused models on the same weights within 1e-5 bits/dim; the blocks
    take the fused path."""
    jm, params, fused, plain = _models(prior)
    assert all(blk.fused_gconv for blk in fused.modules()
               if isinstance(blk, mixlogcdf.ConvAttnBlock))
    x, _ = _batch()
    logdet = np.full((4,), -math.log(256.0) * NUM_DIMS, np.float32)
    _, obj_j = jax.jit(jm.encode)(params, jnp.asarray(x), jnp.asarray(logdet))
    bpd = lambda o: -n(o) / (math.log(2.0) * NUM_DIMS)
    with torch.no_grad():
        _, obj = fused.eval().encode(t(x), t(logdet))
        _, obj_plain = plain.eval().encode(t(x), t(logdet))
    close(bpd(obj), bpd(obj_j), rtol=0, atol=1e-4)
    close(bpd(obj), bpd(obj_plain), rtol=0, atol=1e-5)


def test_fused_model_train_step_and_sample_match_jax():
    """Training mode at dropout 0: the loss within 1e-5 and each
    parameter's gradient within 1e-4 of its largest magnitude; eps_std=0
    sampling within 1e-3 (ConvLSTM prior)."""
    jm, params, fused, _ = _models("convlstm")
    x, noise = _batch(1)

    def loss_fn(p):
        logdet = jnp.full((4,), -math.log(256.0) * NUM_DIMS)
        _, obj = jm.encode(p, jnp.asarray(x + noise / 256.0), logdet)
        return jnp.mean(-obj / (math.log(2.0) * NUM_DIMS))

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = convert.jax_to_state_dict(jax.device_get(grads_j))
    fused.train()
    fused.zero_grad()
    loss = torch.mean(fused(t(x), noise=t(noise))[1])
    loss.backward()
    close(loss, loss_j, rtol=0, atol=1e-5)
    for name, p in fused.named_parameters():
        scale = float(np.abs(want[name]).max())
        close(p.grad, want[name], rtol=0, atol=1e-4 * scale + 1e-12)
    sample_j = jax.jit(functools.partial(jm.sample, batch=2, eps_std=0.0))(
        params, jax.random.PRNGKey(1))
    with torch.no_grad():
        got = fused.eval().sample(2, eps_std=0.0)
    close(got, sample_j, rtol=0, atol=1e-3)


def test_jax_tree_of_a_fused_model_loads_and_round_trips():
    """The fixture loaded the JAX fused model's tree as it is; the port's
    tree of it holds the same values, and converts back to the JAX
    layout that loads into the unfused model too."""
    _, params, fused, plain = _models("convlstm")
    want = convert.jax_to_state_dict(params)
    state = fused.state_dict()
    assert set(state) == set(want)
    for k in want:
        np.testing.assert_array_equal(n(state[k]), want[k])
    other = MarScfFlow(plain.cfg, device="cpu",
                       generator=torch.Generator().manual_seed(9))
    convert.load_jax_params(other, convert.state_dict_to_jax(state))
    for k, v in other.state_dict().items():
        assert torch.equal(v, state[k])


def test_wrappers_take_plain_versions_on_cpu_without_counting():
    x, w1, b1, wg, bg, g = map(t, _inputs(c=8, b=2, seed=6))
    seed = torch.tensor([5], dtype=torch.int32)
    kernels.reset_launch_counts()
    close(kernels.fused_gated_conv(x, w1, b1, wg, bg, 0.2, seed),
          kernels.gated_conv_plain(x, w1, b1, wg, bg, 0.2, seed), 0, 0)
    for a, b in zip(kernels.fused_gated_conv_bwd(x, w1, b1, wg, bg, g, 0.2,
                                                 seed),
                    kernels.gated_conv_plain_bwd(x, w1, b1, wg, bg, g, 0.2,
                                                 seed)):
        close(a, b, 0, 0)
    counts = kernels.launch_counts()
    assert counts["fused_gated_conv"] == counts["fused_gated_conv_bwd"] == 0
    # float64 on the CPU takes the plain version too
    out = kernels.fused_gated_conv(*(a.double() for a in (x, w1, b1, wg, bg)))
    assert out.dtype == torch.float64


@pytest.mark.parametrize("fault,error,match", [
    ("width", ValueError, "CUDA tensors only"),
    ("float64", TypeError, "float32"),
    ("seed", ValueError, "seed"), ("w1", ValueError, "w1"),
    ("g", ValueError, "g "), ("not_cuda", ValueError, "CUDA tensors only")])
def test_wrapper_checks(fault, error, match):
    """The kernels' own limits are checked before the device: a tensor that
    is not on the CPU (here on the meta device) takes the kernels' path and
    its checks; a bad seed or shape raises on every device. The kernels
    take every width: C = 12 passes their checks and reaches the device's."""
    c = 12 if fault == "width" else 16
    dtype = torch.float64 if fault == "float64" else torch.float32
    device = "cpu" if fault in ("seed", "w1", "g") else "meta"
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    x, w1, b1, wg, bg = (z(1, 4, 4, c), z(3, 3, 2 * c, c + (fault == "w1")),
                         z(c), z(2 * c, 2 * c), z(2 * c))
    rate, seed = 0.0, None
    if fault == "seed":
        rate, seed = 0.2, torch.zeros((2,), dtype=torch.int32)
    g = z(1, 4, 4, c + (fault == "g"))
    if fault != "g":
        with pytest.raises(error, match=match):
            kernels.fused_gated_conv(x, w1, b1, wg, bg, rate, seed)
    with pytest.raises(error, match=match):
        kernels.fused_gated_conv_bwd(x, w1, b1, wg, bg, g, rate, seed)
