"""Port vs JAX package: the MixLogCDF coupling network (concat-ELU,
LayerNorm, GatedConv, positions, GatedAttn, ConvAttnBlock, MixLogCDFNet)
and the coupling's forward and inverse with their log-dets (float32, CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpnf_tpu.ops import mixlogcdf as j_mix
from gpnf_tpu_torch.ops import mixlogcdf
from torch_parity import close, load, normal, rng, t

KEY = jax.random.PRNGKey(0)


def test_concat_elu():
    x = normal(rng(0), (2, 3, 4, 4), 2.0)
    close(mixlogcdf.concat_elu(t(x)), j_mix.concat_elu(jnp.asarray(x)))


def test_layer_norm():
    x = normal(rng(1), (2, 4, 4, 16), 3.0) + 1.0
    j = j_mix.LayerNorm(16)
    p = {"gamma": jnp.asarray(normal(rng(2), (16,))),
         "beta": jnp.asarray(normal(rng(3), (16,)))}
    close(load(mixlogcdf.LayerNorm(16), p)(t(x)), j.apply(p, jnp.asarray(x)))


def test_gated_conv():
    x = normal(rng(4), (2, 8, 6, 6))
    j = j_mix.GatedConv(8)
    p = j.init(KEY)
    close(load(mixlogcdf.GatedConv(8), p)(t(x)), j.apply(p, jnp.asarray(x)))


@pytest.mark.parametrize("channels", [16, 7])
def test_sinusoidal_pos_enc(channels):
    close(mixlogcdf.sinusoidal_pos_enc(20, channels),
          j_mix.sinusoidal_pos_enc(20, channels))


def test_gated_attn():
    x = normal(rng(5), (2, 8, 8, 16))
    j = j_mix.GatedAttn(16)
    p = j.init(KEY)
    close(load(mixlogcdf.GatedAttn(16), p)(t(x)), j.apply(p, jnp.asarray(x)))


@pytest.mark.parametrize("use_attn", [True, False])
def test_conv_attn_block(use_attn):
    x = normal(rng(6), (2, 16, 4, 4))
    j = j_mix.ConvAttnBlock(16, 0.0, use_attn)
    p = j.init(KEY)
    m = load(mixlogcdf.ConvAttnBlock(16, use_attn), p)
    close(m(t(x)), j.apply(p, jnp.asarray(x), mark_ckpt=False))


def test_mixlogcdf_net_outputs():
    x = normal(rng(7), (2, 3, 8, 8))
    j = j_mix.MixLogCDFNet(3, 16, 2, 4, 0.0)
    p = j.init(KEY)
    m = load(mixlogcdf.MixLogCDFNet(3, 16, 2, 4), p)
    for got, want in zip(m(t(x)), j.apply(p, jnp.asarray(x))):
        close(got, want)


@pytest.fixture(scope="module")
def coupling():
    j = j_mix.MixLogCDFCoupling(6, 16, num_blocks=2, num_components=4,
                                drop_prob=0.0)
    p = j.init(KEY)
    return j, p, load(mixlogcdf.MixLogCDFCoupling(6, 16, 2, 4), p)


def test_coupling_forward(coupling):
    j, p, m = coupling
    x = normal(rng(8), (2, 6, 8, 8))
    y, ld = m(t(x), torch.zeros(2))
    y_j, ld_j = j.forward(p, jnp.asarray(x), jnp.zeros((2,)))
    close(y, y_j)
    close(ld, ld_j)


def test_coupling_inverse(coupling):
    j, p, m = coupling
    y = normal(rng(9), (2, 6, 8, 8))
    x, ld = m.inverse(t(y), torch.zeros(2))
    x_j, ld_j = j.inverse(p, jnp.asarray(y), jnp.zeros((2,)))
    close(x, x_j, rtol=0, atol=1e-4)  # through the mixture inverse
    close(ld, ld_j)


def test_coupling_round_trip(coupling):
    _, _, m = coupling
    x = t(normal(rng(10), (2, 6, 8, 8)))
    with torch.no_grad():
        y, ld = m(x, torch.zeros(2))
        x2, ld2 = m.inverse(y, ld)
    close(x2, x, rtol=0, atol=1e-4)
    close(ld2, np.zeros(2), rtol=0, atol=1e-3)
