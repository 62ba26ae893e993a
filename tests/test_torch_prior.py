"""Port vs JAX package: the ConvLSTM (against both the wavefront and the
layer-by-layer scans), the sequence encoder's single step, and the
channel-AR prior's likelihood and eps_std=0 sample (float32, CPU)."""
import jax
import jax.numpy as jnp
import pytest
import torch

from gpnf_tpu.models import prior as j_prior
from gpnf_tpu.ops import convrnn as j_convrnn
from gpnf_tpu_torch.models import prior
from gpnf_tpu_torch.ops import convrnn
from torch_parity import close, load, normal, rng, t

KEY = jax.random.PRNGKey(0)


@pytest.mark.parametrize("layers,k,dilation", [(3, 5, 2), (1, 3, 1)])
def test_conv_lstm_matches_jax(layers, k, dilation):
    x = normal(rng(0), (2, 6, 5, 8, 8))
    j = j_convrnn.ConvRNN("LSTM", 5, 8, k, num_layers=layers, dilation=dilation)
    p = j.init(KEY)
    m = load(convrnn.ConvLSTM(5, 8, k, num_layers=layers, dilation=dilation), p)
    out, states = m(t(x))
    out_wave, (h_w, c_w) = j.apply(p, jnp.asarray(x))  # wavefront when layers > 1
    close(out, out_wave)
    close(torch.stack([s[0] for s in states]), h_w)
    close(torch.stack([s[1] for s in states]), c_w)
    zeros = jnp.zeros((layers, 2, 8, 8, 8))
    out_scan, _ = j.apply(p, jnp.asarray(x), (zeros, zeros))  # per-layer scans
    close(out, out_scan)


def test_encoder_step_matches_jax():
    r = rng(1)
    j = j_prior.ConvSeqEncoder(5, 2, 8, kernel_size=3, num_layers=2)
    p = j.init(KEY)
    m = load(prior.ConvSeqEncoder(5, 2, 8, kernel_size=3, num_layers=2), p)
    x = normal(r, (2, 5, 4, 4))
    states = [(normal(r, (2, 8, 4, 4)), normal(r, (2, 8, 4, 4)))
              for _ in range(2)]
    out, new = m.step(t(x), [(t(h), t(c)) for h, c in states])
    out_j, new_j = j.step(p, jnp.asarray(x),
                          [(jnp.asarray(h), jnp.asarray(c)) for h, c in states])
    close(out, out_j)
    for (h, c), (h_j, c_j) in zip(new, new_j):
        close(h, h_j)
        close(c, c_j)


@pytest.fixture(scope="module")
def priors():
    kw = dict(hidden_size=8, num_layers=3)
    j = j_prior.ChannelPriorMultiScale(3, 16, 16, 2, **kw)
    p = j.init(KEY)
    return j, p, load(prior.ChannelPriorMultiScale(3, 16, 16, 2, **kw), p)


@pytest.mark.parametrize("level", [1, 2])
def test_prior_log_likelihood(priors, level):
    j, p, m = priors
    r = rng(2 + level)
    if level == 1:  # intermediate: z1 conditions z2 (6 channels at 8x8)
        z = (normal(r, (2, 6, 8, 8)), normal(r, (2, 6, 8, 8)))
        got = m.log_likelihood((t(z[0]), t(z[1])), level)
        want = j.log_likelihood(p, tuple(map(jnp.asarray, z)), level)
    else:  # final: 3 * 2^3 = 24 channels at 4x4
        z = normal(r, (2, 24, 4, 4))
        got = m.log_likelihood(t(z), level)
        want = j.log_likelihood(p, jnp.asarray(z), level)
    close(got, want)


@pytest.mark.parametrize("level", [1, 2])
def test_prior_sample_eps_std_zero(priors, level):
    j, p, m = priors
    z1 = normal(rng(7), (2, 6, 8, 8)) if level == 1 else None
    with torch.no_grad():
        got = m.sample(level, z1=None if z1 is None else t(z1), batch=2,
                       eps_std=0.0, device="cpu")
    want = j.sample(p, jax.random.PRNGKey(1), level,
                    z1=None if z1 is None else jnp.asarray(z1), batch=2,
                    eps_std=0.0)
    assert got.shape == want.shape
    close(got, want)


def test_prior_sample_draws_from_generator(priors):
    _, _, m = priors
    draw = lambda seed: m.sample(2, batch=2, eps_std=1.0, device="cpu",
                                 generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        close(draw(3), draw(3), 0, 0)
        assert not torch.equal(draw(3), draw(4))
