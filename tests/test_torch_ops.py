"""Port vs JAX package: basic bijectors, convs, actnorm, PLU invconv,
invertible attention and the logistic-mixture math (float32, CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpnf_tpu.ops import actnorm as j_actnorm
from gpnf_tpu.ops import attention as j_attention
from gpnf_tpu.ops import basic as j_basic
from gpnf_tpu.ops import conv as j_conv
from gpnf_tpu.ops import convrnn as j_convrnn
from gpnf_tpu.ops import invconv as j_invconv
from gpnf_tpu.ops import logistic as j_logistic
from gpnf_tpu_torch.ops import actnorm, attention, basic, conv, invconv, logistic
from torch_parity import close, load, normal, rng, t

KEY = jax.random.PRNGKey(0)


@pytest.mark.parametrize("factor", [1, 2])
def test_squeeze_unsqueeze(factor):
    x = normal(rng(1), (2, 3, 8, 4))
    y = basic.squeeze2d(t(x), factor)
    close(y, j_basic.squeeze2d(jnp.asarray(x), factor), 0, 0)
    close(basic.unsqueeze2d(y, factor), x, 0, 0)
    sq = basic.Squeeze(factor)
    ld = torch.zeros(2)
    out, ld2 = sq.inverse(*sq.forward(t(x), ld))
    close(out, x, 0, 0)
    close(ld2, ld, 0, 0)


@pytest.mark.parametrize("kind", ["split", "cross"])
def test_split_channels(kind):
    x = normal(rng(2), (2, 6, 4, 4))
    for got, want in zip(basic.split_channels(t(x), kind),
                         j_basic.split_channels(jnp.asarray(x), kind)):
        close(got, want, 0, 0)


def test_tuple_flip_is_its_own_inverse():
    x = normal(rng(3), (2, 6, 4, 4))
    flip = basic.TupleFlip()
    y, _ = flip.forward(t(x), torch.zeros(2))
    close(y, j_basic.TupleFlip().forward({}, jnp.asarray(x), 0.0)[0], 0, 0)
    close(flip.inverse(y, torch.zeros(2))[0], x, 0, 0)


def test_gaussian_diag():
    r = rng(4)
    mean, logs, x = (normal(r, (2, 3, 4, 4)) for _ in range(3))
    close(basic.GaussianDiag.logp(t(mean), t(logs), t(x)),
          j_basic.GaussianDiag.logp(jnp.asarray(mean), jnp.asarray(logs),
                                    jnp.asarray(x)))
    close(basic.GaussianDiag.logp(None, None, t(x)),
          j_basic.GaussianDiag.logp(None, None, jnp.asarray(x)))


@pytest.mark.parametrize("k,dilation,bias", [(3, 1, True), (1, 1, False),
                                             (5, 2, True), (4, 1, True)])
def test_conv2d_same(k, dilation, bias):
    r = rng(5)
    x, w = normal(r, (2, 4, 8, 6)), normal(r, (5, 4, k, k), 0.3)
    b = normal(r, (5,)) if bias else None
    want = j_convrnn._convnd(jnp.asarray(x), jnp.asarray(w),
                             None if b is None else jnp.asarray(b),
                             dilation=dilation)
    got = conv.conv2d(t(x), t(w), None if b is None else t(b),
                      dilation=dilation)
    close(got, want)
    if dilation == 1:  # the "SAME" conv of ops/conv.py
        close(got, j_conv.conv2d(jnp.asarray(x), jnp.asarray(w),
                                 None if b is None else jnp.asarray(b)))


def test_wn_conv_and_dense():
    x = normal(rng(6), (2, 6, 5, 5))
    jc = j_conv.WNConv2d(6, 4, 3)
    pc = jc.init(KEY)
    tc = load(conv.WNConv2d(6, 4, 3), pc)
    close(tc(t(x)), jc.apply(pc, jnp.asarray(x)))
    jd = j_conv.WNDense(6, 10, bias=False)
    pd = jd.init(KEY)
    xd = normal(rng(7), (3, 2, 6))
    close(load(conv.WNDense(6, 10, bias=False), pd)(t(xd)),
          jd.apply(pd, jnp.asarray(xd)))


def test_actnorm_forward_inverse_and_ddi():
    x = normal(rng(8), (4, 6, 4, 8), 2.0) + 1.0
    j = j_actnorm.ActNorm(6)
    p, y_j, ld_j = j.ddi(j.init(KEY), jnp.asarray(x), jnp.zeros((4,)))
    m = actnorm.ActNorm(6)
    y, ld = m.ddi(t(x), torch.zeros(4))
    close(m.bias, p["bias"])
    close(m.logs, p["logs"])
    close(y, y_j)
    close(ld, ld_j)
    x2, ld0 = m.inverse(y, ld)
    close(x2, x)
    close(ld0, np.zeros(4))


def test_invconv_forward_inverse_logdet():
    x = normal(rng(9), (2, 8, 4, 6))  # H != W: the log-det uses H*W
    j = j_invconv.InvConv1x1(8)
    p = j.init(KEY)
    m = load(invconv.InvConv1x1(8), p)
    y, ld = m(t(x), torch.zeros(2))
    y_j, ld_j = j.forward(p, jnp.asarray(x), jnp.zeros((2,)))
    close(y, y_j)
    close(ld, ld_j)
    x2, ld2 = m.inverse(y, ld)
    x2_j, ld2_j = j.inverse(p, y_j, ld_j)
    close(x2, x2_j)
    close(x2, x)
    close(ld2, ld2_j)
    assert not m.p.requires_grad and not m.sign_s.requires_grad
    assert {"p", "sign_s"} <= set(dict(m.named_buffers()))


def test_invconv_init_is_a_plu_rotation():
    m = invconv.InvConv1x1(6, generator=torch.Generator().manual_seed(3))
    _, lower, upper, eye = m._factors()
    w = (m.p @ lower @ upper).detach()
    close(w @ w.t(), eye, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 4, 8, 8), (2, 4, 4, 8), (2, 4, 8, 4)])
@pytest.mark.parametrize("permute", [False, True])
def test_invertible_attention(shape, permute):
    x = normal(rng(10), shape)
    j = j_attention.InvertibleAttention(shape[1], 3)
    p = j.init(KEY)
    m = load(attention.InvertibleAttention(shape[1], 3), p)
    y, ld = m(t(x), torch.zeros(2), permute=permute)
    y_j, ld_j = j.forward(p, jnp.asarray(x), jnp.zeros((2,)), permute=permute)
    close(y, y_j)
    close(ld, ld_j)
    x2, ld2 = m.inverse(y, ld, permute=permute)
    x2_j, ld2_j = j.inverse(p, y_j, ld_j, permute=permute)
    close(x2, x2_j)
    close(ld2, ld2_j)
    close(x2, x, atol=1e-4)


@pytest.mark.parametrize("permute", [False, True])
def test_attention_quadrant_path_equals_patch_path(permute):
    x = t(normal(rng(11), (2, 6, 8, 8)))
    m = attention.InvertibleAttention(6, 3,
                                      generator=torch.Generator().manual_seed(1))
    y_q, ld_q = m(x, torch.zeros(2), permute=permute)
    xi_q, _ = m.inverse(y_q, torch.zeros(2), permute=permute)
    m.use_quad_path = False
    y_p, ld_p = m(x, torch.zeros(2), permute=permute)
    xi_p, _ = m.inverse(y_q, torch.zeros(2), permute=permute)
    close(y_q, y_p)
    close(ld_q, ld_p)
    close(xi_q, xi_p)


def _mixture(r, b=2, k=4, c=3, h=4, w=4):
    return (normal(r, (b, k, c, h, w)), normal(r, (b, k, c, h, w)),
            normal(r, (b, k, c, h, w), 0.3), normal(r, (b, c, h, w)))


@pytest.mark.parametrize("fn", ["mixture_log_pdf", "mixture_log_cdf"])
def test_mixture_log_densities(fn):
    pi, mu, s, x = _mixture(rng(12))
    close(getattr(logistic, fn)(t(x), t(pi), t(mu), t(s)),
          getattr(j_logistic, fn)(*map(jnp.asarray, (x, pi, mu, s))))


@pytest.mark.parametrize("reverse", [False, True])
def test_logit_transform(reverse):
    r = rng(13)
    x = (r.uniform(0.01, 0.99, (2, 3, 4, 4)).astype(np.float32) if not reverse
         else normal(r, (2, 3, 4, 4), 3.0))
    for got, want in zip(logistic.logit_transform(t(x), reverse),
                         j_logistic.logit_transform(jnp.asarray(x), reverse)):
        close(got, want)


def test_safe_log_clamps():
    x = np.array([0.0, 1e-30, 0.5, 2.0], np.float32)
    close(logistic.safe_log(t(x)), j_logistic.safe_log(jnp.asarray(x)))
