"""The mixture kernels' lane groups (csrc/mixture_lanes.cuh) on the CPU.

The kernels spread an element's K components over a group of lanes and sum
over them in one fixed order: each lane over its slots in slot order, then a
shuffle butterfly. `mixture_inverse_plain` must sum in that order (the card
holds the kernel to it bit for bit), so here its sum is held to a numpy
float32 emulation of the lanes, and the plain version, at K that are and are
not multiples of the group, to the JAX package's `mixture_inverse`.
"""
import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpnf_tpu.ops import logistic as j_logistic
from gpnf_tpu.ops.pallas import fused_mixlogcdf as j_fm
from gpnf_tpu.ops.pallas import fused_mixture_inverse as j_fmi
from gpnf_tpu_torch.ops import kernels
from torch_parity import close, normal, rng, t

fmi = importlib.import_module(
    "gpnf_tpu_torch.ops.kernels.fused_mixture_inverse")
fm = importlib.import_module("gpnf_tpu_torch.ops.kernels.fused_mixlogcdf")
HEADER = (Path(__file__).resolve().parents[1] / "gpnf_tpu_torch" / "csrc"
          / "mixture_lanes.cuh").read_text()


def _lanes_sum(terms, group):
    """(B, D) sum over k of (B, K, D) float32 terms as the kernel's lanes
    add: lane j from 0 over k = j, j + group, ... in order, then each
    butterfly offset group / 2, ..., 1 adds lane j ^ offset into lane j.
    Every lane must end with the same bits."""
    bsz, k, d = terms.shape
    lanes = []
    for j in range(group):
        acc = np.zeros((bsz, d), np.float32)
        for kk in range(j, k, group):
            acc = acc + terms[:, kk]
        lanes.append(acc)
    offset = group // 2
    while offset:
        lanes = [lanes[j] + lanes[j ^ offset] for j in range(group)]
        offset //= 2
    for lane in lanes[1:]:
        np.testing.assert_array_equal(lane.view(np.uint32),
                                      lanes[0].view(np.uint32))
    return lanes[0]


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("group", [4, 8, 16])
@pytest.mark.parametrize("k", [32, 48, 50, 100])
def test_plain_sum_is_the_lanes_order_bit_for_bit(k, group):
    terms = np.exp(normal(rng(k + group), (3, k, 40), 2.0))
    want = _lanes_sum(terms, group)
    assert want.dtype == np.float32
    got = fmi._sum_k(torch.from_numpy(terms), group).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if group == fmi.GROUP:  # the default is the kernel's group
        np.testing.assert_array_equal(
            _bits(fmi._sum_k(torch.from_numpy(terms)).numpy()), _bits(want))
    # the order matters: k order (one thread an element) rounds elsewhere
    k_order = fmi._sum_k(torch.from_numpy(terms), 1).numpy()
    np.testing.assert_array_equal(_bits(k_order),
                                  _bits(_lanes_sum(terms, 1)))
    assert (_bits(k_order) != _bits(want)).any()


def _inverse_inputs(k, b=4, d=64, seed=11):
    """Well-conditioned y: the mixture CDF of moderate x, clipped."""
    r = rng(seed)
    pi, mu, s = (normal(r, (b, k, d)), normal(r, (b, k, d), 2.0),
                 normal(r, (b, k, d), 0.4))
    x_true = normal(r, (b, d), 2.0)
    y = np.clip(np.exp(np.asarray(j_logistic.mixture_log_cdf(
        *map(jnp.asarray, (x_true, pi, mu, s))))), 1e-5, 1 - 1e-5)
    return y.astype(np.float32), pi, mu, s


def _flat_inputs(k, b=4, d=64, seed=12):
    """A flat CDF: means 12 apart (scales near 1), and y at the clamps 1e-5
    and 1 - 1e-5 or where the CDF crosses between two components."""
    r = rng(seed)
    pi, s = normal(r, (b, k, d)), normal(r, (b, k, d), 0.3)
    mu = (12.0 * (np.arange(k, dtype=np.float32) - k / 2)[None, :, None]
          + normal(r, (b, k, d), 0.5)).astype(np.float32)
    y = r.uniform(0.02, 0.98, (b, d)).astype(np.float32)
    y[:, 0::4], y[:, 1::4] = 1e-5, 1 - 1e-5
    return y, pi, mu, s


def _check_inverse(y, pi, mu, s, flat=False):
    """The bars of tests/test_torch_kernels.py: x within 1e-4 of the JAX
    package's, and CDF(x) = y within 2e-6. Where the CDF is flat x is
    ill-conditioned: an error of e in log CDF moves x by e CDF / pdf, and
    at y = 1 - 1e-5 a sum of K terms near 1 rounds log CDF by ~1e-7 (half
    an ulp of 1), which moves x by far more than 1e-4 in any order of the
    sum (the k order of one thread an element too). There x is held to
    1e-4 plus 2^-20 (a few roundings of log CDF) times CDF / pdf at the JAX
    package's x; the residual bar, which does not depend on conditioning,
    stays."""
    got = kernels.mixture_inverse_plain(t(y), t(pi), t(mu), t(s))
    want = j_fmi.mixture_inverse(*map(jnp.asarray, (y, pi, mu, s)))
    atol = 1e-4
    if flat:
        theta = [jnp.asarray(a) for a in (pi, mu, s)]
        atol = atol + 2.0 ** -20 * np.exp(np.asarray(
            j_logistic.mixture_log_cdf(want, *theta)
            - j_logistic.mixture_log_pdf(want, *theta)))
        assert atol.max() > 1e-2  # the case is flat where the clamps are
    assert (np.abs(got.numpy() - np.asarray(want)) <= atol).all()
    y_rec = np.exp(np.asarray(j_logistic.mixture_log_cdf(
        jnp.asarray(got.numpy()), *map(jnp.asarray, (pi, mu, s)))))
    close(y_rec, y, rtol=0, atol=2e-6)


@pytest.mark.parametrize("k", [32, 48])
def test_mixture_inverse_plain_matches_jax(k):
    _check_inverse(*_inverse_inputs(k))


@pytest.mark.parametrize("k", [32, 48])
def test_mixture_inverse_plain_matches_jax_where_the_cdf_is_flat(k):
    _check_inverse(*_flat_inputs(k), flat=True)


@pytest.mark.parametrize("k", [48, 100])
def test_mixlogcdf_plain_matches_jax_above_32_components(k):
    r = rng(k)
    args = (normal(r, (4, 64), 0.5), normal(r, (4, 64), 0.1),
            normal(r, (4, 64), 0.1), normal(r, (4, k, 64)),
            normal(r, (4, k, 64)), normal(r, (4, k, 64), 0.3))
    got = kernels.mixlogcdf_plain(*map(t, args))
    for g, w in zip(got, j_fm.mixlogcdf_forward(*map(jnp.asarray, args))):
        close(g, w)


def _header_int(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", HEADER).group(1))


def test_constants_are_the_headers():
    assert fmi.GROUP == _header_int("kGroup")
    assert fmi.MAX_COMPONENTS == fm.MAX_COMPONENTS == _header_int("kMaxK")
    assert fmi.MAX_COMPONENTS >= 128


@pytest.mark.parametrize("name", ["mixture_inverse", "mixlogcdf_forward"])
def test_too_many_components_raise_with_the_limit(name):
    k = fmi.MAX_COMPONENTS + 1
    el = torch.empty(2, 8, device="meta")
    mix = torch.empty(2, k, 8, device="meta")
    with pytest.raises(ValueError, match=f"at most {fmi.MAX_COMPONENTS}"):
        if name == "mixture_inverse":
            kernels.mixture_inverse(el, mix, mix, mix)
        else:
            kernels.mixlogcdf_forward(el, el, el, mix, mix, mix)
