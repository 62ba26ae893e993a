"""The port's bf16 serving path (MarScfConfig(compute_dtype="bfloat16"))
against the JAX package's bf16 path on the CPU: the same weights through
convert.py, the same numpy inputs from a seed, eval mode.

Bars: GatedAttn and MixLogCDFNet within 2^-7 of the largest magnitude of
each JAX output (a few bf16 roundings of one value); the prior's bf16
log-likelihood and the flow's bits/dim within half of the JAX package's own
bf16-vs-float32 gap on the same inputs (the port rounds where the JAX
package rounds, so it sits well inside the gap that bf16 itself opens).
The float32 path keeps its bits, and parameters stay float32."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpnf_tpu.models.marscf import MarScfConfig as JaxConfig
from gpnf_tpu.models.marscf import MarScfFlow as JaxFlow
from gpnf_tpu.models.prior import ChannelPriorMultiScale as JaxPrior
from gpnf_tpu.ops import mixlogcdf as jmix
from gpnf_tpu.ops.pallas import fused_attention as jfa
from gpnf_tpu_torch import convert
from gpnf_tpu_torch.models.marscf import MarScfConfig, MarScfFlow
from gpnf_tpu_torch.models.prior import ChannelPriorMultiScale
from gpnf_tpu_torch.ops import kernels
from gpnf_tpu_torch.ops import mixlogcdf as tmix
from torch_parity import load, n, rng

BF16_BAR = 2.0 ** -7
# the configuration of the bits/dim check: 8x8x3, L 2, K 1, C 16, 2 blocks,
# 4 components (the ConvLSTM prior at its defaults)
TINY = dict(image_shape=(8, 8, 3), L=2, K=1, hidden_channels=16,
            num_blocks=2, num_components=4)
NUM_DIMS = 8 * 8 * 3


def _bf16_tree(tree):
    """The JAX package's `_cast_params`: every float leaf to bf16."""
    return jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), tree)


def _jnp_bf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _torch_bf16(a):
    """The bf16 value of a numpy array, as the JAX cast rounds it."""
    return torch.from_numpy(np.array(
        _jnp_bf16(a).astype(jnp.float32))).to(torch.bfloat16)


def _f32(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x).astype(jnp.float32))


def _within(got, want, bar):
    got, want = _f32(got), _f32(want)
    err = float(np.max(np.abs(got - want)))
    assert err <= bar * float(np.max(np.abs(want))), (err, bar)


@pytest.mark.parametrize("part", ["gated_attn", "qkv_plain",
                                  "attention_plain"])
def test_gated_attn_bf16_matches_jax(part):
    """GatedAttn under `_cast_params` (C 16, 4 heads, 8x8), and its qkv
    projection's and attention's plain versions on the JAX `_proj` and
    `_reference_qkv` of the same bf16 operands."""
    r = rng(0)
    c, heads = 16, 4
    ja = jmix.GatedAttn(c, heads)
    params = jax.device_get(ja.init(jax.random.PRNGKey(1)))
    ta = tmix.GatedAttn(c, heads)
    load(ta, params)
    x = r.standard_normal((2, 8, 8, c)).astype(np.float32)
    if part == "gated_attn":
        want = jax.jit(ja.apply)(_bf16_tree(params), _jnp_bf16(x))
        with torch.no_grad():
            got = ta(_torch_bf16(x))
        assert got.dtype == torch.bfloat16
        _within(got, want, BF16_BAR)
        return
    seq = r.standard_normal((2, 64, c)).astype(np.float32)
    w = r.standard_normal((3 * c, c)).astype(np.float32) * 0.3
    qkv = jfa._proj(_jnp_bf16(seq), jnp.asarray(w))
    with torch.no_grad():
        got_qkv = kernels.attention_qkv_gemm(_torch_bf16(seq),
                                             _torch_bf16(w))
    if part == "qkv_plain":
        assert got_qkv.dtype == torch.bfloat16
        _within(got_qkv, qkv, BF16_BAR)
        return
    want = jfa._reference_qkv(jnp.zeros((1,), jnp.int32), qkv, heads, 0.0,
                              True)
    got = kernels.attention_long_plain(_torch_bf16(_f32(qkv)), heads)
    assert got.dtype == torch.bfloat16
    _within(got, want, BF16_BAR)


def test_mixlogcdf_net_bf16_matches_jax():
    """(a, b, pi, mu, scales) of a bf16 MixLogCDFNet (C 16, 2 blocks, 4
    components, 8x8), each float32, against the JAX net's."""
    jn = jmix.MixLogCDFNet(6, 16, 2, 4, 0.0, compute_dtype=jnp.bfloat16)
    params = jax.device_get(jn.init(jax.random.PRNGKey(2)))
    tn = tmix.MixLogCDFNet(6, 16, 2, 4, compute_dtype=torch.bfloat16)
    load(tn, params)
    x = rng(3).standard_normal((4, 6, 8, 8)).astype(np.float32)
    want = jax.jit(jn.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        got = tn(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _within(g, w, BF16_BAR)


def _perturbed(tree, r):
    """The prior's zero-initialised biases made non-zero, so that their
    bf16 additions are exercised."""
    def leaf(path, a):
        name = getattr(path[-1], "key", None)
        if name in ("embed_b", "out_b", "b1", "b2"):
            return a + 0.3 * r.standard_normal(a.shape).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope="module")
def priors():
    kw = dict(hidden_size=8, num_layers=3)
    j16 = JaxPrior(3, 8, 8, 2, compute_dtype=jnp.bfloat16, **kw)
    j32 = JaxPrior(3, 8, 8, 2, **kw)
    params = _perturbed(jax.device_get(j32.init(jax.random.PRNGKey(0))),
                        rng(4))
    t16 = ChannelPriorMultiScale(3, 8, 8, 2, compute_dtype=torch.bfloat16,
                                 **kw)
    t32 = ChannelPriorMultiScale(3, 8, 8, 2, **kw)
    load(t16, params)
    load(t32, params)
    return j16, j32, t16, t32, params


@pytest.mark.parametrize("level", [1, 2])
def test_prior_log_likelihood_bf16_matches_jax(priors, level):
    """The bf16 likelihood within half of the JAX bf16-vs-float32 gap."""
    j16, j32, t16, _, params = priors
    r = rng(5 + level)
    if level == 1:
        z = (r.standard_normal((4, 6, 4, 4)).astype(np.float32),
             r.standard_normal((4, 6, 4, 4)).astype(np.float32))
        jz, tz = z, tuple(torch.from_numpy(a) for a in z)
    else:
        z = r.standard_normal((4, 24, 2, 2)).astype(np.float32)
        jz, tz = z, torch.from_numpy(z)
    ll = lambda m: jax.jit(lambda p, z: m.log_likelihood(p, z, level))
    want16 = np.asarray(ll(j16)(params, jz))
    want32 = np.asarray(ll(j32)(params, jz))
    with torch.no_grad():
        got = t16.log_likelihood(tz, level)
    assert got.dtype == torch.float32
    gap = float(np.max(np.abs(want16 - want32)))
    assert gap > 0.0
    assert float(np.max(np.abs(got.numpy() - want16))) <= 0.5 * gap


def test_prior_sampling_stays_float32(priors):
    """Sampling in a bf16 model runs float32 with the float32 weights: at
    eps_std 0 (a fixed draw) the same bits as the float32 prior's, and the
    JAX sample within 1e-5."""
    j16, _, t16, t32, params = priors
    want = np.asarray(j16.sample(params, jax.random.PRNGKey(0), 2, batch=3,
                                 eps_std=0.0))
    with torch.no_grad():
        got = t16.sample(2, batch=3, eps_std=0.0, device="cpu")
        got32 = t32.sample(2, batch=3, eps_std=0.0, device="cpu")
    assert got.dtype == torch.float32 and torch.equal(got, got32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def tiny_models():
    j32 = JaxFlow(JaxConfig(**TINY))
    j16 = JaxFlow(JaxConfig(**TINY, compute_dtype="bfloat16"))
    params = jax.device_get(j32.init(jax.random.PRNGKey(0)))
    t16 = MarScfFlow(MarScfConfig(**TINY, compute_dtype="bfloat16"),
                     device="cpu").eval()
    convert.load_jax_params(t16, params)
    return j32, j16, t16, params


def test_encode_bits_per_dim_bf16_matches_jax(tiny_models):
    """bits/dim of 4 images: |port bf16 - JAX bf16| at most half of
    |JAX bf16 - JAX float32| (the largest over the batch), all three
    computed here on the same weights and inputs."""
    j32, j16, t16, params = tiny_models
    z = rng(6).random((4, 3, 8, 8), dtype=np.float32) - 0.5
    logdet = np.full((4,), -math.log(256.0) * NUM_DIMS, np.float32)
    bpd = lambda obj: -np.asarray(obj) / (math.log(2.0) * NUM_DIMS)
    want32 = bpd(jax.jit(j32.encode)(params, jnp.asarray(z),
                                     jnp.asarray(logdet))[1])
    want16 = bpd(jax.jit(j16.encode)(params, jnp.asarray(z),
                                     jnp.asarray(logdet))[1])
    with torch.no_grad():
        _, obj = t16.encode(torch.from_numpy(z), torch.from_numpy(logdet))
    got = bpd(n(obj))
    gap = float(np.max(np.abs(want16 - want32)))
    assert gap > 0.0
    assert float(np.max(np.abs(got - want16))) <= 0.5 * gap, (got, want16,
                                                              want32)


def test_float32_field_keeps_the_bits():
    """compute_dtype="float32" is the model built without the field."""
    small = dict(TINY, image_shape=(8, 8, 3))
    z = torch.from_numpy(rng(7).random((2, 3, 8, 8), dtype=np.float32) - 0.5)
    out = []
    for cfg in (MarScfConfig(**small),
                MarScfConfig(**small, compute_dtype="float32")):
        model = MarScfFlow(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(3)).eval()
        with torch.no_grad():
            out.append(model.encode(z, torch.zeros(2)))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


def test_convert_round_trips_a_bf16_models_parameters(tiny_models):
    """Parameters are float32 under either dtype: a bf16 model's state
    dict is float32 and goes back to the JAX layout unchanged."""
    _, _, t16, params = tiny_models
    state = t16.state_dict()
    assert all(v.dtype == torch.float32 for v in state.values())
    back = convert.state_dict_to_jax(state)
    want = convert.flatten(params)
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], np.asarray(want[k]))


@pytest.mark.parametrize("bad", ["bf16", "float16", "float64", ""])
def test_config_rejects_other_dtypes(bad):
    with pytest.raises(ValueError, match="compute_dtype"):
        MarScfConfig(compute_dtype=bad)


def test_config_refuses_bf16_with_the_fused_gated_conv():
    """No longer refused: the config builds, and its couplings carry the
    flag in bf16 (every block's GatedConv runs the fused entry on bf16
    data, whose bf16 kernels tests/test_torch_gated_conv_bf16.py holds to
    the Pallas ones)."""
    cfg = MarScfConfig(**TINY, compute_dtype="bfloat16",
                       fused_gated_conv=True)
    assert cfg.torch_compute_dtype == torch.bfloat16 and cfg.fused_gated_conv
    nets = [m for m in MarScfFlow(cfg, device="cpu").modules()
            if isinstance(m, tmix.MixLogCDFNet)]
    assert len(nets) == TINY["L"] * TINY["K"]
    for net in nets:
        assert net.compute_dtype == torch.bfloat16
        assert all(block.fused_gconv for block in net.blocks)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("flag,want", [(None, "float32"),
                                       ("float32", "float32"),
                                       ("bfloat16", "bfloat16")])
def test_eval_cli_passes_compute_dtype_to_the_config(monkeypatch, flag,
                                                     want):
    """eval_marscf's --compute_dtype (default float32, the JAX CLI's)
    reaches MarScfConfig: the model is built from it (stopped there)."""
    from gpnf_tpu_torch import eval_marscf
    from gpnf_tpu_torch.models import marscf

    seen = []

    def build(cfg, **kw):
        seen.append(cfg)
        raise _Stop

    monkeypatch.setattr(marscf, "MarScfFlow", build)
    argv = ["--dataset_name", "synthetic", "--L", "1", "--K", "1", "--C",
            "8", "--batch_size", "8", "--device", "cpu"]
    if flag is not None:
        argv += ["--compute_dtype", flag]
    with pytest.raises(_Stop):
        eval_marscf.main(argv)
    assert [c.compute_dtype for c in seen] == [want]
    assert seen[0].hidden_channels == 8


def test_eval_cli_rejects_other_dtypes():
    from gpnf_tpu_torch import eval_marscf

    with pytest.raises(SystemExit):
        eval_marscf.parse_args(["--compute_dtype", "float16"])
