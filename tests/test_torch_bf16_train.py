"""The port's bf16 training path (MarScfConfig(compute_dtype="bfloat16"),
`bench.py`'s default train step) against the JAX package on the CPU.

- The plain bf16 backwards of the attention entries against the Pallas
  kernels in interpret mode on bf16 operands at rate 0: `_bwd_kernel_proj`
  (the proj entry: dseq and dW) and `_bwd_kernel_bh` with
  `_vjp_bwd_long`'s rounding around it (the long entry: dqkv at the
  kernels' boundary, dseq and dW). The Pallas kernels are compiled with
  XLA's `xla_allow_excess_precision` off: by default XLA on the CPU drops
  a float32 -> bf16 -> float32 round trip and keeps the float32 value, so
  the interpreted kernel would not round where its source rounds (the
  bf16 q of dK, the bf16 dqkv scratch), as the kernel on the TPU does. Bar:
  the largest difference within one bf16 ulp of the largest |want| (2^-8
  to 2^-7 of it) and at most 5% of the elements differ at all. The port
  rounds at the kernels' points; what differs is the order of the float32
  sums, whose last bit flips a rounding now and then (at S 64 none of
  dqkv's 36,864 values differs; at S 576, 0.1-0.9%, and 2.6% of dseq, each
  a sum of 288 of them).
- A tiny bf16 mAR-SCF at dropout 0 against the JAX bf16 model on the same
  weights, images and noise: the loss within half of the JAX package's own
  bf16-vs-float32 gap (the serving tests' bits/dim rule; it is the same
  bits here).
  The gradients are held to the float32 gradient, as JAX's are: the bf16
  backward's roundings are what makes the gap, and JAX's own bf16
  gradients compiled with and without XLA's excess precision differ by a
  median 0.94 of it per tensor, so half the gap cannot separate two bf16
  backwards that round at different points (and on the CPU the JAX model
  differentiates its jnp attention reference, not the Pallas kernels). Bar:
  each tensor's max |port bf16 - JAX float32| at most twice the larger of
  the JAX bf16 model's under the two settings (the port's worst is 1.66
  of it), and the whole gradient's L2 distance from JAX float32 at most
  the JAX bf16 model's (the port's is 0.75 of it).
- The per-tensor gradient bar that the card tests and chip_smoke.py hold
  a bf16 step to (`gpnf_tpu_torch.utils.grad_parity`): a bf16 run on
  moved weights passes it, a zeroed tensor or a flipped scalar fails it.
- The float32 plain backwards keep their bits, and the train CLI takes
  --compute_dtype.
"""
import functools
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpnf_tpu.models.marscf import MarScfConfig as JaxConfig
from gpnf_tpu.models.marscf import MarScfFlow as JaxFlow
from gpnf_tpu.ops.pallas import fused_attention as jfa
from gpnf_tpu_torch import convert, train_marscf
from gpnf_tpu_torch.models.marscf import MarScfConfig, MarScfFlow
from gpnf_tpu_torch.ops import kernels
from gpnf_tpu_torch.utils import grad_parity
from torch_parity import rng

fa = importlib.import_module("gpnf_tpu_torch.ops.kernels.fused_attention")
BF16 = torch.bfloat16
SEED = jnp.zeros((1,), jnp.int32)
HEADS = 4
# no float32 -> bf16 -> float32 round trip removed: the kernels' own rounding
EXACT = {"xla_allow_excess_precision": False}
MAX_DIFFERING = 0.05  # of the elements


def _bf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _torch(a):
    """The bf16 value of a numpy or JAX array as a torch bf16 tensor."""
    return torch.from_numpy(np.array(
        jnp.asarray(a).astype(jnp.float32))).to(BF16)


def _f32(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x).astype(jnp.float32))


def top_ulp(want):
    """One bf16 ulp at the largest |want|."""
    return 2.0 ** (math.floor(math.log2(float(np.abs(want).max()))) - 7)


def _held(got, want):
    """(largest difference, share of differing elements), asserted within
    the module's bar."""
    got, want = _f32(got), _f32(want)
    diff = np.abs(got - want)
    share = float((diff > 0).mean())
    assert diff.max() <= top_ulp(want) and share <= MAX_DIFFERING, (
        float(diff.max()), top_ulp(want), share)
    return float(diff.max()), share


def _exact(fn, *args):
    """fn(*args) jitted with XLA's excess precision off."""
    return jax.jit(fn).lower(*args).compile(compiler_options=EXACT)(*args)


def _inputs(b=2, s=64, c=96, seed=0):
    r = rng(seed)
    return ((r.standard_normal((b, s, c)) * 0.5).astype(np.float32),
            (r.standard_normal((3 * c, c)) * 0.1).astype(np.float32),
            (r.standard_normal((b, s, c)) * 0.5).astype(np.float32))


def _pallas_proj_bwd(seq, w, g):
    """`_run_proj_bwd`'s pallas_call (one batch row a program, dW summed
    across programs) in interpret mode on bf16 operands; dW rounded to w's
    dtype as `_vjp_bwd_proj` rounds it."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    b, s, c = seq.shape
    blk = pl.BlockSpec((1, s, c), lambda i: (i, 0, 0))
    w_spec = pl.BlockSpec((3 * c, c), lambda i: (0, 0))

    def run(seed, seq, w, g):
        dseq, dw = pl.pallas_call(
            functools.partial(jfa._bwd_kernel_proj, rate=0.0, heads=HEADS),
            grid=(b,),
            in_specs=[pl.BlockSpec(memory_space=None), blk, w_spec, blk],
            out_specs=[blk, w_spec],
            out_shape=[jax.ShapeDtypeStruct((b, s, c), jnp.bfloat16),
                       jax.ShapeDtypeStruct((3 * c, c), jnp.float32)],
            scratch_shapes=[pltpu.VMEM((1, s, 3 * c), jnp.bfloat16)],
            interpret=True)(seed, seq, w, g)
        return dseq, dw.astype(w.dtype)

    return _exact(run, SEED, _bf16(seq), _bf16(w), _bf16(g))


def _pallas_long_bwd(seq, w, g):
    """`_vjp_bwd_long` with `_run_bh`'s pallas_call of `_bwd_kernel_bh` in
    interpret mode on bf16 operands: (dqkv, dseq, dW)."""
    from jax.experimental import pallas as pl

    b, s, c = seq.shape
    dh = c // HEADS

    def run(seed, seq, w, g):
        q, k, v = jfa._split_heads(jfa._proj(seq, w), HEADS)
        blk = pl.BlockSpec((1, 1, s, dh), lambda i, j: (i, j, 0, 0))
        g4 = g.reshape(b, s, HEADS, dh).transpose(0, 2, 1, 3)
        dq, dk, dv = pl.pallas_call(
            functools.partial(jfa._bwd_kernel_bh, rate=0.0), grid=(b, HEADS),
            in_specs=[pl.BlockSpec(memory_space=None)] + [blk] * 4,
            out_specs=[blk] * 3,
            out_shape=[jax.ShapeDtypeStruct(q.shape, q.dtype)] * 3,
            interpret=True)(seed, q, k, v, g4)
        merge = lambda t: t.transpose(0, 2, 1, 3).reshape(b, s, c)
        dqkv = jnp.concatenate([merge(dk), merge(dv),
                                merge(dq) * (dh ** -0.5)], axis=-1)
        d32 = dqkv.astype(jnp.float32)
        dseq = jnp.einsum("bso,oc->bsc", d32, w.astype(jnp.float32),
                          preferred_element_type=jnp.float32)
        dw = jnp.einsum("bso,bsc->oc", d32, seq.astype(jnp.float32),
                        preferred_element_type=jnp.float32)
        return dqkv, dseq.astype(seq.dtype), dw.astype(w.dtype)

    return _exact(run, SEED, _bf16(seq), _bf16(w), _bf16(g))


def test_plain_proj_bwd_bf16_matches_pallas_bwd_kernel_proj():
    """B 2, S 64, C 96 (the flagship's Dh 24), rate 0: dseq and dW."""
    seq, w, g = _inputs()
    want_dseq, want_dw = _pallas_proj_bwd(seq, w, g)
    dseq, dw = kernels.attention_proj_plain_bwd(
        _torch(seq), _torch(w), _torch(g), HEADS)
    assert dseq.dtype == dw.dtype == BF16
    _held(dseq, want_dseq)
    _held(dw, want_dw)
    # and through the public entry's autograd on the CPU
    seq_t = _torch(seq).requires_grad_()
    w_t = _torch(w).requires_grad_()
    kernels.fused_attention_proj(seq_t, w_t, HEADS).backward(_torch(g))
    assert torch.equal(seq_t.grad, dseq) and torch.equal(w_t.grad, dw)


@pytest.mark.parametrize("s", [64, 576])
def test_plain_long_bwd_bf16_matches_pallas_bwd_kernel_bh(s):
    """B 2 (1 at S 576), C 96, rate 0: the packed dqkv at the kernels'
    boundary (`attention_long_qkv_bwd`'s plain version), and dseq and dW of
    the long entry (the projection products at S <= 512 the GEMM wrappers'
    plain versions, above plain products)."""
    seq, w, g = _inputs(b=2 if s <= 512 else 1, s=s, seed=s)
    want_dqkv, want_dseq, want_dw = _pallas_long_bwd(seq, w, g)
    qkv = kernels.attention_qkv_gemm(_torch(seq), _torch(w))
    dqkv = kernels.attention_long_qkv_bwd(qkv, _torch(g), HEADS)
    assert dqkv.dtype == BF16
    _held(dqkv, want_dqkv)
    dseq, dw = kernels.fused_attention_long_bwd(_torch(seq), _torch(w),
                                                _torch(g), HEADS)
    assert dseq.dtype == dw.dtype == BF16
    _held(dseq, want_dseq)
    _held(dw, want_dw)


def test_the_two_recipes_differ_only_in_dq():
    """The proj recipe scales dq in float32 and rounds once; the long one
    rounds dq, then scales it in bf16 by the bf16 constant: dK and dV are
    the same bits, and dq differs somewhere (Dh 24's scale is not a power
    of two)."""
    seq, w, g = _inputs(seed=3)
    qkv = fa.qkv_plain(_torch(seq), _torch(w))
    proj = fa.attention_long_plain_bwd(qkv, _torch(g), HEADS,
                                       scale_dq_in_fp32=True)
    long_ = fa.attention_long_plain_bwd(qkv, _torch(g), HEADS)
    assert torch.equal(proj[..., :192], long_[..., :192])
    assert not torch.equal(proj[..., 192:], long_[..., 192:])


@pytest.mark.parametrize("entry", ["proj", "long"])
def test_float32_plain_backwards_keep_their_bits(entry):
    """float32: the formulas of the JAX module's docstring as they were,
    bit for bit, whatever the bf16 recipe's flag says."""
    seq, w, g = (torch.from_numpy(a) for a in _inputs(b=1, s=32, seed=4))
    qkv = torch.matmul(seq, w.t())
    dh = 96 // HEADS
    k, v, q = fa._split_qkv(qkv, HEADS)
    gh = g.reshape(1, 32, HEADS, dh).transpose(1, 2)
    p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)), -1)
    dpd = torch.matmul(gh, v.transpose(-1, -2))
    dv = torch.matmul(p.transpose(-1, -2), gh)
    ds = p * (dpd - torch.sum(dpd * p, dim=-1, keepdim=True))
    want = torch.cat([fa._merge_heads(torch.matmul(ds.transpose(-1, -2), q)),
                      fa._merge_heads(dv),
                      fa._merge_heads(torch.matmul(ds, k) * dh ** -0.5)], -1)
    got = fa.attention_long_plain_bwd(qkv, g, HEADS,
                                      scale_dq_in_fp32=entry == "proj")
    assert torch.equal(got, want)
    if entry == "proj":
        dseq, dw = kernels.attention_proj_plain_bwd(seq, w, g, HEADS)
        assert torch.equal(dseq, torch.matmul(want, w))
        assert torch.equal(dw, torch.einsum("bso,bsc->oc", want, seq))


# -- the tiny model ------------------------------------------------------------
# 8x8x3, L 2, K 1, C 16, 2 blocks, 4 components, dropout 0: GatedAttn at
# C 16 over 4 heads (Dh 4, the proj route, padded to the bf16 width 24 on
# the card) at S 16 and 4
TINY = dict(image_shape=(8, 8, 3), L=2, K=1, hidden_channels=16,
            num_blocks=2, num_components=4, prior_hidden=8, prior_layers=3,
            drop_prob=0.0)
NUM_DIMS = 8 * 8 * 3


@pytest.fixture(scope="module")
def tiny():
    """(float32, bf16, bf16 without excess precision) JAX (loss, grads) and
    the port's bf16 (loss, grads) of one batch of 2."""
    j32 = JaxFlow(JaxConfig(**TINY, remat=False))
    j16 = JaxFlow(JaxConfig(**TINY, remat=False, compute_dtype="bfloat16"))
    params = jax.device_get(j32.init(jax.random.PRNGKey(0)))
    t16 = MarScfFlow(MarScfConfig(**TINY, compute_dtype="bfloat16"),
                     device="cpu")
    convert.load_jax_params(t16, params)
    r = rng(21)
    x = r.random((2, 3, 8, 8), dtype=np.float32) - 0.5
    noise = r.random((2, 3, 8, 8), dtype=np.float32)

    def grads(model, options=None):
        def loss_fn(p):
            logdet = jnp.full((2,), -math.log(256.0) * NUM_DIMS)
            _, obj = model.encode(p, jnp.asarray(x + noise / 256.0), logdet)
            return jnp.mean(-obj / (math.log(2.0) * NUM_DIMS))
        run = jax.jit(jax.value_and_grad(loss_fn)).lower(params).compile(
            compiler_options=options)
        loss, g = run(params)
        return float(loss), convert.jax_to_state_dict(jax.device_get(g))

    t16.train()
    t16.zero_grad()
    loss = torch.mean(t16(torch.from_numpy(x),
                          noise=torch.from_numpy(noise))[1])
    loss.backward()
    got = {name: p.grad.numpy().copy() for name, p in t16.named_parameters()}
    return (grads(j32), grads(j16), grads(j16, EXACT),
            (float(loss.detach()), got))


def test_tiny_bf16_model_loss_matches_jax(tiny):
    (loss32, _), (loss16, _), _, (loss, _) = tiny
    gap = abs(loss16 - loss32)
    assert gap > 0.0
    assert abs(loss - loss16) <= 0.5 * gap, (loss, loss16, loss32)


def test_tiny_bf16_model_every_gradient_matches_jax(tiny):
    """Every parameter's gradient, float32: no further from the JAX float32
    gradient than twice the JAX bf16 model's (the larger of its two XLA
    settings'), and the whole gradient's L2 distance no more than the JAX
    bf16 model's."""
    (_, want32), (_, want16), (_, exact16), (_, got) = tiny
    assert len(got) > 40 and set(got) <= set(want16)
    err = lambda g, name: float(np.abs(g - want32[name]).max())
    worst = {}
    for name, grad in got.items():
        assert grad.dtype == np.float32
        jax_err = max(err(want16[name], name), err(exact16[name], name))
        worst[name] = err(grad, name) / jax_err if jax_err else (
            0.0 if err(grad, name) == 0.0 else np.inf)
    assert max(worst.values()) <= 2.0, sorted(
        worst.items(), key=lambda kv: -kv[1])[:5]
    l2 = lambda grads: math.sqrt(sum(
        float(((grads[name] - want32[name]) ** 2).sum()) for name in got))
    assert l2(got) <= l2(want16), (l2(got), l2(want16))


# -- the per-tensor gradient bar of the card tests and chip_smoke -----------------
def test_grad_parity_pools_only_small_tensors_by_name():
    assert grad_parity.pool_name("levels.2.steps.0.attn2.offset3") == (
        "levels.*.steps.*.attn2.offset3")
    assert grad_parity.pool_name("prior.levels.1.cond.w2") == (
        "prior.levels.*.cond.w2")
    ref32 = {"a.0.s": torch.tensor([1.0]), "a.1.s": torch.tensor([1.0]),
             "a.0.w": torch.ones(12), "a.1.w": torch.ones(12)}
    ref16 = {"a.0.s": torch.tensor([1.1]), "a.1.s": torch.tensor([1.0]),
             "a.0.w": torch.full((12,), 1.1), "a.1.w": torch.ones(12)}
    got = {k: v + 0.2 for k, v in ref16.items()}
    rows = {r[1]: r for r in grad_parity.bf16_grad_parity(got, ref16, ref32,
                                                          k=2.0)}
    # a.1.s borrows a.0.s's noise 0.1; a.1.w, of 12 elements, has none
    assert rows["a.1.s"][3] == pytest.approx(0.1) and rows["a.1.s"][0] <= 1
    assert rows["a.1.w"][3] == 0.0 and rows["a.1.w"][0] > 1


def test_grad_parity_passes_a_moved_bf16_run_and_catches_a_wrong_tensor():
    """The tiny bf16 model on the CPU: a bf16 step on weights moved by
    2^-22 is another valid bf16 run and holds every tensor's bar against
    the reference bf16 step (noise from the float32 step and two more
    moved runs); the same run with one gradient zeroed, or a one-element
    gradient's sign flipped, fails on that tensor alone."""
    x = torch.from_numpy(rng(22).random((2, 3, 8, 8), dtype=np.float32)
                         - 0.5)
    noise = torch.from_numpy(rng(23).random((2, 3, 8, 8), dtype=np.float32))
    base = MarScfFlow(MarScfConfig(**TINY, compute_dtype="bfloat16"),
                      device="cpu", generator=torch.Generator().manual_seed(5))

    def grads(dtype, state):
        net = MarScfFlow(MarScfConfig(**TINY, compute_dtype=dtype),
                         device="cpu")
        net.load_state_dict(state)
        net(x, noise=noise)[1].mean().backward()
        return {k: p.grad.detach().clone() for k, p in net.named_parameters()}

    ref16, ref32 = grads("bfloat16", base.state_dict()), grads(
        "float32", base.state_dict())
    others = [grads("bfloat16", grad_parity.perturbed(base, i))
              for i in (1, 2)]
    got = grads("bfloat16", grad_parity.perturbed(base, 3))
    rows = grad_parity.bf16_grad_parity(got, ref16, ref32, others)
    assert len(rows) == len(ref32) and rows[0][0] <= 1.0, rows[:3]
    scalar = next(k for k, g in ref32.items() if g.numel() == 1
                  and float(g.abs()) > 0)
    big = max(ref32, key=lambda k: ref32[k].numel())
    for name, bad in ((big, torch.zeros_like(got[big])),
                      (scalar, -got[scalar])):
        wrong = dict(got, **{name: bad})
        failed = [r[1] for r in grad_parity.bf16_grad_parity(
            wrong, ref16, ref32, others) if r[0] > 1.0]
        assert failed == [name], (name, failed)


# -- the CLI ----------------------------------------------------------------------
class _Stop(Exception):
    pass


@pytest.mark.parametrize("flag,want", [(None, "float32"),
                                       ("float32", "float32"),
                                       ("bfloat16", "bfloat16")])
def test_train_cli_passes_compute_dtype_to_the_config(monkeypatch, flag,
                                                      want):
    """train_marscf's --compute_dtype (default float32, the JAX CLI's)
    reaches the MarScfConfig that the train loop is given (stopped
    there), and bf16 products sum in float32 on the card."""
    from gpnf_tpu_torch.training import loop

    seen = []

    def train(model_cfg, train_cfg):
        seen.append(model_cfg)
        raise _Stop

    monkeypatch.setattr(loop, "train", train)
    argv = ["--dataset_name", "synthetic", "--L", "1", "--K", "1", "--C",
            "8", "--batch_size", "8", "--device", "cpu"]
    if flag is not None:
        argv += ["--compute_dtype", flag]
    with pytest.raises(_Stop):
        train_marscf.main(argv)
    assert [c.compute_dtype for c in seen] == [want]
    assert seen[0].hidden_channels == 8
    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction


@pytest.mark.parametrize("bad", ["float16", "bf16", "float64"])
def test_train_cli_rejects_other_dtypes(bad):
    with pytest.raises(SystemExit):
        train_marscf.parse_args(["--compute_dtype", bad])
