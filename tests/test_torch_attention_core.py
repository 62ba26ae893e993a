"""The core attention entries of the port, `fused_attention` on separate
q, k, v (B, H, S, Dh) and `fused_attention_qkv` on a packed qkv (B, S, 3C),
against the JAX package: the plain versions against the Pallas kernels
(`_fwd_kernel`, `_bwd_kernel`, `_fwd_kernel_qkv`, `_bwd_kernel_qkv`) in
interpret mode, as tests/test_fused_attention.py runs them, and against the
jnp references; autograd through the public entries against jax.grad of
the JAX ones; gradcheck in float64; at rate 0.2 and one seed, the packed
entry against the proj entry and the q, k, v entry against the packed one;
the wrappers' checks. The CUDA kernels are held against the plain versions
on the card by tests/test_torch_cuda.py."""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpnf_tpu.ops.pallas import fused_attention as j_fa
from gpnf_tpu_torch.ops import kernels
from torch_parity import close, normal, rng, t

# the module (the package's name `fused_attention` is the entry point)
fa = importlib.import_module("gpnf_tpu_torch.ops.kernels.fused_attention")
SEED = jnp.zeros((1,), jnp.int32)
HEADS = 4


def _split_inputs(s, b=2, h=HEADS, dh=24, seed=0):
    """q (pre-scaled), k, v and a cotangent, each (B, H, S, Dh)."""
    r = rng(seed)
    shape = (b, h, s, dh)
    return (normal(r, shape, 0.3), normal(r, shape, 0.3), normal(r, shape),
            normal(r, shape, 0.5))


def _packed_inputs(s, b=2, c=96, seed=1):
    """qkv (B, S, 3C) laid out [k | v | q] and a cotangent (B, S, C)."""
    r = rng(seed)
    return normal(r, (b, s, 3 * c), 0.3), normal(r, (b, s, c), 0.5)


def _interpret(kernel, block, out_specs, out_shape, *args):
    """One Pallas kernel on a grid over batch rows (one row a program), in
    interpret mode, with the seed as its first input."""
    from jax.experimental import pallas as pl

    b = args[0].shape[0]
    return pl.pallas_call(
        kernel, grid=(b,),
        in_specs=[pl.BlockSpec(memory_space=None)] + [block(a) for a in args],
        out_specs=out_specs, out_shape=out_shape, interpret=True,
    )(SEED, *map(jnp.asarray, args))


def _row_block(a):
    from jax.experimental import pallas as pl

    return pl.BlockSpec((1, *a.shape[1:]),
                        lambda i: (i,) + (0,) * (a.ndim - 1))


def test_attention_plain_matches_pallas_fwd_kernel_and_reference():
    """B=2, H=4, S=64, Dh=24 at the JAX tests' own bar (1e-5 / 1e-6)."""
    q, k, v, _ = _split_inputs(64)
    want = _interpret(functools.partial(j_fa._fwd_kernel, rate=0.0),
                      _row_block, _row_block(q),
                      jax.ShapeDtypeStruct(q.shape, jnp.float32), q, k, v)
    got = kernels.attention_plain(t(q), t(k), t(v))
    close(got, want, 1e-5, 1e-6)
    close(got, j_fa._reference(SEED, *map(jnp.asarray, (q, k, v)), 0.0,
                               False), 1e-5, 1e-6)


def test_attention_plain_bwd_matches_pallas_bwd_kernel_and_vjp():
    """S=32, rate 0: dq, dk, dv within 1e-4 / 1e-5."""
    q, k, v, g = _split_inputs(32, seed=2)
    out = jax.ShapeDtypeStruct(q.shape, jnp.float32)
    from_kernel = _interpret(functools.partial(j_fa._bwd_kernel, rate=0.0),
                             _row_block, [_row_block(q)] * 3, [out] * 3,
                             q, k, v, g)
    _, vjp = jax.vjp(lambda a, b_, c: j_fa._reference(SEED, a, b_, c, 0.0,
                                                      False),
                     *map(jnp.asarray, (q, k, v)))
    from_vjp = vjp(jnp.asarray(g))
    got = kernels.attention_plain_bwd(t(q), t(k), t(v), t(g))
    for a, b_, c in zip(got, from_kernel, from_vjp):
        close(a, b_, 1e-4, 1e-5)
        close(a, c, 1e-4, 1e-5)


def test_packed_plain_matches_pallas_qkv_kernels_and_reference():
    """The packed entry's plain versions (the long entry's) against
    `_fwd_kernel_qkv` (S=64) and `_bwd_kernel_qkv` (S=32), one batch row a
    program, and against `_reference_qkv` and its vjp."""
    qkv, _ = _packed_inputs(64)
    c3 = qkv.shape[2]
    want = _interpret(
        functools.partial(j_fa._fwd_kernel_qkv, rate=0.0, heads=HEADS),
        _row_block, _row_block(qkv[..., :c3 // 3]),
        jax.ShapeDtypeStruct(qkv[..., :c3 // 3].shape, jnp.float32), qkv)
    got = kernels.attention_long_plain(t(qkv), HEADS)
    close(got, want, 1e-5, 1e-6)
    close(got, j_fa._reference_qkv(SEED, jnp.asarray(qkv), HEADS, 0.0, False),
          1e-5, 1e-6)

    qkv, g = _packed_inputs(32, seed=3)
    want = _interpret(
        functools.partial(j_fa._bwd_kernel_qkv, rate=0.0, heads=HEADS),
        _row_block, _row_block(qkv),
        jax.ShapeDtypeStruct(qkv.shape, jnp.float32), qkv, g)
    _, vjp = jax.vjp(lambda a: j_fa._reference_qkv(SEED, a, HEADS, 0.0, False),
                     jnp.asarray(qkv))
    got = kernels.attention_long_plain_bwd(t(qkv), t(g), HEADS)
    close(got, want, 1e-4, 1e-5)
    close(got, vjp(jnp.asarray(g))[0], 1e-4, 1e-5)


@pytest.mark.parametrize("entry", ["fused_attention", "fused_attention_qkv"])
def test_public_entry_autograd_matches_jax_grad(entry):
    """Values and the gradient of sum(out^2), S=32, rate 0."""
    if entry == "fused_attention":
        q, k, v, _ = _split_inputs(32, seed=4)
        args = (q, k, v)
        j_fn = lambda *a: j_fa.fused_attention(SEED, *a, 0.0, False)
        t_fn = kernels.fused_attention
    else:
        args = (_packed_inputs(32, seed=5)[0],)
        j_fn = lambda a: j_fa.fused_attention_qkv(SEED, a, HEADS, 0.0, False)
        t_fn = lambda a: kernels.fused_attention_qkv(a, HEADS)
    j_args = tuple(map(jnp.asarray, args))
    want = jax.grad(lambda a: jnp.sum(j_fn(*a) ** 2))(j_args)
    leaves = [t(a).requires_grad_() for a in args]
    out = t_fn(*leaves)
    close(out, j_fn(*j_args), 1e-5, 1e-6)
    torch.sum(out ** 2).backward()
    for leaf, w in zip(leaves, want):
        close(leaf.grad, w, 1e-4, 1e-5)


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("entry", ["fused_attention", "fused_attention_qkv"])
def test_gradcheck_float64(entry, rate):
    """B=1, H=2, S=8, Dh=4; at rate 0.2 the mask is a function of the
    seed, so the backward must regenerate the forward's."""
    r = rng(6)
    seed = torch.tensor([17], dtype=torch.int32)
    if entry == "fused_attention":
        args = [torch.from_numpy(r.standard_normal((1, 2, 8, 4)))
                for _ in range(3)]
        fn = lambda q, k, v: kernels.fused_attention(q, k, v, rate, seed)
    else:
        args = [torch.from_numpy(r.standard_normal((1, 8, 24)))]
        fn = lambda qkv: kernels.fused_attention_qkv(qkv, 2, rate, seed)
    assert torch.autograd.gradcheck(
        fn, [a.requires_grad_() for a in args])


def test_qkv_entry_matches_proj_entry_at_one_seed():
    """The port's version of tests/test_fused_attention.py's
    `fused_attention_proj(seq, w) == fused_attention_qkv(seq @ w^T)`, at
    rate 0.2 with one seed: the same output, bit for bit, and the same
    dseq and dW."""
    r = rng(7)
    seq, w = normal(r, (2, 64, 96), 0.5), normal(r, (288, 96), 0.1)
    g = t(normal(r, (2, 64, 96)))
    seed = torch.tensor([99], dtype=torch.int32)
    runs = []
    for proj in (True, False):
        seq_t, w_t = t(seq).requires_grad_(), t(w).requires_grad_()
        out = (kernels.fused_attention_proj(seq_t, w_t, HEADS, 0.2, seed)
               if proj else kernels.fused_attention_qkv(
                   torch.matmul(seq_t, w_t.t()), HEADS, 0.2, seed))
        out.backward(g)
        runs.append((out.detach(), seq_t.grad, w_t.grad))
    close(runs[1][0], runs[0][0], 0, 0)
    close(runs[1][1], runs[0][1], 1e-5, 1e-6)
    close(runs[1][2], runs[0][2], 1e-5, 1e-6)
    assert not torch.allclose(runs[1][0], kernels.fused_attention_qkv(
        torch.matmul(t(seq), t(w).t()), HEADS), atol=1e-3)  # the mask acts


def test_split_entry_matches_packed_entry_at_one_seed():
    """fused_attention on the heads of qkv, q scaled by Dh^-1/2, merged, is
    fused_attention_qkv(qkv) at rate 0.2 and one seed, bit for bit, and so
    is the gradient in qkv."""
    qkv, g = map(t, _packed_inputs(64, seed=8))
    seed = torch.tensor([5], dtype=torch.int32)
    b, s, c3 = qkv.shape
    c, dh = c3 // 3, c3 // 3 // HEADS

    def split_entry(x):
        k, v, q = (p.reshape(b, s, HEADS, dh).transpose(1, 2)
                   for p in x.split(c, dim=-1))
        out = kernels.fused_attention(q * dh ** -0.5, k, v, 0.2, seed)
        return out.transpose(1, 2).reshape(b, s, c)

    runs = []
    for fn in (split_entry,
               lambda x: kernels.fused_attention_qkv(x, HEADS, 0.2, seed)):
        leaf = qkv.clone().requires_grad_()
        out = fn(leaf)
        out.backward(g)
        runs.append((out.detach(), leaf.grad))
    close(runs[0][0], runs[1][0], 0, 0)
    close(runs[0][1], runs[1][1], 0, 0)


def test_wrappers_take_plain_versions_on_cpu_without_counting():
    q, k, v, g = map(t, _split_inputs(16, seed=9))
    qkv, g3 = map(t, _packed_inputs(16, seed=10))
    seed = torch.tensor([3], dtype=torch.int32)
    kernels.reset_launch_counts()
    close(kernels.fused_attention(q, k, v, 0.2, seed),
          kernels.attention_plain(q, k, v, 0.2, seed), 0, 0)
    for a, b_ in zip(kernels.fused_attention_bwd(q, k, v, g, 0.2, seed),
                     kernels.attention_plain_bwd(q, k, v, g, 0.2, seed)):
        close(a, b_, 0, 0)
    close(kernels.fused_attention_qkv(qkv, HEADS, 0.2, seed),
          kernels.attention_long_plain(qkv, HEADS, 0.2, seed), 0, 0)
    close(kernels.fused_attention_qkv_bwd(qkv, g3, HEADS, 0.2, seed),
          kernels.attention_long_plain_bwd(qkv, g3, HEADS, 0.2, seed), 0, 0)
    counts = kernels.launch_counts()
    assert not any(counts[n] for n in (
        "fused_attention", "fused_attention_bwd", "fused_attention_qkv",
        "fused_attention_qkv_bwd"))


@pytest.mark.parametrize("fault,error,match", [
    ("shape", ValueError, "one \\(B, H, S, Dh\\) shape"),
    ("rate", ValueError, "rate"), ("no_seed", ValueError, "seed"),
    ("long", ValueError, str(fa.MAX_S_LONG)),
    ("head_width", ValueError, "head width"),
    ("float64", TypeError, "float32")])
def test_wrapper_checks(fault, error, match):
    """A bad shape, rate or seed raises on every device; the kernels' own
    limits, the long entry's (S <= MAX_S_LONG, a head width up to 256, the
    narrower ones padded), and float32 are checked before the device: a
    tensor off the CPU (here on the meta device) takes the kernel's path
    and its checks."""
    s, dh, dtype, rate = 64, 24, torch.float32, 0.0
    if fault == "long":
        s = fa.MAX_S_LONG + 1
    elif fault == "head_width":
        dh = 260
    elif fault == "float64":
        dtype = torch.float64
    elif fault == "rate":
        rate = 1.0
    elif fault == "no_seed":
        rate = 0.2
    device = "cpu" if fault in ("shape", "rate", "no_seed") else "meta"
    q = torch.zeros((1, HEADS, s, dh), dtype=dtype, device=device)
    k = q[..., :-1] if fault == "shape" else q
    qkv = torch.zeros((1, s, 3 * HEADS * dh + (fault == "shape")),
                      dtype=dtype, device=device)
    g3 = torch.zeros((1, s, HEADS * dh), dtype=dtype, device=device)
    if fault == "shape":
        match_qkv = "3C"
    else:
        match_qkv = match
    for call, m in (
            (lambda: kernels.fused_attention(q, k, q, rate), match),
            (lambda: kernels.fused_attention_bwd(q, k, q, q, rate), match),
            (lambda: kernels.fused_attention_qkv(qkv, HEADS, rate), match_qkv),
            (lambda: kernels.fused_attention_qkv_bwd(qkv, g3, HEADS, rate),
             match_qkv)):
        with pytest.raises(error, match=m):
            call()


def test_packed_bwd_checks_the_cotangent_and_heads():
    qkv, g3 = map(t, _packed_inputs(16, seed=11))
    with pytest.raises(ValueError, match="g \\(2, 16, 95\\)"):
        kernels.fused_attention_qkv_bwd(qkv, g3[..., :95], HEADS)
    with pytest.raises(ValueError, match="multiple of 5 heads"):
        kernels.fused_attention_qkv(qkv, 5)
