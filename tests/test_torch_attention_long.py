"""The long-sequence attention entry (512 < S <= 2048) of the port against
the JAX package: its plain versions at the kernels' own boundary against the
Pallas `_fwd_kernel_bh` / `_bwd_kernel_bh` in interpret mode, the public
`fused_attention_long` and its gradients against the JAX function and
`jax.vjp`, the same dropout mask as the fused-projection entry, and the
wrapper's checks. The CUDA kernels themselves are held against the plain
versions on the card by tests/test_torch_cuda.py."""
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


def _inputs(s=576, batch=2, c=96, seed=0):
    """seq (B, S, C), w (3C, C) rows [k | v | q], a cotangent (B, S, C)."""
    r = rng(seed)
    return (normal(r, (batch, s, c), 0.5), normal(r, (3 * c, c), 0.1),
            normal(r, (batch, s, c), 0.5))


def _qkv(seq, w):
    return np.einsum("bsc,oc->bso", seq, w).astype(np.float32)


def _pallas_bh(kernel, qkv, g=None):
    """`_run_bh`'s pallas_call on the (b, h) grid, in interpret mode."""
    from jax.experimental import pallas as pl

    q, k, v = j_fa._split_heads(jnp.asarray(qkv), HEADS)
    b, h, s, dh = q.shape
    blk = pl.BlockSpec((1, 1, s, dh), lambda i, j: (i, j, 0, 0))
    seed_spec = pl.BlockSpec(memory_space=None)
    out_shape = jax.ShapeDtypeStruct(q.shape, jnp.float32)
    if g is None:
        return pl.pallas_call(
            functools.partial(kernel, rate=0.0), grid=(b, h),
            in_specs=[seed_spec, blk, blk, blk], out_specs=blk,
            out_shape=out_shape, interpret=True)(SEED, q, k, v)
    g4 = jnp.asarray(g).reshape(b, s, h, dh).transpose(0, 2, 1, 3)
    return pl.pallas_call(
        functools.partial(kernel, rate=0.0), grid=(b, h),
        in_specs=[seed_spec, blk, blk, blk, blk], out_specs=[blk] * 3,
        out_shape=[out_shape] * 3, interpret=True)(SEED, q, k, v, g4)


def _merge(x):
    b, h, s, dh = x.shape
    return np.asarray(x).transpose(0, 2, 1, 3).reshape(b, s, h * dh)


def test_plain_fwd_and_bwd_match_pallas_bh_kernels_interpret():
    """S = 576, Dh = 24, rate 0: out within 1e-5, dqkv within 1e-4."""
    seq, w, g = _inputs()
    qkv = _qkv(seq, w)
    want = _merge(_pallas_bh(j_fa._fwd_kernel_bh, qkv))
    close(kernels.attention_long_plain(t(qkv), HEADS), want, 0, 1e-5)
    dq, dk, dv = _pallas_bh(j_fa._bwd_kernel_bh, qkv, g)
    dh = seq.shape[2] // HEADS
    want = np.concatenate([_merge(dk), _merge(dv), _merge(dq) * dh ** -0.5],
                          axis=-1)
    close(kernels.attention_long_plain_bwd(t(qkv), t(g), HEADS), want, 0,
          1e-4)


@pytest.mark.parametrize("s,batch", [(576, 2), (1024, 1)])
def test_fused_attention_long_and_vjp_match_jax(s, batch):
    seq, w, g = _inputs(s, batch, seed=s)
    out, vjp = jax.vjp(lambda a, b: j_fa.fused_attention_long(
        SEED, a, b, HEADS, 0.0, False), jnp.asarray(seq), jnp.asarray(w))
    want_dseq, want_dw = vjp(jnp.asarray(g))
    seq_t, w_t = t(seq).requires_grad_(), t(w).requires_grad_()
    got = kernels.fused_attention_long(seq_t, w_t, HEADS)
    close(got, out, 1e-4, 1e-5)
    got.backward(t(g))
    close(seq_t.grad, want_dseq, 1e-4, 1e-5)
    close(w_t.grad, want_dw, 1e-4, 1e-5)
    dseq, dw = kernels.fused_attention_long_bwd(t(seq), t(w), t(g), HEADS)
    close(dseq, want_dseq, 1e-4, 1e-5)
    close(dw, want_dw, 1e-4, 1e-5)


def test_long_and_proj_entries_drop_the_same_scores():
    """Rate 0.2, one seed: the two entries' plain paths give the same output
    and gradients, bit for bit, and the mask is in effect."""
    seq, w, g = _inputs(576, 1, seed=3)
    seed = torch.tensor([99], dtype=torch.int32)
    runs = []
    for entry in (kernels.fused_attention_long, kernels.fused_attention_proj):
        seq_t, w_t = t(seq).requires_grad_(), t(w).requires_grad_()
        out = entry(seq_t, w_t, HEADS, 0.2, seed)
        out.backward(t(g))
        runs.append((out.detach(), seq_t.grad, w_t.grad))
    for got, want in zip(*runs):
        close(got, want, 0, 0)
    assert not torch.allclose(runs[0][0], kernels.fused_attention_long(
        t(seq), t(w), HEADS), atol=1e-3)
    # and the explicit backward against autograd of the plain forward
    qkv = t(_qkv(seq, w)).requires_grad_()
    kernels.attention_long_plain(qkv, HEADS, 0.2, seed).backward(t(g))
    close(kernels.attention_long_plain_bwd(qkv.detach(), t(g), HEADS, 0.2,
                                           seed), qkv.grad, 1e-5, 1e-6)


def test_wrappers_take_plain_versions_on_cpu_without_counting():
    seq, w, g = map(t, _inputs(576, 1, seed=4))
    qkv = torch.matmul(seq, w.t())
    seed = torch.tensor([5], dtype=torch.int32)
    kernels.reset_launch_counts()
    close(kernels.attention_long_qkv(qkv, HEADS, 0.2, seed),
          kernels.attention_long_plain(qkv, HEADS, 0.2, seed), 0, 0)
    close(kernels.attention_long_qkv_bwd(qkv, g, HEADS, 0.2, seed),
          kernels.attention_long_plain_bwd(qkv, g, HEADS, 0.2, seed), 0, 0)
    counts = kernels.launch_counts()
    assert counts["fused_attention_long"] == counts[
        "fused_attention_long_bwd"] == 0


@pytest.mark.parametrize("fault,error,match", [
    ("long", ValueError, str(fa.MAX_S_LONG)),
    ("head_width", ValueError, "head width"),
    ("float64", TypeError, "float32"), ("no_seed", ValueError, "seed"),
    ("shape", ValueError, "3C")])
def test_wrapper_checks(fault, error, match):
    """The kernels' own limits are checked before the device: a tensor that
    is not on the CPU (here on the meta device) takes the kernel's path and
    its checks; a missing seed and a bad shape raise on every device."""
    s, c, heads, dtype = 576, 96, HEADS, torch.float32
    if fault == "long":
        s = fa.MAX_S_LONG + 1
    elif fault == "head_width":
        c, heads = 20, 4  # Dh = 5
    elif fault == "float64":
        dtype = torch.float64
    device = "cpu" if fault == "no_seed" else "meta"
    qkv = torch.zeros((1, s, 3 * c + (fault == "shape")), dtype=dtype,
                      device=device)
    rate = 0.2 if fault == "no_seed" else 0.0
    with pytest.raises(error, match=match):
        kernels.attention_long_qkv(qkv, heads, rate)
    if fault != "shape":  # the backward's checks, and the public entry's
        g = torch.zeros((1, s, c), dtype=dtype, device=device)
        with pytest.raises(error, match=match):
            kernels.attention_long_qkv_bwd(qkv, g, heads, rate)
    if fault == "no_seed":
        with pytest.raises(ValueError, match="seed"):
            kernels.fused_attention_long(torch.zeros(1, s, c),
                                         torch.zeros(3 * c, c), heads, rate)
