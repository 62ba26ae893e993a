"""The proj backward as three stages (the projection recomputed, the
key-tiled attention backward, dseq and dW) and the split-K GEMM under its
products, on the CPU: `gemm_splits` and the split GEMM's plain sums, the
stages through each wrapper's plain version against the JAX
`fused_attention_proj`'s gradients (`jax.grad` on the CPU, as
tests/test_fused_attention.py takes them) and against
`attention_proj_plain_bwd`, and the route's fit now decided by the forward
kernel alone. The CUDA kernels are held against these plain versions on the
card by tests/test_torch_cuda.py."""
import importlib

import jax
import jax.numpy as jnp
import pytest
import torch

from gpnf_tpu.ops.pallas import fused_attention as j_fa
from gpnf_tpu_torch.ops import kernels
from torch_parity import close, normal, rng, t

fa = importlib.import_module("gpnf_tpu_torch.ops.kernels.fused_attention")

HEADS = 4
# (m, n, k) of the GEMMs on the paths: dW, dseq and qkv at the flagship's
# levels (B = 64, C = 96, S = 256 / 64 / 16), the Dh = 48 proj shape (C =
# 192, S = 64), the CLIs' C = 512 (B = 16), and ragged small ones
GEMM_SHAPES = [(288, 96, 16384), (288, 96, 4096), (288, 96, 1024),
               (16384, 96, 288), (4096, 96, 288), (1024, 96, 288),
               (16384, 288, 96), (1024, 288, 96), (576, 192, 4096),
               (1536, 512, 4096), (256, 512, 1536), (4096, 1536, 512),
               (7, 7, 5), (64, 64, 33), (100, 30, 1000)]


# -- the split of K ----------------------------------------------------------------
@pytest.mark.parametrize("m,n,k", GEMM_SHAPES)
def test_gemm_splits_cover_k_in_whole_chunks(m, n, k):
    """The splits cover K exactly, none empty, each a whole number of
    GEMM_KC chunks; one split with large tiles (`gemm_tile`) or where the
    output tiles alone make GEMM_BLOCKS blocks, else enough splits for
    GEMM_BLOCKS blocks or one a chunk; the same shape always gives the
    same split."""
    splits = fa.gemm_splits(m, n, k)
    chunk = fa.gemm_chunk(k, splits)
    assert chunk % fa.GEMM_KC == 0
    assert (splits - 1) * chunk < k <= splits * chunk
    bm, bn = fa.gemm_tile(m, n)
    tiles = -(-m // bm) * -(-n // bn)
    chunks = -(-k // fa.GEMM_KC)
    if tiles >= fa.GEMM_BLOCKS or (bm, bn) == fa.GEMM_TILES["large"]:
        assert splits == 1
    else:
        assert tiles * splits >= fa.GEMM_BLOCKS or splits == chunks
    assert fa.gemm_splits(m, n, k) == splits
    assert fa.GEMM_BLOCKS == 2 * 132


@pytest.mark.parametrize("m,n,k", [(288, 96, 4096), (100, 30, 1000),
                                   (64, 64, 33)])
def test_split_gemm_plain_matches_matmul(m, n, k):
    """The kernel's sum order (each split's K range, then the partials in
    split order) against one torch.matmul, float32, within 1e-5 of the
    largest entry (a sum of up to 4096 products)."""
    r = rng(m + n + k)
    a, b = t(normal(r, (m, k))), t(normal(r, (k, n)))
    splits = fa.gemm_splits(m, n, k)
    assert splits > 1
    got = fa.split_gemm_plain(a, b, splits)
    want = torch.matmul(a.double(), b.double())
    assert float((got.double() - want).abs().max()) <= \
        1e-5 * float(want.abs().max())


# -- the three stages against the JAX package and the plain backward ----------------
def _proj_inputs(s, c, seed, batch=2):
    r = rng(seed)
    return (normal(r, (batch, s, c), 0.5), normal(r, (3 * c, c), 0.1),
            normal(r, (batch, s, c)))


@pytest.mark.parametrize("s", [16, 64])
@pytest.mark.parametrize("c", [96, 192])
def test_proj_bwd_stages_match_jax(c, s):
    """Batch 2, rate 0: the stages through each wrapper's plain version
    give the JAX `fused_attention_proj`'s dseq and dW within rtol 1e-4,
    atol 1e-5, and `attention_proj_plain_bwd`'s bit for bit."""
    seq, w, g = _proj_inputs(s, c, seed=c + s)
    assert kernels.attention_route(s, c, HEADS).entry == "proj"
    seed = jnp.zeros((1,), jnp.int32)
    want = jax.grad(lambda x, ww: jnp.sum(
        j_fa.fused_attention_proj(seed, x, ww, HEADS, 0.0, False)
        * jnp.asarray(g)), argnums=(0, 1))(jnp.asarray(seq), jnp.asarray(w))
    got = fa._proj_bwd_stages(t(seq), t(w), t(g), HEADS, 0.0, None)
    for x, y in zip(got, want):
        close(x, y, 1e-4, 1e-5)
    for x, y in zip(got, kernels.attention_proj_plain_bwd(t(seq), t(w), t(g),
                                                          HEADS)):
        close(x, y, 0, 0)


@pytest.mark.parametrize("s", [16, 64])
def test_proj_bwd_stages_drop_the_plain_backwards_scores(s):
    """Rate 0.2, one seed: the stages regenerate the plain backward's mask
    (bit for bit), and the mask is in effect."""
    seq, w, g = (t(x) for x in _proj_inputs(s, 96, seed=s))
    seed = torch.tensor([77 + s], dtype=torch.int32)
    got = fa._proj_bwd_stages(seq, w, g, HEADS, 0.2, seed)
    want = kernels.attention_proj_plain_bwd(seq, w, g, HEADS, 0.2, seed)
    for x, y in zip(got, want):
        close(x, y, 0, 0)
    assert not torch.allclose(got[1], kernels.attention_proj_plain_bwd(
        seq, w, g, HEADS)[1], atol=1e-3)


def test_proj_bwd_takes_the_stages_off_the_cpu(monkeypatch):
    """A tensor off the CPU (meta here) runs the three stages after the
    proj checks (heads, rate, seed and the forward's statistics, none
    given here, passed on), and the call counts one launch."""
    seq = torch.zeros((2, 16, 96), device="meta")
    w = torch.zeros((288, 96), device="meta")
    calls = []
    monkeypatch.setattr(fa, "_proj_cuda_args", lambda *a, **k: None)
    monkeypatch.setattr(fa, "_proj_bwd_stages",
                        lambda *a: calls.append(a) or ("dseq", "dw"))
    before = kernels.fused_attention_proj_bwd.launches
    assert kernels.fused_attention_proj_bwd(seq, w, seq, HEADS) == ("dseq",
                                                                     "dw")
    assert len(calls) == 1 and calls[0][3:] == (HEADS, 0.0, None, None)
    assert kernels.fused_attention_proj_bwd.launches == before + 1


def test_proj_bwd_refuses_what_the_forward_does_not_hold():
    """Off the CPU the backward keeps the forward's limits: the proj
    kernel's shared memory (the wide route's shapes) and its head widths."""
    for c, s, match in ((192, 256, "shared memory"),
                        (512, 16, "head width 128 not in")):
        seq = torch.zeros((1, s, c), device="meta")
        w = torch.zeros((3 * c, c), device="meta")
        with pytest.raises(ValueError, match=match):
            kernels.fused_attention_proj_bwd(seq, w, seq, HEADS)


# -- the route: the forward alone decides the fit ------------------------------------
@pytest.mark.parametrize("c,s,entry,was", [
    (128, 420, "proj", "proj"), (128, 421, "proj", "wide"),
    (128, 433, "proj", "wide"), (128, 434, "wide", "wide"),
    (192, 164, "proj", "proj"), (192, 165, "proj", "wide"),
    (192, 167, "proj", "wide"), (192, 168, "wide", "wide")])
def test_route_fit_is_the_forward_kernels(c, s, entry, was):
    """The shapes at the edge of the fused proj forward's 227 KB (the rule
    the route keeps): C = 128 at S = 421-433 and C = 192 at S = 165-167
    took the wide route while the old in-kernel backward (3 S floats more)
    decided the fit; the forward's rule decides it. No S of the 32-px
    levels (16, 64, 256) is among them."""
    assert kernels.attention_route(s, c, HEADS).entry == entry
    floats = fa.proj_shared_floats(s, c, c // HEADS)
    assert (floats <= fa.PROJ_SHARED_FLOATS) == (entry == "proj")
    assert (floats + 3 * s <= fa.PROJ_SHARED_FLOATS) == (was == "proj")
