"""GatedAttn at every width the JAX package runs: the route that picks the
proj entry or the wide route (the long entry, heads zero-padded to a width
the kernels are built for), the port's GatedAttn against the JAX GatedAttn
(which runs `_reference_qkv` on the CPU) at widths the proj entry does not
take, the two routes and the padding dropping the same scores at one seed,
and the CLIs' default model. The CUDA kernels themselves are held against
the plain versions on the card by tests/test_torch_cuda.py."""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import pytest
import torch

from gpnf_tpu.ops import mixlogcdf as j_mix
from gpnf_tpu_torch import convert, eval_marscf, train_marscf
from gpnf_tpu_torch.models.marscf import MarScfFlow
from gpnf_tpu_torch.ops import kernels, mixlogcdf
from torch_parity import close, load, normal, rng, t

fa = importlib.import_module("gpnf_tpu_torch.ops.kernels.fused_attention")

HEADS = 4
KEY = jax.random.PRNGKey(0)


# -- the route -------------------------------------------------------------------
@pytest.mark.parametrize("c,s,entry,width", [
    (96, 16, "proj", 24), (96, 64, "proj", 24), (96, 256, "proj", 24),
    (96, 512, "proj", 24), (96, 1024, "wide", 24),
    (128, 256, "proj", 32), (128, 512, "wide", 32),
    (192, 64, "proj", 48), (192, 256, "wide", 48),
    (8, 16, "wide", 4), (8, 256, "wide", 4), (48, 64, "wide", 16),
    (160, 16, "wide", 48), (256, 16, "wide", 64), (512, 16, "wide", 128),
    (512, 256, "wide", 128), (1024, 64, "wide", 256)])
def test_route_table(c, s, entry, width):
    """The proj entry where its width is one of PROJ_HEAD_DIMS and the
    fused forward kernel the rule was drawn for fit a block's 227 KB
    (`proj_shared_floats`); the wide route elsewhere, at the padded
    width."""
    route = kernels.attention_route(s, c, HEADS)
    assert route == (entry, c // HEADS, width)
    fits = fa.proj_shared_floats(s, c, c // HEADS) <= fa.PROJ_SHARED_FLOATS
    assert (entry == "proj") == (fits and s <= fa.MAX_S
                                 and c // HEADS in fa.PROJ_HEAD_DIMS)


@pytest.mark.parametrize("c,s,match", [
    (2048, 16, "256"), (96, fa.MAX_S_LONG + 1, str(fa.MAX_S_LONG)),
    (90, 16, "multiple")])
def test_route_raises_beyond_the_kernels(c, s, match):
    with pytest.raises(ValueError, match=match):
        kernels.attention_route(s, c, HEADS)


# -- GatedAttn against the JAX GatedAttn ------------------------------------------
def _param_grads(module):
    return {k: p.grad for k, p in module.named_parameters()}


@pytest.mark.parametrize("s", [16, 64])
@pytest.mark.parametrize("c", [8, 48, 160, 512])
def test_gated_attn_matches_jax(c, s):
    """The same weights through convert.py's bridge, batch 2: the output
    and the gradients of x and of every weight (rtol 1e-4, atol 1e-5)."""
    side = int(s ** 0.5)
    r = rng(c + s)
    x, g = normal(r, (2, side, side, c)), normal(r, (2, side, side, c), 0.5)
    j = j_mix.GatedAttn(c)
    params = j.init(KEY)
    out, vjp = jax.vjp(lambda p, a: j.apply(p, a), params, jnp.asarray(x))
    want_dparams, want_dx = vjp(jnp.asarray(g))

    attn = load(mixlogcdf.GatedAttn(c), params)
    assert attn.route(s).entry == "wide"  # none of these widths fits proj
    x_t = t(x).requires_grad_()
    got = attn(x_t)
    close(got, out, 1e-4, 1e-5)
    got.backward(t(g))
    close(x_t.grad, want_dx, 1e-4, 1e-5)
    want = convert.jax_to_state_dict(jax.device_get(want_dparams))
    grads = _param_grads(attn)
    assert set(grads) == set(want)
    for name, grad in grads.items():
        close(grad, want[name], 1e-4, 1e-5)


# -- one seed: the routes and the padding drop the same scores ---------------------
def _inputs(s, c, seed, batch=2):
    r = rng(seed)
    return (t(normal(r, (batch, s, c), 0.5)), t(normal(r, (3 * c, c), 0.1)),
            t(normal(r, (batch, s, c), 0.5)))


def _run(entry, seq, w, g, rate, seed):
    seq, w = seq.clone().requires_grad_(), w.clone().requires_grad_()
    out = entry(seq, w, HEADS, rate, seed)
    out.backward(g)
    return out.detach(), seq.grad, w.grad


@pytest.mark.parametrize("s", [16, 64])
def test_proj_and_wide_routes_agree_bit_for_bit(s):
    """C = 96, rate 0.2, one seed: the proj route and the wide route
    (`fused_attention_long`, forced at a shape the route gives to proj) give
    the same output and gradients, bit for bit, and the mask is in effect."""
    seq, w, g = _inputs(s, 96, seed=s)
    seed = torch.tensor([31 + s], dtype=torch.int32)
    assert kernels.attention_route(s, 96, HEADS).entry == "proj"
    proj = _run(kernels.fused_attention_proj, seq, w, g, 0.2, seed)
    wide = _run(kernels.fused_attention_long, seq, w, g, 0.2, seed)
    for got, want in zip(wide, proj):
        close(got, want, 0, 0)
    assert not torch.allclose(proj[0], kernels.fused_attention_proj(
        seq, w, HEADS), atol=1e-3)


@pytest.mark.parametrize("c", [8, 48, 160])
def test_padded_wide_route_is_the_unpadded_function(c):
    """Rate 0.2, one seed: the wide route's heads zero-padded to the built
    width (q scaled by the true Dh^-1/2) give the plain unpadded function's
    output and gradients: padding changes no score and no keep bit."""
    seq, w, g = _inputs(64, c, seed=c)
    seed = torch.tensor([7], dtype=torch.int32)
    route = kernels.attention_route(64, c, HEADS)
    assert route.kernel_head_dim > route.head_dim
    out = _run(kernels.fused_attention_long, seq, w, g, 0.2, seed)
    close(out[0], kernels.attention_proj_plain(seq, w, HEADS, 0.2, seed),
          1e-5, 1e-6)
    dseq, dw = kernels.attention_proj_plain_bwd(seq, w, g, HEADS, 0.2, seed)
    close(out[1], dseq, 1e-5, 1e-6)
    close(out[2], dw, 1e-5, 1e-6)


def test_wide_route_pads_on_the_cpu_and_calls_the_plain_version(
        monkeypatch):
    """The padding runs for CPU tensors too; only the innermost call, the
    kernel's wrapper, takes the plain version, with the kernel's arguments
    (the padded qkv and the true width's scale), and counts no launch."""
    seq, w, _ = _inputs(16, 48, seed=3)
    seen = []
    inner = kernels.attention_long_plain

    def spy(qkv, num_heads, rate=0.0, seed=None, q_scale=None):
        seen.append((tuple(qkv.shape), q_scale))
        return inner(qkv, num_heads, rate, seed, q_scale)

    kernels.reset_launch_counts()
    monkeypatch.setattr(fa, "attention_long_plain", spy)
    kernels.fused_attention_long(seq, w, HEADS)
    assert seen == [((2, 16, 3 * HEADS * 16), 12 ** -0.5)]
    assert not any(kernels.launch_counts().values())


@pytest.mark.parametrize("s,gemm", [(16, True), (512, True), (576, False)])
def test_wide_route_projection_runs_the_gemm_wrappers_up_to_max_s(
        monkeypatch, s, gemm):
    """At S <= 512 the long entry's projection and dseq / dW go through the
    GEMM kernels' wrappers (the forward's projection, the backward's
    recomputed one, dseq and dW: on the CPU their plain versions, counting
    no launch); above, through torch.matmul as before."""
    seq, w, g = _inputs(s, 8, batch=1, seed=5)
    calls = []
    for name in ("attention_qkv_gemm", "attention_dseq_gemm",
                 "attention_dw_gemm"):
        monkeypatch.setattr(fa, name, lambda *a, _f=getattr(fa, name), **k: (
            calls.append(_f.__name__), _f(*a, **k))[1])
    kernels.reset_launch_counts()
    _run(kernels.fused_attention_long, seq, w, g, 0.2,
         torch.tensor([7], dtype=torch.int32))
    assert calls == (["attention_qkv_gemm", "attention_qkv_gemm",
                      "attention_dseq_gemm", "attention_dw_gemm"]
                     if gemm else [])
    assert not any(kernels.launch_counts().values())


def test_gemm_wrappers_take_plain_versions_on_cpu_and_check_the_device():
    """CPU tensors: torch.matmul / einsum, bit for bit; meta tensors take the
    kernel's path and stop at its device check."""
    seq, w, _ = (t_ for t_ in _inputs(16, 8, batch=2, seed=6))
    dqkv = torch.matmul(seq, w.t())
    close(kernels.attention_qkv_gemm(seq, w), dqkv, 0, 0)
    close(kernels.attention_dseq_gemm(dqkv, w), torch.matmul(dqkv, w), 0, 0)
    close(kernels.attention_dw_gemm(dqkv, seq),
          torch.einsum("bso,bsc->oc", dqkv, seq), 0, 0)
    meta = lambda x: torch.zeros(x.shape, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kernels.attention_qkv_gemm(meta(seq), meta(w))
    with pytest.raises(ValueError, match="do not make a product"):
        kernels.attention_dseq_gemm(meta(seq), meta(w))


def test_route_constants_match_the_cuda_sources():
    """The proj route's rule, kept from the fused forward kernel it was
    drawn for (its kRows, kMaxSharedBytes, head widths and shared-memory
    formula; the kernel itself is gone, replaced by the GEMM and the
    tensor-core forward), pinned at the CLIs', the flagship's and the
    widths tests' shapes: entry ("p" proj, "w" wide) and floats of the
    formula at S = 256, 64, 16 and 1024 for each C (4 heads), so that
    every shape keeps the entry, padding and bits it had. Then
    attention_tiled.cuh's `with_head_dim` widths and attention_gemm.cu's
    tiles, K chunk and large-tile threshold are the sources' own: a change
    to either side fails here."""
    import re
    from pathlib import Path

    csrc = Path(fa.__file__).resolve().parents[2] / "csrc"
    assert not (csrc / "fused_attention_proj.cu").exists()
    assert (fa.PROJ_ROWS, fa.PROJ_SHARED_FLOATS, fa.PROJ_HEAD_DIMS) == (
        32, 232448 // 4, (4, 8, 16, 24, 32, 48, 64))
    table = {8: ("wwww", (1878, 726, 438, 6486)),
             48: ("wwww", (12548, 5636, 3908, 40196)),
             96: ("pppw", (28520, 14696, 11240, 83816)),
             128: ("pppw", (41088, 22656, 18048, 114816)),
             160: ("wwww", (55192, 32152, 26392, 147352)),
             192: ("wppw", (70832, 43184, 36272, 181424)),
             512: ("wwww", (311712, 237984, 219552, 606624))}
    for c, (entries, floats) in table.items():
        for s, entry, n in zip((256, 64, 16, 1024), entries, floats):
            assert fa.proj_shared_floats(s, c, c // HEADS) == n, (c, s)
            assert kernels.attention_route(s, c, HEADS).entry[0] == entry, \
                (c, s)
    gemm = (csrc / "attention_gemm.cu").read_text()
    for name, (bm, bn) in fa.GEMM_TILES.items():
        assert re.search(rf"using {name.capitalize()} = Tile<{bm}, {bn}, ",
                         gemm), name
    assert re.search(r"constexpr int KC = (\d+);", gemm).group(1) == \
        str(fa.GEMM_KC)
    assert re.search(r"constexpr int kLargeMinTiles = (\d+);",
                     gemm).group(1) == str(fa.GEMM_LARGE_MIN_TILES)
    assert '#include "mma_tf32.cuh"' in gemm
    assert "tile_mm.cuh" not in gemm
    tiled = (csrc / "attention_tiled.cuh").read_text()
    switch = re.search(r"with_head_dim\(.*?switch \(head_dim\) \{(.*?)default:",
                       tiled, re.S).group(1)
    assert tuple(map(int, re.findall(r"case (\d+):", switch))) == \
        fa.HEAD_DIMS


# -- the wrappers' checks, before the device ---------------------------------------
@pytest.mark.parametrize("entry,c,s,match", [
    ("proj", 128, 512, "shared memory"), ("proj", 192, 256, "shared memory"),
    ("proj", 512, 16, "head width 128 not in"), ("long", 2048, 16,
                                                 "head width 512 not in")])
def test_kernel_wrappers_refuse_before_the_device(entry, c, s, match):
    """Tensors on the meta device take the kernels' path: the proj entry
    refuses a shape outside its route, naming the wide route; the long
    kernel refuses a head width above 256."""
    seq = torch.zeros((1, s, c), device="meta")
    w = torch.zeros((3 * c, c), device="meta")
    with pytest.raises(ValueError, match=match):
        if entry == "proj":
            kernels.fused_attention_proj(seq, w, HEADS)
        else:
            kernels.attention_long_qkv(torch.zeros((1, s, 3 * c),
                                                   device="meta"), HEADS)


@pytest.mark.parametrize("dh", [128, 256])
def test_long_and_core_wrappers_take_the_lane_split_widths(dh):
    """Dh = 128 and 256 pass every check up to the device (here: meta)."""
    qkv = torch.zeros((1, 64, 3 * HEADS * dh), device="meta")
    q = torch.zeros((1, HEADS, 64, dh), device="meta")
    for call in (lambda: kernels.attention_long_qkv(qkv, HEADS),
                 lambda: kernels.fused_attention_qkv(qkv, HEADS),
                 lambda: kernels.fused_attention(q, q, q)):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            call()


# -- the CLIs' default model -------------------------------------------------------
@pytest.mark.parametrize("cli", [train_marscf, eval_marscf])
def test_cli_default_model_has_a_route_for_every_gated_attn(cli):
    """The CLIs' defaults (--C 512, --coupling mixlogcdf, L 3, 32 px) build
    a model whose every GatedAttn has a route: the wide one at the padded
    width 128. Depth is cut to K = 1 (each step of a level has the same
    GatedAttns); the model is built only, no forward runs."""
    args = cli.parse_args([])
    cfg = train_marscf.model_config(args)
    assert (cfg.hidden_channels, cfg.coupling, cfg.L) == (512, "mixlogcdf", 3)
    model = MarScfFlow(dataclasses.replace(cfg, K=1), device="cpu")
    routes = []
    for level, (_, h, w) in zip(model.levels, model.level_shapes):
        attns = [m for m in level.modules()
                 if isinstance(m, mixlogcdf.GatedAttn)]
        assert len(attns) == cfg.num_blocks
        routes += [attn.route(h * w) for attn in attns]
    assert set(routes) == {("wide", 128, 128)}
