"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: without a card each test skips (decided in the fixture, when
the test runs). This file imports neither jax nor the JAX package, so it
also runs where only PyTorch is installed; tests/conftest.py does import
jax, so there it is run without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import importlib

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from gpnf_tpu_torch.models.marscf import MarScfConfig, MarScfFlow
from gpnf_tpu_torch.ops import kernels, logistic
from gpnf_tpu_torch.utils import grad_parity

fa = importlib.import_module("gpnf_tpu_torch.ops.kernels.fused_attention")
ch = importlib.import_module("gpnf_tpu_torch.ops.kernels.cholesky")

SMALL = dict(image_shape=(16, 16, 3), L=2, K=2, hidden_channels=16,
             num_blocks=2, num_components=4, prior_hidden=8, prior_layers=3)
# level 0 of a 48x48 image is S = 24 * 24 = 576: the long attention entry
SMALL_48 = dict(SMALL, image_shape=(48, 48, 3), K=1)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _normal(r, shape, scale=1.0):
    return torch.from_numpy((r.standard_normal(shape) * scale).astype(np.float32))


def _close(got, want, rtol=1e-5, atol=1e-5):
    torch.testing.assert_close(got.cpu(), want.cpu(), rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [256, 64, 16])
def test_attention_kernel_matches_plain_on_card(cuda_device, s):
    r = np.random.default_rng(0)
    seq, w = _normal(r, (2, s, 96), 0.5), _normal(r, (288, 96), 0.1)
    seq, w = seq.to(cuda_device), w.to(cuda_device)
    before = kernels.fused_attention_proj.launches
    _close(kernels.fused_attention_proj(seq, w, 4),
           kernels.attention_proj_plain(seq, w, 4), rtol=0, atol=1e-5)
    assert kernels.fused_attention_proj.launches == before + 1


@pytest.mark.cuda
def test_mixlogcdf_kernel_matches_plain_on_card(cuda_device):
    r = np.random.default_rng(1)
    b, k, d = 8, 32, 384
    args = [t.to(cuda_device) for t in (
        _normal(r, (b, d), 0.5), _normal(r, (b, d), 0.1), _normal(r, (b, d), 0.1),
        _normal(r, (b, k, d)), _normal(r, (b, k, d)), _normal(r, (b, k, d), 0.3))]
    for g, w in zip(kernels.mixlogcdf_forward(*args),
                    kernels.mixlogcdf_plain(*args)):
        _close(g, w)


@pytest.mark.cuda
def test_mixture_inverse_kernel_matches_plain_on_card(cuda_device):
    r = np.random.default_rng(2)
    b, k, d = 8, 32, 128
    pi, mu, s = (_normal(r, (b, k, d)).to(cuda_device),
                 _normal(r, (b, k, d), 2.0).to(cuda_device),
                 _normal(r, (b, k, d), 0.4).to(cuda_device))
    x_true = _normal(r, (b, d), 2.0).to(cuda_device)
    y = torch.exp(logistic.mixture_log_cdf(x_true, pi, mu, s)).clamp(
        1e-5, 1 - 1e-5).contiguous()
    x = kernels.mixture_inverse(y, pi, mu, s)
    # the plain version sums over k in the kernel's order: the same bits
    assert torch.equal(x, kernels.mixture_inverse_plain(y, pi, mu, s))
    _close(torch.exp(logistic.mixture_log_cdf(x, pi, mu, s)), y, rtol=0,
           atol=2e-6)


# (B, K, D) of the mixture kernels: the flagship's three levels at batch 64,
# then K 48 and 100 (above the old kernels' 32), K 50 (not a multiple of the
# lane group: pad slots), and D not a multiple of 4 (4-byte staging copies)
MIX_SHAPES = [(64, 32, 1536), (64, 32, 768), (64, 32, 384), (8, 48, 1536),
              (8, 100, 768), (8, 50, 768), (8, 32, 383), (8, 50, 383)]


def _mixture_inputs(device, b, k, d, flat, seed=7):
    """pi, mu, s (B, K, D) and y (B, D): y the CDF of moderate x, clipped;
    or, `flat`, means 12 apart with y at the clamps 1e-5 and 1 - 1e-5 or
    between two components, where the CDF is flat."""
    r = np.random.default_rng(seed)
    pi, s = _normal(r, (b, k, d)), _normal(r, (b, k, d), 0.3 if flat else 0.4)
    if flat:
        mu = 12.0 * (torch.arange(k, dtype=torch.float32) - k / 2)[:, None] \
            + _normal(r, (b, k, d), 0.5)
        y = torch.from_numpy(r.uniform(0.02, 0.98, (b, d)).astype(np.float32))
        y[:, 0::4], y[:, 1::4] = 1e-5, 1 - 1e-5
    else:
        mu = _normal(r, (b, k, d), 2.0)
        y = torch.exp(logistic.mixture_log_cdf(_normal(r, (b, d), 2.0), pi,
                                               mu, s)).clamp(1e-5, 1 - 1e-5)
    return [a.to(device).contiguous() for a in (y, pi, mu, s)]


@pytest.mark.cuda
@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("shape", MIX_SHAPES)
def test_mixture_inverse_bit_for_bit_at_every_shape_on_card(cuda_device,
                                                            shape, flat):
    y, pi, mu, s = _mixture_inputs(cuda_device, *shape, flat)
    before = kernels.mixture_inverse.launches
    x = kernels.mixture_inverse(y, pi, mu, s)
    assert kernels.mixture_inverse.launches == before + 1
    assert torch.equal(x, kernels.mixture_inverse_plain(y, pi, mu, s))
    assert torch.equal(x, kernels.mixture_inverse(y, pi, mu, s))
    _close(torch.exp(logistic.mixture_log_cdf(x, pi, mu, s)), y, rtol=0,
           atol=2e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MIX_SHAPES)
def test_mixlogcdf_at_every_shape_on_card(cuda_device, shape):
    b, k, d = shape
    r = np.random.default_rng(8)
    args = [t.to(cuda_device) for t in (
        _normal(r, (b, d), 0.5), _normal(r, (b, d), 0.1), _normal(r, (b, d), 0.1),
        _normal(r, (b, k, d)), _normal(r, (b, k, d)), _normal(r, (b, k, d), 0.3))]
    before = kernels.mixlogcdf_forward.launches
    got = kernels.mixlogcdf_forward(*args)
    assert kernels.mixlogcdf_forward.launches == before + 1
    for g, again, w in zip(got, kernels.mixlogcdf_forward(*args),
                           kernels.mixlogcdf_plain(*args)):
        assert torch.equal(g, again)
        _close(g, w)


@pytest.mark.cuda
def test_mixture_kernels_take_shifted_operands_on_card(cuda_device):
    """Operands 4 bytes off a 16-byte boundary: 4-byte staging copies, the
    same bits as aligned copies of the same values."""
    b, k, d = 8, 32, 768

    def shifted(a):
        buf = torch.empty(a.numel() + 1, device=cuda_device)
        out = buf[1:].view(a.shape)
        out.copy_(a)
        assert out.data_ptr() % 16 == 4
        return out

    y, pi, mu, s = _mixture_inputs(cuda_device, b, k, d, False)
    x = kernels.mixture_inverse(y, pi, mu, s)
    assert torch.equal(x, kernels.mixture_inverse(
        y, shifted(pi), shifted(mu), shifted(s)))
    a = torch.zeros_like(y)
    fwd = kernels.mixlogcdf_forward(x, a, a, pi, mu, s)
    for g, w in zip(fwd, kernels.mixlogcdf_forward(
            x, a, a, shifted(pi), shifted(mu), shifted(s))):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_small_model_encode_on_card_matches_cpu(cuda_device):
    cpu = MarScfFlow(MarScfConfig(**SMALL), device="cpu").eval()
    card = MarScfFlow(MarScfConfig(**SMALL), device=cuda_device).eval()
    card.load_state_dict(cpu.state_dict())
    z = torch.from_numpy(
        np.random.default_rng(3).random((2, 3, 16, 16), dtype=np.float32) - 0.5)
    kernels.reset_launch_counts()
    with torch.no_grad():
        zf_card, obj_card = card.encode(z.to(cuda_device),
                                        torch.zeros(2, device=cuda_device))
        zf_cpu, obj_cpu = cpu.encode(z, torch.zeros(2))
    counts = kernels.launch_counts()
    assert counts["fused_attention_proj"] == 2 * 2 * 2  # L * K * num_blocks
    assert counts["mixlogcdf_forward"] == 2 * 2
    _close(obj_card / (np.log(2.0) * 16 * 16 * 3),
           obj_cpu / (np.log(2.0) * 16 * 16 * 3), rtol=0, atol=1e-4)
    _close(zf_card, zf_cpu, rtol=0, atol=1e-4)


def _attention_inputs(device, s, batch=2, c=96, seed=0):
    r = np.random.default_rng(seed)
    return (_normal(r, (batch, s, c), 0.5).to(device),
            _normal(r, (3 * c, c), 0.1).to(device),
            _normal(r, (batch, s, c)).to(device),
            torch.tensor([1234 + s], dtype=torch.int32, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("s", [256, 64, 16])
def test_attention_kernel_with_dropout_matches_plain_on_card(cuda_device, s):
    """The same mask in kernel and plain version: one differing keep bit
    would show as an error of order p * v, far above the 1e-5 bar."""
    seq, w, _, seed = _attention_inputs(cuda_device, s)
    _close(kernels.fused_attention_proj(seq, w, 4, 0.2, seed),
           kernels.attention_proj_plain(seq, w, 4, 0.2, seed), rtol=0,
           atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("s", [512, 256, 64, 16])
def test_attention_bwd_kernel_matches_plain_on_card(cuda_device, s, rate):
    """dseq and dW of the backward kernels (the projection GEMM, the
    key-tiled dq and dK/dV kernels, the dseq and dW GEMMs) against the
    plain backward, up to the top of the proj range (S = 512)."""
    seq, w, g, seed = _attention_inputs(cuda_device, s)
    before = kernels.fused_attention_proj_bwd.launches
    dseq, dw = kernels.fused_attention_proj_bwd(seq, w, g, 4, rate, seed)
    assert kernels.fused_attention_proj_bwd.launches == before + 1
    want_dseq, want_dw = kernels.attention_proj_plain_bwd(seq, w, g, 4, rate,
                                                          seed)
    _close(dseq, want_dseq, rtol=1e-4, atol=1e-5)
    _close(dw, want_dw, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_attention_kernels_repeat_bit_for_bit(cuda_device):
    seq, w, g, seed = _attention_inputs(cuda_device, 256, batch=8)
    outs = [kernels.fused_attention_proj(seq, w, 4, 0.2, seed)
            for _ in range(2)]
    grads = [kernels.fused_attention_proj_bwd(seq, w, g, 4, 0.2, seed)
             for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])  # dW: fixed-order sums


@pytest.mark.cuda
def test_attention_autograd_launches_both_kernels(cuda_device):
    seq, w, g, seed = _attention_inputs(cuda_device, 64)
    seq.requires_grad_()
    w.requires_grad_()
    counts = (kernels.fused_attention_proj.launches,
              kernels.fused_attention_proj_bwd.launches)
    kernels.fused_attention_proj(seq, w, 4, 0.2, seed).backward(g)
    assert (kernels.fused_attention_proj.launches,
            kernels.fused_attention_proj_bwd.launches) == (counts[0] + 1,
                                                           counts[1] + 1)
    want = kernels.attention_proj_plain_bwd(seq.detach(), w.detach(), g, 4,
                                            0.2, seed)
    _close(seq.grad, want[0], rtol=1e-4, atol=1e-5)
    _close(w.grad, want[1], rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_mixlogcdf_backward_on_card_matches_plain_autograd(cuda_device):
    r = np.random.default_rng(4)
    b, k, d = 8, 32, 384
    args = [t.to(cuda_device).requires_grad_() for t in (
        _normal(r, (b, d), 0.5), _normal(r, (b, d), 0.1), _normal(r, (b, d), 0.1),
        _normal(r, (b, k, d)), _normal(r, (b, k, d)), _normal(r, (b, k, d), 0.3))]
    gy, gl = _normal(r, (b, d)).to(cuda_device), _normal(r, (b, d)).to(cuda_device)
    y, ldj = kernels.mixlogcdf_forward(*args)
    got = torch.autograd.grad([y, ldj], args, [gy, gl])
    y, ldj = kernels.mixlogcdf_plain(*args)
    want = torch.autograd.grad([y, ldj], args, [gy, gl])
    for g_, w_ in zip(got, want):
        _close(g_, w_, rtol=1e-4, atol=1e-5)


def _flat_grads(model):
    return torch.cat([p.grad.reshape(-1) for p in model.parameters()])


@pytest.mark.cuda
def test_small_model_train_step_on_card_matches_cpu(cuda_device):
    """Loss and every gradient of one training step at dropout 0 (the same
    weights, images and dequantisation noise), card against CPU."""
    cfg = MarScfConfig(**SMALL, drop_prob=0.0)
    cpu = MarScfFlow(cfg, device="cpu")
    card = MarScfFlow(cfg, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    r = np.random.default_rng(5)
    x = torch.from_numpy(r.random((4, 3, 16, 16), dtype=np.float32) - 0.5)
    noise = torch.from_numpy(r.random((4, 3, 16, 16), dtype=np.float32))
    kernels.reset_launch_counts()
    loss_card = torch.mean(card(x.to(cuda_device),
                                noise=noise.to(cuda_device))[1])
    loss_card.backward()
    counts = kernels.launch_counts()
    loss_cpu = torch.mean(cpu(x, noise=noise)[1])
    loss_cpu.backward()
    assert counts["fused_attention_proj"] == counts[
        "fused_attention_proj_bwd"] == 2 * 2 * 2
    assert counts["mixlogcdf_forward"] == 2 * 2
    _close(loss_card, loss_cpu, rtol=0, atol=1e-4)
    g_card, g_cpu = _flat_grads(card), _flat_grads(cpu)
    assert torch.isfinite(g_card).all()
    scale = float(g_cpu.abs().max())
    _close(g_card, g_cpu, rtol=1e-3, atol=1e-4 * scale)


# -- the long-sequence attention (512 < S <= 2048) ----------------------------------
def _qkv_inputs(device, s, batch=2, c=96, seed=0):
    """qkv (B, S, 3C) as the projection gives it, a cotangent and a seed."""
    seq, w, g, seed_t = _attention_inputs(device, s, batch, c, seed)
    return torch.matmul(seq, w.t()), g, seed_t


def _rel_max(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("s", [576, 1024, 2048])
def test_long_attention_kernel_matches_plain_on_card(cuda_device, s, rate):
    """One seed for kernel and plain version: the same mask, so a single
    differing keep bit shows as an error far above the 1e-5 bar."""
    qkv, _, seed = _qkv_inputs(cuda_device, s)
    before = kernels.fused_attention_long.launches
    out = kernels.attention_long_qkv(qkv, 4, rate, seed)
    assert kernels.fused_attention_long.launches == before + 1
    _close(out, kernels.attention_long_plain(qkv, 4, rate, seed), rtol=0,
           atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("s", [576, 1024, 2048])
def test_long_attention_bwd_kernel_matches_plain_on_card(cuda_device, s,
                                                         rate):
    """dqkv within 1e-4 of its largest magnitude."""
    qkv, g, seed = _qkv_inputs(cuda_device, s)
    before = kernels.fused_attention_long_bwd.launches
    dqkv = kernels.attention_long_qkv_bwd(qkv, g, 4, rate, seed)
    assert kernels.fused_attention_long_bwd.launches == before + 1
    want = kernels.attention_long_plain_bwd(qkv, g, 4, rate, seed)
    assert torch.isfinite(dqkv).all()
    assert _rel_max(dqkv, want) <= 1e-4


@pytest.mark.cuda
def test_long_attention_bwd_repeats_bit_for_bit(cuda_device):
    qkv, g, seed = _qkv_inputs(cuda_device, 1024, batch=4)
    first = kernels.attention_long_qkv_bwd(qkv, g, 4, 0.2, seed)
    assert torch.equal(first, kernels.attention_long_qkv_bwd(qkv, g, 4, 0.2,
                                                             seed))


@pytest.mark.cuda
def test_long_attention_autograd_launches_both_kernels(cuda_device):
    seq, w, g, seed = _attention_inputs(cuda_device, 576)
    seq.requires_grad_()
    w.requires_grad_()
    counts = (kernels.fused_attention_long.launches,
              kernels.fused_attention_long_bwd.launches)
    kernels.fused_attention_long(seq, w, 4, 0.2, seed).backward(g)
    assert (kernels.fused_attention_long.launches,
            kernels.fused_attention_long_bwd.launches) == (counts[0] + 1,
                                                           counts[1] + 1)
    want = kernels.attention_proj_plain_bwd(seq.detach(), w.detach(), g, 4,
                                            0.2, seed)
    _close(seq.grad, want[0], rtol=1e-4, atol=1e-5)
    _close(w.grad, want[1], rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_long_attention_rejects_what_the_kernels_do_not_take(cuda_device):
    # S past the kernels' int indices, on the meta device (checked first)
    too_long = torch.zeros((1, fa.MAX_S_LONG + 1, 288), device="meta")
    with pytest.raises(ValueError, match=str(fa.MAX_S_LONG)):
        kernels.attention_long_qkv(too_long, 4)
    with pytest.raises(ValueError, match=str(fa.MAX_S_LONG)):
        kernels.attention_long_qkv_bwd(too_long, too_long[..., :96], 4)
    qkv, g, _ = _qkv_inputs(cuda_device, 576, batch=1)
    with pytest.raises(TypeError, match="float32"):
        kernels.attention_long_qkv(qkv.double(), 4)
    with pytest.raises(ValueError, match="head width"):
        kernels.attention_long_qkv(qkv, 8)  # Dh = 96 / 8 = 12
    # a strided cotangent is no refusal: the wrapper copies it contiguous
    # (aligned) for the kernels, with the contiguous call's bits
    strided = torch.zeros((1, 576, 192), device=cuda_device)[..., ::2]
    strided.copy_(g)
    assert torch.equal(kernels.attention_long_qkv_bwd(qkv, strided, 4),
                       kernels.attention_long_qkv_bwd(qkv, g, 4))


@pytest.mark.cuda
def test_small_48px_model_on_card_matches_cpu(cuda_device):
    """Encode (eval mode) and one training step at dropout 0, card against
    CPU: bits/dim within 1e-4, the loss within 1e-4 and every gradient
    within 1e-3 of the largest; level 0 launches the long kernels."""
    cfg = MarScfConfig(**SMALL_48, drop_prob=0.0)
    cpu = MarScfFlow(cfg, device="cpu")
    card = MarScfFlow(cfg, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    r = np.random.default_rng(6)
    x = torch.from_numpy(r.random((2, 3, 48, 48), dtype=np.float32) - 0.5)
    noise = torch.from_numpy(r.random((2, 3, 48, 48), dtype=np.float32))
    scale = np.log(2.0) * 48 * 48 * 3
    kernels.reset_launch_counts()
    with torch.no_grad():
        _, obj_card = card.eval().encode(x.to(cuda_device),
                                         torch.zeros(2, device=cuda_device))
        _, obj_cpu = cpu.eval().encode(x, torch.zeros(2))
    _close(obj_card / scale, obj_cpu / scale, rtol=0, atol=1e-4)
    kernels.reset_launch_counts()
    loss_card = torch.mean(card.train()(x.to(cuda_device),
                                        noise=noise.to(cuda_device))[1])
    loss_card.backward()
    counts = kernels.launch_counts()
    loss_cpu = torch.mean(cpu.train()(x, noise=noise)[1])
    loss_cpu.backward()
    # level 0 (S = 576): K * num_blocks long calls; level 1 (S = 144): proj,
    # whose forward and backward run the long entry's key-tiled kernels too
    assert counts["fused_attention_long"] == 2 + 2
    assert counts["fused_attention_long_bwd"] == 2 + 2
    assert counts["fused_attention_proj"] == counts[
        "fused_attention_proj_bwd"] == 2
    _close(loss_card, loss_cpu, rtol=0, atol=1e-4)
    g_card, g_cpu = _flat_grads(card), _flat_grads(cpu)
    assert torch.isfinite(g_card).all()
    assert _rel_max(g_card.cpu(), g_cpu) <= 1e-3


# -- the GP head's kernels: Cholesky, triangular solve, affine coupling ----------
def _spd(n, dtype, seed=0):
    """X X^T / n + I: eigenvalues in [1, 5], well conditioned."""
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal((n, n)))
    return (x @ x.T / n + torch.eye(n, dtype=torch.float64)).to(dtype)


def _rel(got, want):
    return float((got.cpu().double() - want.cpu().double()).abs().max()
                 / want.cpu().double().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bar", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 129, 200, 1000, 1024, 2048])
def test_cholesky_kernel_matches_plain_on_card(cuda_device, n, dtype, bar):
    """Against the plain version on the card, relative to max |L|, and by
    the residual max |L L^T - A| / max |A| (both bars: 1e-5 in float32,
    1e-12 in float64); the upper triangle is exactly zero. The sizes are the
    edges of the 16- and 64-wide blocking and of the diagonal step that
    runs inside the trailing launch (65, 129: one row past a tile)."""
    a = _spd(n, dtype).to(cuda_device)
    before = kernels.cholesky.launches
    l = kernels.cholesky(a)
    assert kernels.cholesky.launches == before + 1
    assert _rel(l, kernels.cholesky_plain(a)) <= bar
    assert _rel(l @ l.T, a) <= bar
    assert int(torch.count_nonzero(torch.triu(l, 1))) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,row", [(300, 150), (300, 0), (300, 64),
                                   (300, 128), (200, 195)])
def test_cholesky_kernel_gives_nan_when_not_positive_definite(cuda_device,
                                                              dtype, n, row):
    """A negative pivot inside a tile, at the first row of the first tile,
    of tiles factored inside a trailing launch (64, 128), and in a ragged
    last tile (rows 192-199): NaN, no error, the leading block finite, the
    upper triangle zero."""
    a = _spd(n, dtype).to(cuda_device)
    a[row, row] = -5.0
    l = kernels.cholesky(a)  # raises nothing
    assert torch.isnan(l).any()
    assert torch.isfinite(l[:row, :row]).all()
    assert int(torch.count_nonzero(torch.triu(l, 1))) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [200, 1024])
def test_cholesky_kernel_repeats_bit_for_bit(cuda_device, n, dtype):
    a = _spd(n, dtype, seed=5).to(cuda_device)
    assert torch.equal(kernels.cholesky(a), kernels.cholesky(a))


# -- trailing_precision="high": the trailing update's bf16x3 branch ---------------
# (n, P, dtype): the edges of the 64-wide blocking and the look-ahead at
# both P, the GP sizes, and float64 at two of them
CHOL_HIGH_CASES = [(n, p, torch.float32) for n in (63, 65, 129, 200, 1000,
                                                   1024, 2048)
                   for p in (64, 256)] + [
    (200, 64, torch.float64), (1024, 64, torch.float64),
    (1024, 256, torch.float64)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,p,dtype", CHOL_HIGH_CASES)
def test_cholesky_high_kernel_matches_plain_on_card(cuda_device, n, p, dtype):
    """Against plain "high" (the same bf16x3 products, summed in another
    order) on the card, at the HIGHEST test's float32 bar in both dtypes:
    1e-5 relative to max |L| and by the residual; the upper triangle zero;
    one call counted on `cholesky` and on `cholesky_high`."""
    a = _spd(n, dtype).to(cuda_device)
    before = kernels.cholesky.launches, kernels.cholesky_high.launches
    l = kernels.cholesky(a, "high", p)
    assert (kernels.cholesky.launches, kernels.cholesky_high.launches) == (
        before[0] + 1, before[1] + 1)
    assert _rel(l, kernels.cholesky_plain(a, "high", p)) <= 1e-5
    assert _rel(l @ l.T, a) <= 1e-5
    assert int(torch.count_nonzero(torch.triu(l, 1))) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,p", [(200, 64), (1024, 256), (2048, 128)])
def test_cholesky_high_kernel_repeats_bit_for_bit_and_is_not_highest(
        cuda_device, n, p, dtype):
    """Two calls give the same bits; the factor differs from "highest"'s
    (each n has products that cross P-blocks), and by the default P at
    n = 1024 (256) it is the call with P given."""
    a = _spd(n, dtype, seed=5).to(cuda_device)
    l = kernels.cholesky(a, "high", p)
    assert torch.equal(l, kernels.cholesky(a, "high", p))
    assert not torch.equal(l, kernels.cholesky(a))
    if p == ch.hbm_panel_width(n):
        assert torch.equal(l, kernels.cholesky(a, "high"))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [200, 1024])
def test_cholesky_high_device_launches(cuda_device, n):
    """2 ceil(n / 64) - 1 device launches, as "highest"."""
    from gpnf_tpu_torch.utils.cuda_timing import device_launches

    a = _spd(n, torch.float32).to(cuda_device)
    got = {k: c for k, c in device_launches(
        lambda: kernels.cholesky(a, "high", 64)).items()
        if k.startswith("chol_")}
    assert sum(got.values()) == kernels.cholesky_device_launches(n), got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,row", [(300, 150), (300, 128), (200, 195)])
def test_cholesky_high_kernel_gives_nan_when_not_positive_definite(
        cuda_device, dtype, n, row):
    a = _spd(n, dtype).to(cuda_device)
    a[row, row] = -5.0
    l = kernels.cholesky(a, "high", 64)  # raises nothing
    assert torch.isnan(l).any()
    assert torch.isfinite(l[:row, :row]).all()
    assert int(torch.count_nonzero(torch.triu(l, 1))) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,p,j", [(1000, 128, 0), (1000, 128, 2),
                                   (1024, 64, 1), (1024, 256, 5)])
def test_cholesky_high_trailing_update_matches_bf16x3_plain(cuda_device, n,
                                                            p, j, dtype):
    """One launch of the trailing kernel (`trailing_high`) against its
    plain version: each lower entry of the trailing matrix outside the
    tile it then factors within the float32 sums' spread, 2 K 2^-24
    sum_k |L_ik L_jk| (K = 64) plus one rounding of the result; that tile
    (its factor) within 1e-5 relative; the rows above untouched. Both
    kinds of tile column: P 128 at j 0 and 2, P 256 at j 5, take the
    product in the matrix's dtype for the columns in panel j's P-block."""
    r = np.random.default_rng(n + j)
    a = torch.from_numpy(10 * np.eye(n) + 0.1 * r.standard_normal((n, n)))
    a = a.to(dtype).to(cuda_device)
    got, want = ch.trailing_high(a, j, p), ch.trailing_high_plain(a, j, p)
    s = 64 * (j + 1)
    e = min(n, s + 64)
    panel = a[:, s - 64:s].double().abs()
    spread = 2 * 64 * 2.0 ** -24 * (panel @ panel.T) + 2.0 ** -23 * (
        want.double().abs())
    lower = torch.tril(torch.ones(n, n, dtype=torch.bool,
                                  device=cuda_device))
    lower[:s] = False
    lower[:, :s] = False
    lower[s:e, s:e] = False
    diff = (got.double() - want.double()).abs()
    assert bool((diff[lower] <= spread[lower]).all()), float(
        (diff[lower] / spread[lower]).max())
    assert _rel(torch.tril(got[s:e, s:e]), torch.tril(want[s:e, s:e])) <= 1e-5
    assert torch.equal(got[:s], a[:s])


@pytest.mark.cuda
def test_cholesky_high_wrapper_rejects_bad_inputs_on_card(cuda_device):
    a = _spd(256, torch.float32).to(cuda_device)
    with pytest.raises(ValueError):
        kernels.cholesky(a, "HIGH")
    with pytest.raises(ValueError):
        kernels.cholesky(a, "high", 96)
    with pytest.raises(TypeError):
        kernels.cholesky(a.half(), "high")
    with pytest.raises(ValueError, match="trailing"):
        ch.trailing_high(a, 3, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bar", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("n,p", [(200, 1), (200, 5), (1024, 1), (1000, 300),
                                 (256, 256)])
def test_tril_solve_kernel_matches_plain_on_card(cuda_device, n, p, trans,
                                                 dtype, bar):
    l = torch.linalg.cholesky(_spd(n, torch.float64, seed=1)).to(
        dtype).contiguous()
    b = torch.from_numpy(np.random.default_rng(2).standard_normal((n, p))).to(
        dtype)
    l, b = l.to(cuda_device), b.to(cuda_device)
    x = kernels.tril_solve(l, b, trans=trans)
    assert _rel(x, kernels.tril_solve_plain(l, b, trans=trans)) <= 10 * bar
    op = l.T if trans else l
    assert _rel(op @ x, b) <= bar


def _solve_inputs(n, p, dtype, device, seed=1):
    l = torch.linalg.cholesky(_spd(n, torch.float64, seed=seed)).to(
        dtype).contiguous()
    b = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (n, p))).to(dtype)
    return l.to(device), b.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bar", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("p", [1, 3, 31, 32, 33])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 129, 1000])
def test_tril_solve_kernel_edges_match_plain_on_card(cuda_device, n, p,
                                                     trans, dtype, bar):
    """The ragged edges of the 64-row blocks and of the column tiles (4
    wide below p = 32, 64 wide from there), against the plain version and
    by the residual, at the bars of the cases above."""
    l, b = _solve_inputs(n, p, dtype, cuda_device, seed=n + p)
    x = kernels.tril_solve(l, b, trans=trans)
    assert _rel(x, kernels.tril_solve_plain(l, b, trans=trans)) <= 10 * bar
    op = l.T if trans else l
    assert _rel(op @ x, b) <= bar


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("p", [1, 256])
@pytest.mark.parametrize("n", [200, 1024])
def test_tril_solve_kernel_repeats_bit_for_bit(cuda_device, n, p, trans,
                                               dtype):
    """Every sum runs in a fixed order, whichever block finishes first."""
    l, b = _solve_inputs(n, p, dtype, cuda_device, seed=7)
    assert torch.equal(kernels.tril_solve(l, b, trans=trans),
                       kernels.tril_solve(l, b, trans=trans))


@pytest.mark.cuda
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("n,p", [(4096, 512), (16384, 1)])
def test_tril_solve_kernel_with_more_blocks_than_the_card_holds(
        cuda_device, n, p, trans):
    """More logical blocks (4096 at n = 4096, p = 512), or a longer chain
    of them (256 at n = 16384, L 1 GiB in float32), than run at once on
    the card: the tickets keep the solve order, held by the residual."""
    gen = torch.Generator(device=cuda_device).manual_seed(n + p)
    x0 = torch.randn((n, n), generator=gen, device=cuda_device,
                     dtype=torch.float64)
    a = x0 @ x0.T / n + torch.eye(n, dtype=torch.float64, device=cuda_device)
    del x0
    l = torch.linalg.cholesky(a).float().contiguous()
    del a
    b = torch.randn((n, p), generator=gen, device=cuda_device)
    x = kernels.tril_solve(l, b, trans=trans)
    op = l.T if trans else l
    assert _rel(op @ x, b) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(1024, 384), (1024, 192), (7, 1000)])
def test_fused_affine_kernel_matches_plain_on_card(cuda_device, shape, dtype):
    r = np.random.default_rng(3)
    x2, shift, raw = (torch.from_numpy(r.standard_normal(shape) * s).to(
        dtype).to(cuda_device) for s in (1.0, 0.1, 3.0))
    raw[0, 0] = -200.0  # log sigmoid stays finite
    y, ldj = kernels.fused_affine_forward(x2, shift, raw)
    y_p, ldj_p = kernels.fused_affine_plain(x2, shift, raw)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(y, y_p, rtol=tol, atol=tol)
    torch.testing.assert_close(ldj, ldj_p, rtol=tol, atol=tol * shape[1])
    assert torch.isfinite(ldj).all()


@pytest.mark.cuda
def test_gp_kernel_backwards_on_card_match_float64_cpu(cuda_device):
    """Each kernel's backward through its autograd.Function on the card
    (float64) against autograd of the plain version on the CPU (float64)."""
    n = 256
    r = np.random.default_rng(4)
    b0 = _spd(n, torch.float64)
    g_l = torch.from_numpy(r.standard_normal((n, n)))
    grads = []
    for dev in (cuda_device, "cpu"):
        b = b0.to(dev).requires_grad_()
        a = 0.5 * (b + b.T)
        fn = kernels.cholesky if dev != "cpu" else kernels.cholesky_plain
        grads.append(torch.autograd.grad((fn(a) * g_l.to(dev)).sum(), b)[0])
    assert _rel(grads[0], grads[1]) <= 1e-10
    l0 = torch.linalg.cholesky(b0).contiguous()
    rhs = torch.from_numpy(r.standard_normal((n, 3)))
    for trans in (False, True):
        grads = []
        for dev in (cuda_device, "cpu"):
            l, b = (t.to(dev).requires_grad_() for t in (l0, rhs))
            fn = (kernels.tril_solve if dev != "cpu"
                  else kernels.tril_solve_plain)
            x = fn(l, b, trans=trans)
            grads.append(torch.autograd.grad((x * x).sum(), (l, b)))
        for got, want in zip(*grads):
            assert _rel(torch.tril(got), torch.tril(want)) <= 1e-10
    x2, shift, raw = (torch.from_numpy(r.standard_normal((64, 96)))
                      for _ in range(3))
    grads = []
    for dev in (cuda_device, "cpu"):
        args = [t.to(dev).requires_grad_() for t in (x2, shift, raw)]
        fn = (kernels.fused_affine_forward if dev != "cpu"
              else kernels.fused_affine_plain)
        y, ldj = fn(*args)
        grads.append(torch.autograd.grad((y * y).sum() + ldj.sum(), args))
    for got, want in zip(*grads):
        assert _rel(got, want) <= 1e-12


@pytest.mark.cuda
def test_gp_kernel_wrappers_reject_bad_inputs_on_card(cuda_device):
    a = _spd(64, torch.float32).to(cuda_device)
    with pytest.raises(TypeError):
        kernels.cholesky(a.half())
    with pytest.raises(TypeError):  # one dtype for every input
        kernels.tril_solve(a, a[:, :3].double())
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kernels.tril_solve(a, a[:, :3].cpu())
    with pytest.raises(ValueError):
        kernels.cholesky(a[:, :10])
    with pytest.raises(ValueError, match="contiguous"):
        kernels.cholesky(a.T)
    with pytest.raises(ValueError):
        kernels.fused_affine_forward(a, a, a[:, :3])


# -- the fused GatedConv (MarScfConfig.fused_gated_conv) --------------------------
def _gated_conv_inputs(device, c, h, w, batch=4, seed=0):
    """x (B, H, W, C), w1 (3, 3, 2C, C), b1, wg (2C, 2C), bg, a cotangent."""
    r = np.random.default_rng(seed)
    return [t.to(device) for t in (
        _normal(r, (batch, h, w, c)), _normal(r, (3, 3, 2 * c, c), (18 * c) ** -0.5),
        _normal(r, (c,), 0.1), _normal(r, (2 * c, 2 * c), (2 * c) ** -0.5),
        _normal(r, (2 * c,), 0.1), _normal(r, (batch, h, w, c)))]


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("c,h,w", [(16, 8, 8), (8, 5, 7), (96, 16, 16),
                                   (96, 8, 8), (96, 4, 4), (96, 32, 32),
                                   (4, 6, 6), (12, 8, 8), (48, 16, 16),
                                   (160, 8, 8), (512, 16, 16), (512, 8, 8),
                                   (512, 4, 4), (13, 5, 7), (128, 8, 8),
                                   (64, 6, 6)])
def test_gated_conv_kernels_match_plain_on_card(cuda_device, c, h, w, rate):
    """One seed for kernel and plain version: the same mask. Forward within
    1e-5 x max(1, max |out|); dx within 1e-5 of its largest magnitude and
    each weight and bias gradient within 1e-4 of its own largest. Every C
    runs and every tile: C = 13 (and 5 x 7 images) on the 4-byte copies, C
    = 512 at the --C 512 model's batch 16 on its three levels (16 x 16 on
    128 x 128 tiles), C = 96 on 64 x 96 (the conv, dw1), C = 128 (the conv,
    dw1) and 64 (dwg) on 64 x 128, split K at the small images."""
    x, w1, b1, wg, bg, g = _gated_conv_inputs(cuda_device, c, h, w,
                                              batch=16 if c == 512 else 4)
    seed = torch.tensor([4242 + c], dtype=torch.int32, device=cuda_device)
    before = (kernels.fused_gated_conv.launches,
              kernels.fused_gated_conv_bwd.launches)
    out = kernels.fused_gated_conv(x, w1, b1, wg, bg, rate, seed)
    grads = kernels.fused_gated_conv_bwd(x, w1, b1, wg, bg, g, rate, seed)
    assert (kernels.fused_gated_conv.launches,
            kernels.fused_gated_conv_bwd.launches) == (before[0] + 1,
                                                       before[1] + 1)
    want = kernels.gated_conv_plain(x, w1, b1, wg, bg, rate, seed)
    assert float((out - want).abs().max()) <= 1e-5 * max(
        1.0, float(want.abs().max()))
    want_grads = kernels.gated_conv_plain_bwd(x, w1, b1, wg, bg, g, rate, seed)
    for name, got, ref in zip(("dx", "dw1", "db1", "dwg", "dbg"), grads,
                              want_grads):
        assert torch.isfinite(got).all(), name
        bar = 1e-5 if name == "dx" else 1e-4
        assert _rel_max(got, ref) <= bar, name


# (B, H, W, C) -> (scratch floats, device launches) of the forward and the
# backward at rate 0, then 0.2: the flagship's 32-px levels, the 64-px level
# 0, and the --C 512 model's levels
GATED_CONV_PLANS = {
    (64, 16, 16, 96): ((3145728, 2), (1659840, 8), (3158016, 3),
                       (1672128, 9)),
    (64, 8, 8, 96): ((2752512, 3), (1966080, 9), (2764800, 4), (1978368, 10)),
    (64, 4, 4, 96): ((884736, 3), (1327872, 10), (897024, 4), (1340160, 11)),
    (64, 32, 32, 96): ((12582912, 2), (1659840, 8), (12595200, 3),
                       (1672128, 9)),
    (16, 16, 16, 512): ((4194304, 2), (1, 6), (4210688, 3), (16384, 7)),
    (16, 8, 8, 512): ((1048576, 2), (1, 6), (1064960, 3), (16384, 7)),
    (16, 4, 4, 512): ((1441792, 4), (1310720, 10), (1458176, 5),
                      (1327104, 11)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(GATED_CONV_PLANS))
def test_gated_conv_plan_at_the_paths_shapes(cuda_device, shape):
    """The source's scratch and launch counts at the paths' shapes: h2 (P
    2C floats) and the split products' partials, the dropout scales (B 2C)
    at rate > 0; a launch for each product, its split sum where K is split,
    and the mask table. A call launches that many kernels (the kernel nodes
    of a CUDA graph that captures it)."""
    from gpnf_tpu_torch.ops.kernels.fused_gated_conv import gated_conv_plan
    from gpnf_tpu_torch.utils.cuda_timing import graph_launches
    b, h, w, c = shape
    got = tuple(gated_conv_plan(b, h, w, c, dropout, backward)
                for dropout in (False, True) for backward in (False, True))
    assert got == GATED_CONV_PLANS[shape]
    with pytest.raises(ValueError, match="refused"):
        gated_conv_plan(0, h, w, c, False)
    x, w1, b1, wg, bg, g = _gated_conv_inputs(cuda_device, c, h, w, batch=b)
    seed = torch.tensor([11], dtype=torch.int32, device=cuda_device)
    for i, rate in enumerate((0.0, 0.2)):
        assert graph_launches(lambda: kernels.fused_gated_conv(
            x, w1, b1, wg, bg, rate, seed)) == got[2 * i][1]
        assert graph_launches(lambda: kernels.fused_gated_conv_bwd(
            x, w1, b1, wg, bg, g, rate, seed)) == got[2 * i + 1][1]


@pytest.mark.cuda
@pytest.mark.parametrize("c", [96, 160])
def test_gated_conv_bwd_repeats_bit_for_bit(cuda_device, c):
    """Two calls of the forward and of the backward give the same bits (the
    weight gradients' splits are summed in a fixed order)."""
    x, w1, b1, wg, bg, g = _gated_conv_inputs(cuda_device, c, 16, 16,
                                              batch=8)
    seed = torch.tensor([7], dtype=torch.int32, device=cuda_device)
    assert torch.equal(kernels.fused_gated_conv(x, w1, b1, wg, bg, 0.2, seed),
                       kernels.fused_gated_conv(x, w1, b1, wg, bg, 0.2, seed))
    first = kernels.fused_gated_conv_bwd(x, w1, b1, wg, bg, g, 0.2, seed)
    again = kernels.fused_gated_conv_bwd(x, w1, b1, wg, bg, g, 0.2, seed)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_gated_conv_takes_misaligned_operands(cuda_device):
    """x and g starting 4 bytes past a 16-byte boundary take the 4-byte
    copies: the same values as the aligned call, within the plain bars."""
    x, w1, b1, wg, bg, g = _gated_conv_inputs(cuda_device, 16, 8, 8)
    shift = lambda t: torch.cat([t.new_zeros(1), t.flatten()])[1:].view(
        t.shape)
    xs, gs = shift(x), shift(g)
    assert xs.data_ptr() % 16 == 4 and xs.is_contiguous()
    out = kernels.fused_gated_conv(xs, w1, b1, wg, bg)
    want = kernels.gated_conv_plain(x, w1, b1, wg, bg)
    assert float((out - want).abs().max()) <= 1e-5 * max(
        1.0, float(want.abs().max()))
    grads = kernels.fused_gated_conv_bwd(xs, w1, b1, wg, bg, gs)
    for name, got, ref in zip(("dx", "dw1", "db1", "dwg", "dbg"), grads,
                              kernels.gated_conv_plain_bwd(x, w1, b1, wg, bg,
                                                           g)):
        assert _rel_max(got, ref) <= (1e-5 if name == "dx" else 1e-4), name


@pytest.mark.cuda
def test_gated_conv_autograd_launches_both_kernels(cuda_device):
    x, w1, b1, wg, bg, g = _gated_conv_inputs(cuda_device, 16, 8, 8)
    seed = torch.tensor([3], dtype=torch.int32, device=cuda_device)
    args = [a.clone().requires_grad_() for a in (x, w1, b1, wg, bg)]
    counts = (kernels.fused_gated_conv.launches,
              kernels.fused_gated_conv_bwd.launches)
    kernels.fused_gated_conv(*args, 0.2, seed).backward(g)
    assert (kernels.fused_gated_conv.launches,
            kernels.fused_gated_conv_bwd.launches) == (counts[0] + 1,
                                                       counts[1] + 1)
    want = kernels.gated_conv_plain_bwd(x, w1, b1, wg, bg, g, 0.2, seed)
    for a, ref in zip(args, want):
        assert _rel_max(a.grad, ref) <= 1e-4


@pytest.mark.cuda
def test_gated_conv_rejects_what_the_kernels_do_not_take(cuda_device):
    x, w1, b1, wg, bg, g = _gated_conv_inputs(cuda_device, 16, 8, 8)
    with pytest.raises(TypeError, match="float32"):
        kernels.fused_gated_conv(*(a.double() for a in (x, w1, b1, wg, bg)))
    with pytest.raises(TypeError, match="float32"):
        kernels.fused_gated_conv_bwd(*(a.double() for a in (
            x, w1, b1, wg, bg, g)))
    # C = 12 is no longer refused: the kernels' result, one launch
    x12, w12, b12, wg12, bg12, _ = _gated_conv_inputs(cuda_device, 12, 8, 8)
    before = kernels.fused_gated_conv.launches
    out = kernels.fused_gated_conv(x12, w12, b12, wg12, bg12)
    assert kernels.fused_gated_conv.launches == before + 1
    want = kernels.gated_conv_plain(x12, w12, b12, wg12, bg12)
    assert float((out - want).abs().max()) <= 1e-5 * max(
        1.0, float(want.abs().max()))
    with pytest.raises(ValueError, match="w1"):
        kernels.fused_gated_conv(x, w1[:, :, :, :8], b1, wg, bg)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.fused_gated_conv(x.transpose(1, 2), w1, b1, wg, bg)
    with pytest.raises(ValueError, match="seed"):
        kernels.fused_gated_conv(x, w1, b1, wg, bg, 0.2,
                                 torch.zeros((2,), dtype=torch.int32,
                                             device=cuda_device))


@pytest.mark.cuda
def test_small_fused_model_on_card_matches_cpu_and_unfused(cuda_device):
    """The flag on: encode within 1e-4 bits/dim of the CPU and within 1e-5
    of the unfused model on the card; a training step at dropout 0 within
    1e-4 (loss) and 1e-3 of the largest gradient; L * K * num_blocks
    gated-conv launches each way."""
    cfg = MarScfConfig(**SMALL, drop_prob=0.0, fused_gated_conv=True)
    cpu = MarScfFlow(cfg, device="cpu")
    card = MarScfFlow(cfg, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    plain = MarScfFlow(MarScfConfig(**SMALL, drop_prob=0.0),
                       device=cuda_device).eval()
    plain.load_state_dict(cpu.state_dict())
    r = np.random.default_rng(7)
    x = torch.from_numpy(r.random((4, 3, 16, 16), dtype=np.float32) - 0.5)
    noise = torch.from_numpy(r.random((4, 3, 16, 16), dtype=np.float32))
    scale = np.log(2.0) * 16 * 16 * 3
    with torch.no_grad():
        _, obj_card = card.eval().encode(x.to(cuda_device),
                                         torch.zeros(4, device=cuda_device))
        _, obj_cpu = cpu.eval().encode(x, torch.zeros(4))
        _, obj_plain = plain.encode(x.to(cuda_device),
                                    torch.zeros(4, device=cuda_device))
    _close(obj_card / scale, obj_cpu / scale, rtol=0, atol=1e-4)
    _close(obj_card / scale, obj_plain / scale, rtol=0, atol=1e-5)
    kernels.reset_launch_counts()
    loss_card = torch.mean(card.train()(x.to(cuda_device),
                                        noise=noise.to(cuda_device))[1])
    loss_card.backward()
    counts = kernels.launch_counts()
    loss_cpu = torch.mean(cpu.train()(x, noise=noise)[1])
    loss_cpu.backward()
    assert counts["fused_gated_conv"] == counts["fused_gated_conv_bwd"] == 8
    _close(loss_card, loss_cpu, rtol=0, atol=1e-4)
    g_card, g_cpu = _flat_grads(card), _flat_grads(cpu)
    assert torch.isfinite(g_card).all()
    assert _rel_max(g_card.cpu(), g_cpu) <= 1e-3


# -- the core entries: fused_attention (q, k, v) and fused_attention_qkv --------
# (B, H, S, Dh): the flagship GatedAttn's three levels, the top of the range
# (S = 512 at Dh = 24 and 64), and a ragged S
CORE_SHAPES = [(64, 4, 256, 24), (64, 4, 64, 24), (64, 4, 16, 24),
               (8, 4, 512, 24), (8, 4, 512, 64), (4, 4, 100, 24)]


def _core_inputs(device, shape, seed=0):
    """q, k, v, g (B, H, S, Dh), q scaled, the packed qkv (B, S, 3C) of the
    same heads with q unscaled, its cotangent (B, S, C) and a seed."""
    b, h, s, dh = shape
    r = np.random.default_rng(seed)
    q, k, v, g = (_normal(r, shape, 0.5).to(device) for _ in range(4))
    merge = lambda x: x.transpose(1, 2).reshape(b, s, h * dh)
    qkv = torch.cat([merge(k), merge(v), merge(q) * dh ** 0.5], dim=-1)
    seed_t = torch.tensor([4321 + s], dtype=torch.int32, device=device)
    return q, k, v, g, qkv.contiguous(), merge(g).contiguous(), seed_t


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["split", "packed"])
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("shape", CORE_SHAPES)
def test_core_attention_kernels_match_plain_on_card(cuda_device, shape, rate,
                                                    layout):
    """One seed for kernel and plain version (the same mask): the forward
    within 1e-5 absolute, every gradient within 1e-4 of its largest; one
    launch of each kernel a call."""
    q, k, v, g, qkv, g3, seed = _core_inputs(cuda_device, shape)
    heads = shape[1]
    if layout == "split":
        fwd, bwd = kernels.fused_attention, kernels.fused_attention_bwd
        got = fwd(q, k, v, rate, seed)
        want = kernels.attention_plain(q, k, v, rate, seed)
        grads = bwd(q, k, v, g, rate, seed)
        want_grads = kernels.attention_plain_bwd(q, k, v, g, rate, seed)
    else:
        fwd, bwd = kernels.fused_attention_qkv, kernels.fused_attention_qkv_bwd
        got = fwd(qkv, heads, rate, seed)
        want = kernels.attention_long_plain(qkv, heads, rate, seed)
        grads = (bwd(qkv, g3, heads, rate, seed),)
        want_grads = (kernels.attention_long_plain_bwd(qkv, g3, heads, rate,
                                                       seed),)
    _close(got, want, rtol=0, atol=1e-5)
    for a, b in zip(grads, want_grads):
        assert torch.isfinite(a).all()
        assert _rel_max(a, b) <= 1e-4


@pytest.mark.cuda
def test_core_attention_bwd_repeats_bit_for_bit(cuda_device):
    q, k, v, g, qkv, g3, seed = _core_inputs(cuda_device, (8, 4, 256, 24))
    first = kernels.fused_attention_bwd(q, k, v, g, 0.2, seed)
    again = kernels.fused_attention_bwd(q, k, v, g, 0.2, seed)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert torch.equal(kernels.fused_attention_qkv_bwd(qkv, g3, 4, 0.2, seed),
                       kernels.fused_attention_qkv_bwd(qkv, g3, 4, 0.2, seed))


@pytest.mark.cuda
@pytest.mark.parametrize("s", [256, 64, 16, 100, 512])
def test_core_attention_agrees_with_proj_and_long_on_card(cuda_device, s):
    """Rate 0.2, one seed: fused_attention_qkv(seq w^T) matches
    fused_attention_proj(seq, w) (1e-5) and attention_long_qkv bit for bit
    (the same device code), gradients too; fused_attention on the heads of
    qkv, q scaled, matches fused_attention_qkv merged."""
    seq, w, g3, seed = _attention_inputs(cuda_device, s, batch=4)
    heads, c = 4, seq.shape[2]
    dh = c // heads
    qkv = torch.matmul(seq, w.t())
    out = kernels.fused_attention_qkv(qkv, heads, 0.2, seed)
    _close(out, kernels.fused_attention_proj(seq, w, heads, 0.2, seed),
           rtol=0, atol=1e-5)
    assert torch.equal(out, kernels.attention_long_qkv(qkv, heads, 0.2, seed))
    dqkv = kernels.fused_attention_qkv_bwd(qkv, g3, heads, 0.2, seed)
    assert torch.equal(dqkv, kernels.attention_long_qkv_bwd(qkv, g3, heads,
                                                            0.2, seed))
    dseq, dw = kernels.fused_attention_proj_bwd(seq, w, g3, heads, 0.2, seed)
    assert _rel_max(torch.matmul(dqkv, w), dseq) <= 1e-4
    assert _rel_max(torch.einsum("bso,bsc->oc", dqkv, seq), dw) <= 1e-4
    split = lambda x: x.reshape(4, s, heads, dh).transpose(1, 2).contiguous()
    k, v, q = (split(x) for x in qkv.split(c, dim=-1))
    merge = lambda x: x.transpose(1, 2).reshape(4, s, c)
    q = q * dh ** -0.5
    _close(merge(kernels.fused_attention(q, k, v, 0.2, seed)), out, rtol=0,
           atol=1e-6)
    dq, dk, dv = kernels.fused_attention_bwd(q, k, v, split(g3), 0.2, seed)
    want = torch.cat([merge(dk), merge(dv), merge(dq) * dh ** -0.5], dim=-1)
    assert _rel_max(dqkv, want) <= 1e-5


@pytest.mark.cuda
def test_core_attention_autograd_launches_both_kernels(cuda_device):
    q, k, v, g, qkv, g3, seed = _core_inputs(cuda_device, (4, 4, 64, 24))
    leaves = [t.clone().requires_grad_() for t in (q, k, v, qkv)]
    counts = [kernels.launch_counts()[n] for n in (
        "fused_attention", "fused_attention_bwd", "fused_attention_qkv",
        "fused_attention_qkv_bwd")]
    kernels.fused_attention(*leaves[:3], 0.2, seed).backward(g)
    kernels.fused_attention_qkv(leaves[3], 4, 0.2, seed).backward(g3)
    assert [kernels.launch_counts()[n] for n in (
        "fused_attention", "fused_attention_bwd", "fused_attention_qkv",
        "fused_attention_qkv_bwd")] == [c + 1 for c in counts]
    want = kernels.attention_plain_bwd(q, k, v, g, 0.2, seed)
    for leaf, w in zip(leaves[:3], want):
        assert _rel_max(leaf.grad, w) <= 1e-4
    assert _rel_max(leaves[3].grad, kernels.attention_long_plain_bwd(
        qkv, g3, 4, 0.2, seed)) <= 1e-4


@pytest.mark.cuda
def test_core_attention_rejects_what_the_kernels_do_not_take(cuda_device):
    """Where the long entry raises, S above MAX_S_LONG (zero-stride
    operands: the check comes before any copy) and Dh 260, and float64:
    before the device."""
    cases = {str(fa.MAX_S_LONG): ((1, 4, fa.MAX_S_LONG + 1, 24),
                                  torch.float32, ValueError),
             "head width": ((1, 4, 64, 260), torch.float32, ValueError),
             "float32": ((1, 4, 64, 24), torch.float64, TypeError)}
    for match, (shape, dtype, error) in cases.items():
        if shape[2] > fa.MAX_S_LONG:
            b, h, s, dh = shape
            zero = torch.zeros(1, device=cuda_device)
            q = k = v = g = zero.expand(shape)
            qkv, g3 = zero.expand(b, s, 3 * h * dh), zero.expand(b, s, h * dh)
        else:
            q, k, v, g, qkv, g3, _ = (t.to(dtype) for t in _core_inputs(
                cuda_device, shape))
        heads = shape[1]
        for call in (lambda: kernels.fused_attention(q, k, v),
                     lambda: kernels.fused_attention_bwd(q, k, v, g),
                     lambda: kernels.fused_attention_qkv(qkv, heads),
                     lambda: kernels.fused_attention_qkv_bwd(qkv, g3, heads)):
            with pytest.raises(error, match=match):
                call()


# -- the core entries at every S and width the long entry takes -----------------
# (B, H, S, Dh): S 1024 (the 64-px level 0) and 2304 (a 48 x 48 level 0),
# past the JAX kernels' 512; Dh 40 and 96, which the kernels take padded to
# 48 and 128
CORE_WIDE_SHAPES = [(2, 4, 1024, 24), (1, 4, 2304, 24), (4, 4, 256, 40),
                    (4, 4, 256, 96)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["split", "packed"])
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("shape", CORE_WIDE_SHAPES)
def test_core_wide_entries_match_plain_on_card(cuda_device, shape, rate,
                                               layout, dtype):
    """The four core entries against their plain versions at the bars of
    `test_core_attention_kernels_match_plain_on_card` (float32) and
    `test_core_bf16_kernels_match_plain_on_card` (bf16), one seed for
    kernel and plain version; the outputs at the true width; one launch
    counted on each entry a call."""
    q, k, v, g, qkv, g3, seed = (_core_bf16_inputs if dtype == torch.bfloat16
                                 else _core_inputs)(cuda_device, shape)
    heads, dh = shape[1], shape[3]
    before = kernels.launch_counts()
    if layout == "split":
        got = kernels.fused_attention(q, k, v, rate, seed)
        want = kernels.attention_plain(q, k, v, rate, seed)
        grads = kernels.fused_attention_bwd(q, k, v, g, rate, seed)
        want_grads = kernels.attention_plain_bwd(q, k, v, g, rate, seed)
        names = ("fused_attention", "fused_attention_bwd")
    else:
        got = kernels.fused_attention_qkv(qkv, heads, rate, seed)
        want = kernels.attention_long_plain(qkv, heads, rate, seed)
        grads = (kernels.fused_attention_qkv_bwd(qkv, g3, heads, rate, seed),)
        want_grads = (kernels.attention_long_plain_bwd(
            qkv, g3, heads, rate, seed, scale_dq_in_fp32=True),)
        names = ("fused_attention_qkv", "fused_attention_qkv_bwd")
    counts = kernels.launch_counts()
    assert [counts[n] - before[n] for n in names] == [1, 1]
    assert got.shape == want.shape and got.dtype == dtype
    if dtype == torch.float32:
        _close(got, want, rtol=0, atol=1e-5)
        for a, b in zip(grads, want_grads):
            assert torch.isfinite(a).all()
            assert _rel_max(a, b) <= 1e-4
        return
    assert float((got.float() - want.float()).abs().max()) <= \
        2.0 ** -7 * float(v.float().abs().max())
    if layout == "split":
        _split_bwd_held(grads, want_grads)
    else:
        _packed_bwd_held(grads[0], want_grads[0], heads * dh)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_core_wide_autograd_through_padded_heads(cuda_device, dtype):
    """S 1024 at Dh 40, rate 0.2: autograd through both entries (the bf16
    packed one keeps the forward's statistics) against the plain
    backwards at the bars above."""
    shape = (2, 4, 1024, 40)
    q, k, v, g, qkv, g3, seed = (_core_bf16_inputs if dtype == torch.bfloat16
                                 else _core_inputs)(cuda_device, shape)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, qkv)]
    kernels.fused_attention(*leaves[:3], 0.2, seed).backward(g)
    kernels.fused_attention_qkv(leaves[3], 4, 0.2, seed).backward(g3)
    split = kernels.attention_plain_bwd(q, k, v, g, 0.2, seed)
    packed = kernels.attention_long_plain_bwd(qkv, g3, 4, 0.2, seed,
                                              scale_dq_in_fp32=True)
    if dtype == torch.float32:
        for leaf, w in zip(leaves[:3], split):
            assert _rel_max(leaf.grad, w) <= 1e-4
        assert _rel_max(leaves[3].grad, packed) <= 1e-4
    else:
        _split_bwd_held([leaf.grad for leaf in leaves[:3]], split)
        _packed_bwd_held(leaves[3].grad, packed, 4 * 40)


# -- the core entries on bf16 operands -----------------------------------------
def _core_bf16_inputs(device, shape, seed=0):
    """`_core_inputs` rounded to bf16."""
    return tuple(_bf16(t) if t.dtype == torch.float32 else t
                 for t in _core_inputs(device, shape, seed))


def _split_bwd_held(grads, want):
    """The split bf16 backward's bar (`bf16_top_ulp_readings`): dq, dk and
    dv within one bf16 ulp of their largest |plain|, at most 5% of their
    values differing."""
    for got, plain in zip(grads, want):
        assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
        readings = fa.bf16_top_ulp_readings(got, plain)
        assert readings[-1], readings


def _packed_bwd_held(dqkv, want, c):
    """The packed bf16 pair's bar (phase 20's for the same kernels): dK, dV
    and dq each within 2^-7 of its largest |plain|."""
    for i in range(3):
        got, plain = (x[..., i * c:(i + 1) * c].float() for x in (dqkv, want))
        assert float((got - plain).abs().max()) <= \
            2.0 ** -7 * float(plain.abs().max()), i


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["split", "packed"])
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("shape", CORE_SHAPES)
def test_core_bf16_kernels_match_plain_on_card(cuda_device, shape, rate,
                                               layout):
    """bf16 q, k, v (or qkv) and g, one seed for kernel and plain version:
    the forward within 2^-7 max |v|; the split backward (`_bwd_kernel`'s
    recipe) within one bf16 ulp of each gradient's largest value, at most
    5% of the values differing; the packed backward within 2^-7 of each
    third's largest; two calls bit for bit; one launch of each bf16 kernel
    a call, counted on the entry too."""
    q, k, v, g, qkv, g3, seed = _core_bf16_inputs(cuda_device, shape)
    heads, dh = shape[1], shape[3]
    kernels.reset_launch_counts()
    if layout == "split":
        got = kernels.fused_attention(q, k, v, rate, seed)
        want = kernels.attention_plain(q, k, v, rate, seed)
        grads = kernels.fused_attention_bwd(q, k, v, g, rate, seed)
        assert all(torch.equal(a, b) for a, b in zip(
            grads, kernels.fused_attention_bwd(q, k, v, g, rate, seed)))
        _split_bwd_held(grads, kernels.attention_plain_bwd(q, k, v, g, rate,
                                                           seed))
        names = ("fused_attention", "fused_attention_bwd")
    else:
        got = kernels.fused_attention_qkv(qkv, heads, rate, seed)
        want = kernels.attention_long_plain(qkv, heads, rate, seed)
        dqkv = kernels.fused_attention_qkv_bwd(qkv, g3, heads, rate, seed)
        assert torch.equal(dqkv, kernels.fused_attention_qkv_bwd(
            qkv, g3, heads, rate, seed))
        _packed_bwd_held(dqkv, kernels.attention_long_plain_bwd(
            qkv, g3, heads, rate, seed, scale_dq_in_fp32=True), heads * dh)
        names = ("fused_attention_qkv", "fused_attention_qkv_bwd")
    assert got.dtype == torch.bfloat16
    assert float((got.float() - want.float()).abs().max()) <= \
        2.0 ** -7 * float(v.float().abs().max())
    counts = kernels.launch_counts()
    # one forward and two backward calls; the packed backward without the
    # forward's statistics runs the forward kernel first for them
    want_counts = dict.fromkeys(counts, 0)
    want_counts.update({names[0]: 1, names[1]: 2,
                        names[0] + "_bf16": 1 + 2 * (layout == "packed"),
                        names[1] + "_bf16": 2})
    assert counts == want_counts


@pytest.mark.cuda
@pytest.mark.parametrize("dh", fa.HEAD_DIMS)
def test_core_bf16_every_width_matches_plain_on_card(cuda_device, dh):
    """The split entry at every built width (Dh 4 through its zero-padded
    copy to 8, counted) and the packed one (each width padded to 24, 128
    or 256 as the long entry pads it), S 100, rate 0.2, the bars of
    `test_core_bf16_kernels_match_plain_on_card`."""
    shape = (3, 4, 100, dh)
    q, k, v, g, qkv, g3, seed = _core_bf16_inputs(cuda_device, shape)
    padded = kernels.core_bf16_padded.launches
    out = kernels.fused_attention(q, k, v, 0.2, seed)
    assert out.shape == q.shape
    assert float((out.float() - kernels.attention_plain(
        q, k, v, 0.2, seed).float()).abs().max()) <= \
        2.0 ** -7 * float(v.float().abs().max())
    _split_bwd_held(kernels.fused_attention_bwd(q, k, v, g, 0.2, seed),
                    kernels.attention_plain_bwd(q, k, v, g, 0.2, seed))
    assert kernels.core_bf16_padded.launches == padded + 2 * (dh == 4)
    out = kernels.fused_attention_qkv(qkv, 4, 0.2, seed)
    assert float((out.float() - kernels.attention_long_plain(
        qkv, 4, 0.2, seed).float()).abs().max()) <= \
        2.0 ** -7 * float(v.float().abs().max())
    _packed_bwd_held(kernels.fused_attention_qkv_bwd(qkv, g3, 4, 0.2, seed),
                     kernels.attention_long_plain_bwd(
                         qkv, g3, 4, 0.2, seed, scale_dq_in_fp32=True),
                     4 * dh)


@pytest.mark.cuda
def test_core_bf16_autograd_launches_each_kernel_once(cuda_device):
    """Both entries through autograd on bf16: one launch of each of the four
    bf16 kernels (the packed forward keeps its statistics, so its backward
    runs no forward), the gradients the backward kernels' own."""
    q, k, v, g, qkv, g3, seed = _core_bf16_inputs(cuda_device, (4, 4, 64, 24))
    leaves = [t.clone().requires_grad_() for t in (q, k, v, qkv)]
    kernels.reset_launch_counts()
    kernels.fused_attention(*leaves[:3], 0.2, seed).backward(g)
    kernels.fused_attention_qkv(leaves[3], 4, 0.2, seed).backward(g3)
    counts = kernels.launch_counts()
    core = ("fused_attention", "fused_attention_bwd", "fused_attention_qkv",
            "fused_attention_qkv_bwd")
    want = dict.fromkeys(counts, 0)
    want.update({n: 1 for n in core}, **{n + "_bf16": 1 for n in core})
    assert counts == want
    grads = (*kernels.fused_attention_bwd(q, k, v, g, 0.2, seed),
             kernels.fused_attention_qkv_bwd(qkv, g3, 4, 0.2, seed))
    assert all(torch.equal(leaf.grad, w) for leaf, w in zip(leaves, grads))


@pytest.mark.cuda
def test_core_bf16_takes_unaligned_operands_on_card(cuda_device):
    """bf16 operands off a 16-byte boundary are copied aligned before the
    tensor maps and cp.async loads: the aligned call's bits."""
    q, k, v, g, _, _, seed = _core_bf16_inputs(cuda_device, (2, 4, 64, 24))
    shift = lambda t: torch.empty(t.numel() + 1, dtype=torch.bfloat16,
                                  device=cuda_device)[1:].view_as(t).copy_(t)
    assert shift(q).data_ptr() % 16
    assert torch.equal(kernels.fused_attention(shift(q), k, shift(v), 0.2,
                                               seed),
                       kernels.fused_attention(q, k, v, 0.2, seed))
    for a, b in zip(kernels.fused_attention_bwd(q, shift(k), v, shift(g),
                                                0.2, seed),
                    kernels.fused_attention_bwd(q, k, v, g, 0.2, seed)):
        assert torch.equal(a, b)


def _gated_attn_through_plain(monkeypatch):
    """GatedAttn's attention on the plain versions (autograd through them),
    on whatever device its tensors are."""
    from gpnf_tpu_torch.ops import mixlogcdf

    def plain(seq, w, heads, rate, seed):
        return kernels.attention_long_plain(fa.qkv_plain(seq, w), heads,
                                            rate, seed)
    monkeypatch.setattr(mixlogcdf, "fused_attention_long", plain)


def _gated_attn_runs(device, monkeypatch, dtypes):
    """{(dtype, "kernels" or "plain"): {"out", "dx", each weight's gradient
    by name}} of
    GatedAttn (C 96) at 48 x 48, S 2304, batch 2, in training (rate 0.2,
    one seed), on the long entry's kernels and with the plain versions in
    their place."""
    from gpnf_tpu_torch.ops import mixlogcdf

    attn = mixlogcdf.GatedAttn(96, drop_prob=0.2).to(device).train()
    assert attn.route(2304).entry == "wide"
    r = np.random.default_rng(77)
    x = _normal(r, (2, 48, 48, 96)).to(device)
    g = _normal(r, (2, 48, 48, 96), 0.5).to(device)
    runs = {}
    for path in ("kernels", "plain"):
        if path == "plain":
            _gated_attn_through_plain(monkeypatch)
        for dtype in dtypes:
            attn.zero_grad()
            leaf = x.to(dtype).clone().requires_grad_()
            kernels.reset_launch_counts()
            out = attn(leaf, generator=torch.Generator(
                device=device).manual_seed(5))
            out.backward(g.to(dtype))
            counts = kernels.launch_counts()
            assert (counts["fused_attention_long"],
                    counts["fused_attention_long_bwd"]) == (
                        (0, 0) if path == "plain" else (1, 1))
            runs[dtype, path] = {
                "out": out.detach().float(), "dx": leaf.grad.float(),
                **{name: p.grad.float()
                   for name, p in attn.named_parameters()}}
    return runs


@pytest.mark.cuda
def test_gated_attn_beyond_2048_matches_plain_on_card(cuda_device,
                                                      monkeypatch):
    """GatedAttn (C 96) at 48 x 48, S 2304, batch 2, in training (rate 0.2,
    one seed): forward and backward on the long entry's kernels against the
    same module on the plain versions. float32 within 1e-5 (out) and 1e-4
    of each gradient's largest. bf16, whose gate's products round what the
    attention hands them: out, dx and each weight's gradient within
    `grad_parity`'s bar of the plain bf16 module's (3 times its own
    distance from the float32 module's; the attention's own bar, 2^-7
    max |v|, is `test_bf16_forward_beyond_2048_at_wide_tiles`')."""
    runs = _gated_attn_runs(cuda_device, monkeypatch,
                            (torch.float32, torch.bfloat16))
    got, want = runs[torch.float32, "kernels"], runs[torch.float32, "plain"]
    assert float((got["out"] - want["out"]).abs().max()) <= 1e-5
    for name, b in want.items():
        if name != "out":
            assert float((got[name] - b).abs().max()) <= 1e-4 * float(
                b.abs().max()), name
    got16 = runs[torch.bfloat16, "kernels"]
    assert all(torch.isfinite(a).all() for a in got16.values())
    rows = grad_parity.bf16_grad_parity(got16, runs[torch.bfloat16, "plain"],
                                        want)
    assert rows[0][0] <= 1.0, rows


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("c", [96, 512, 1024])
def test_bf16_forward_beyond_2048_at_wide_tiles(cuda_device, c, rate):
    """The bf16 forward at S 2304: Dh 24 (GatedAttn's C 96), and its
    in-place P V sum at W 128 and 256 (C 512, 1024; 36 or 72 key tiles,
    past the 64 of S 2048): within 2^-7 max |v| of the plain version."""
    r = np.random.default_rng(78)
    qkv = _bf16(_normal(r, (2, 2304, 3 * c))).to(cuda_device)
    seed = torch.tensor([12], dtype=torch.int32, device=cuda_device)
    got = kernels.attention_long_qkv(qkv, 4, rate, seed)
    want = kernels.attention_long_plain(qkv, 4, rate, seed)
    assert float((got.float() - want.float()).abs().max()) <= \
        2.0 ** -7 * float(qkv[..., c:2 * c].float().abs().max())


@pytest.mark.cuda
def test_bf16_keep_bits_at_s_2304_batch_64(cuda_device):
    """The bf16 backward's keep-bit scratch at B 64, H 4, S 2304 (B H Sp^2 /
    8 bytes, 170 MB): two calls bit for bit, finite, and the first two batch
    rows (the same rows and masks as a call at batch 2) against the plain
    version within phase 20's bar."""
    r = np.random.default_rng(79)
    qkv = _bf16(_normal(r, (64, 2304, 288), 0.5)).to(cuda_device)
    g = _bf16(_normal(r, (64, 2304, 96))).to(cuda_device)
    seed = torch.tensor([13], dtype=torch.int32, device=cuda_device)
    assert fa.keep_bits_scratch(64, 4, 2304, 0.2, "meta").numel() * 4 == \
        64 * 4 * 2304 ** 2 // 8
    dqkv = kernels.attention_long_qkv_bwd(qkv, g, 4, 0.2, seed)
    assert torch.equal(dqkv, kernels.attention_long_qkv_bwd(qkv, g, 4, 0.2,
                                                            seed))
    assert torch.isfinite(dqkv).all()
    want = kernels.attention_long_plain_bwd(qkv[:2], g[:2], 4, 0.2, seed)
    _packed_bwd_held(dqkv[:2], want, 96)


# -- the lane-split kernels (Dh = 128, 256) and GatedAttn at every width -----------
def _lane_counts():
    return (kernels.attention_lanes.launches,
            kernels.attention_lanes_bwd.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("s", [16, 64, 100, 256, 1024])
@pytest.mark.parametrize("dh", [128, 256])
def test_lane_split_kernels_match_plain_on_card(cuda_device, dh, s, rate):
    """The long entry at Dh = 128 and 256 (4 heads, batch 2): one seed for
    kernel and plain version, the forward within 1e-5 of its largest
    magnitude (outputs reach ~2 at C = 1024, and a score sums 256 products:
    1.1e-5 absolute, 6e-6 relative, was seen), dqkv within 1e-4 of its
    largest; two backward calls bit for bit; each call counts one
    lane-split launch."""
    qkv, g, seed = _qkv_inputs(cuda_device, s, c=4 * dh, seed=dh + s)
    before = _lane_counts()
    out = kernels.attention_long_qkv(qkv, 4, rate, seed)
    dqkv = kernels.attention_long_qkv_bwd(qkv, g, 4, rate, seed)
    assert _lane_counts() == (before[0] + 1, before[1] + 1)
    assert _rel_max(out, kernels.attention_long_plain(qkv, 4, rate,
                                                      seed)) <= 1e-5
    assert torch.isfinite(dqkv).all()
    assert _rel_max(dqkv, kernels.attention_long_plain_bwd(
        qkv, g, 4, rate, seed)) <= 1e-4
    assert torch.equal(dqkv, kernels.attention_long_qkv_bwd(qkv, g, 4, rate,
                                                            seed))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["split", "packed"])
@pytest.mark.parametrize("shape", [(4, 4, 256, 128), (2, 4, 100, 256)])
def test_core_entries_at_lane_split_widths_match_plain_on_card(
        cuda_device, shape, layout):
    """fused_attention and fused_attention_qkv run the lane-split kernels at
    Dh = 128 and 256: rate 0.2, one seed, against their plain versions."""
    q, k, v, g, qkv, g3, seed = _core_inputs(cuda_device, shape)
    heads = shape[1]
    if layout == "split":
        got = kernels.fused_attention(q, k, v, 0.2, seed)
        want = kernels.attention_plain(q, k, v, 0.2, seed)
        grads = kernels.fused_attention_bwd(q, k, v, g, 0.2, seed)
        want_grads = kernels.attention_plain_bwd(q, k, v, g, 0.2, seed)
    else:
        got = kernels.fused_attention_qkv(qkv, heads, 0.2, seed)
        want = kernels.attention_long_plain(qkv, heads, 0.2, seed)
        grads = (kernels.fused_attention_qkv_bwd(qkv, g3, heads, 0.2, seed),)
        want_grads = (kernels.attention_long_plain_bwd(qkv, g3, heads, 0.2,
                                                       seed),)
    _close(got, want, rtol=0, atol=1e-5)
    for a, b in zip(grads, want_grads):
        assert torch.isfinite(a).all()
        assert _rel_max(a, b) <= 1e-4


# the tensor-core backward (attention_tiled.cuh's attention_mma_dq_kernel
# and attention_mma_dkv_kernel): at Dh = 128 and 256, S off the tiles (17,
# 100), the CLIs' levels, Dh 256 at C = 1024; at the narrow widths (Dh 4
# pads its tiles to 8; 8 and 24 have an odd number of k steps; 24 the
# flagship's, 48 and 64 the widest) at S 16, 17, 64, 256, both layouts, and
# Dh 24 at S 1024 (the 64-px level 0) through the long entry alone (the
# core entries take S <= 512)
MMA_BWD_CASES = [(dh, s, layout)
                 for dh, s in [(128, 16), (128, 17), (128, 64), (128, 100),
                               (128, 256), (256, 64), (256, 256)]
                 + [(dh, s) for dh in (4, 8, 24, 48, 64)
                    for s in (16, 17, 64, 256)]
                 for layout in ("packed", "split")] + [(24, 1024, "packed")]


def _bwd_counter(layout):
    return (kernels.fused_attention_long_bwd if layout == "packed"
            else kernels.fused_attention_bwd)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dh,s,layout", MMA_BWD_CASES)
def test_mma_backward_matches_plain_on_card(cuda_device, dh, s, rate, layout):
    """The tensor-core backward through the long entry (packed qkv) and
    through fused_attention_bwd (split heads, q scaled), one seed for
    kernel and plain version: every gradient finite and within 1e-4 of its
    largest |plain| (the lane-split bar), two calls bit for bit, one launch
    a call on the entry's count and, at Dh = 128 and 256 only, on
    `attention_lanes_bwd`'s."""
    q, k, v, g, qkv, g3, seed = _core_inputs(cuda_device, (2, 4, s, dh),
                                             seed=dh + s)
    if layout == "packed":
        bwd = lambda: (kernels.attention_long_qkv_bwd(qkv, g3, 4, rate,
                                                      seed),)
        want = (kernels.attention_long_plain_bwd(qkv, g3, 4, rate, seed),)
    else:
        bwd = lambda: kernels.fused_attention_bwd(q, k, v, g, rate, seed)
        want = kernels.attention_plain_bwd(q, k, v, g, rate, seed)
    entry = _bwd_counter(layout)
    before = (entry.launches, kernels.attention_lanes_bwd.launches)
    got = bwd()
    assert (entry.launches, kernels.attention_lanes_bwd.launches) == (
        before[0] + 1, before[1] + (dh in (128, 256)))
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert _rel_max(a, b) <= 1e-4
    assert all(torch.equal(a, b) for a, b in zip(got, bwd()))


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_mma_backward_holds_near_uniform_rows_at_s_1024(cuda_device, rate):
    """Dh 24 (C = 96, 4 heads) at S = 1024, qkv of std 0.5 (scores of std
    ~0.25): every row's P is near uniform, and dq and dK / dV are sums over
    1024 keys or queries of terms that largely cancel, each summed across
    the key or query tiles in the tensor cores' fp32 accumulators. Within
    1e-4 of the largest |plain|, the backward's bar."""
    r = np.random.default_rng(24)
    qkv = _normal(r, (2, 1024, 3 * 96), 0.5).to(cuda_device)
    g = _normal(r, (2, 1024, 96)).to(cuda_device)
    seed = torch.tensor([2025], dtype=torch.int32, device=cuda_device)
    got = kernels.attention_long_qkv_bwd(qkv, g, 4, rate, seed)
    assert torch.isfinite(got).all()
    assert _rel_max(got, kernels.attention_long_plain_bwd(
        qkv, g, 4, rate, seed)) <= 1e-4


# the tensor-core forward (attention_mma_fwd_kernel) at every width: S off
# the tiles (17), the CLIs' and the flagship's levels, and S 1024 through
# the long entry alone (the core entries take S <= 512) at Dh 24 (the 64-px
# level 0), 64, 128 and 256; Dh 4 pads its tiles to 8, Dh 8 runs one k
# step, Dh 24 three (an odd last step)
MMA_FWD_CASES = [(dh, s, entry) for dh in fa.HEAD_DIMS
                 for s in (16, 17, 64, 256, 1024)
                 for entry in ("long", "qkv", "split")
                 if s <= 512 or (entry == "long" and dh in (24, 64, 128, 256))]
FWD_COUNTERS = {"long": kernels.fused_attention_long,
                "qkv": kernels.fused_attention_qkv,
                "split": kernels.fused_attention}


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dh,s,entry", MMA_FWD_CASES)
def test_mma_forward_matches_plain_on_card(cuda_device, dh, s, entry, rate):
    """The tensor-core forward through the long entry and
    fused_attention_qkv (packed qkv) and fused_attention (split heads, q
    scaled), one seed for kernel and plain version: finite, within 1e-5
    of the largest |plain| (the lane-split bar), two calls bit for bit, one
    launch a call on the entry's count and, at Dh = 128 and 256 only, on
    `attention_lanes`'."""
    q, k, v, _, qkv, _, seed = _core_inputs(cuda_device, (2, 4, s, dh),
                                            seed=dh + s)
    if entry == "split":
        fwd = lambda: kernels.fused_attention(q, k, v, rate, seed)
        want = kernels.attention_plain(q, k, v, rate, seed)
    else:
        fn = (kernels.attention_long_qkv if entry == "long"
              else kernels.fused_attention_qkv)
        fwd = lambda: fn(qkv, 4, rate, seed)
        want = kernels.attention_long_plain(qkv, 4, rate, seed)
    counter = FWD_COUNTERS[entry]
    before = (counter.launches, kernels.attention_lanes.launches)
    got = fwd()
    assert (counter.launches, kernels.attention_lanes.launches) == (
        before[0] + 1, before[1] + (dh in (128, 256)))
    assert torch.isfinite(got).all()
    assert _rel_max(got, want) <= 1e-5
    assert torch.equal(got, fwd())


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dh", [4, 24, 64, 128, 256])
def test_mma_forward_holds_near_uniform_rows_at_s_1024(cuda_device, dh,
                                                       rate):
    """qkv of std 0.5 at S = 1024 (scores of std ~0.25): each output is a
    near-uniform mean of 1024 values of V, small beside the sum it is
    accumulated in. A sum kept in place across the key tiles drifts with
    the tensor cores' truncating fp32 accumulation; the kernel adds each
    tile's product in fp32 and stays within 1e-5 of the largest |plain|,
    at Dh 24 (the 64-px level 0) and at every tile size."""
    r = np.random.default_rng(dh)
    qkv = _normal(r, (2, 1024, 3 * 4 * dh), 0.5).to(cuda_device)
    seed = torch.tensor([2024], dtype=torch.int32, device=cuda_device)
    got = kernels.attention_long_qkv(qkv, 4, rate, seed)
    assert _rel_max(got, kernels.attention_long_plain(qkv, 4, rate,
                                                      seed)) <= 1e-5


def _shifted(x):
    """x's values in a contiguous tensor that starts one float past a
    16-byte boundary."""
    y = torch.empty(x.numel() + 1, device=x.device)[1:].view_as(x)
    return y.copy_(x)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [4, 24, 128])
def test_mma_forward_refuses_misaligned_operands(cuda_device, dh):
    """A packed qkv or a q that starts off a 16-byte boundary, or a
    transposed (strided) q, is copied into an aligned contiguous tensor by
    the wrapper, not refused: each call gives the aligned call's bits,
    raises nothing and counts one launch (cp.async moves 16-byte chunks,
    so the kernel itself still needs aligned operands), at every tile
    width."""
    q, k, v, _, qkv, _, seed = _core_inputs(cuda_device, (2, 4, 64, dh))
    lanes = int(dh == 128)
    q_t = q.transpose(-1, -2).contiguous().transpose(-1, -2)
    assert not q_t.is_contiguous()
    for call, counter, aligned in (
            (lambda x: kernels.attention_long_qkv(x, 4, 0.2, seed),
             kernels.fused_attention_long, qkv),
            (lambda x: kernels.fused_attention_qkv(x, 4, 0.2, seed),
             kernels.fused_attention_qkv, qkv),
            (lambda x: kernels.fused_attention(x, k, v, 0.2, seed),
             kernels.fused_attention, q)):
        want = call(aligned)
        for x in (_shifted(aligned), q_t if aligned is q else None):
            if x is None:
                continue
            before = (counter.launches, kernels.attention_lanes.launches)
            assert torch.equal(call(x), want)
            assert (counter.launches,
                    kernels.attention_lanes.launches) == (before[0] + 1,
                                                          before[1] + lanes)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [512, 96])
def test_mma_backward_refuses_misaligned_operands(cuda_device, c):
    """A contiguous qkv or g that starts off a 16-byte boundary, at Dh 128
    (C = 512) and at the flagship's Dh 24 (C = 96), is copied into an
    aligned tensor by the wrapper before the tensor-core kernels' cp.async
    loads: the aligned call's bits, no error, one launch counted; so is
    the split entry's transposed (strided) g."""
    qkv, g, seed = _qkv_inputs(cuda_device, 64, c=c)
    want = kernels.attention_long_qkv_bwd(qkv, g, 4, 0.2, seed)
    lanes = int(c == 512)
    for args in ((_shifted(qkv), g), (qkv, _shifted(g))):
        before = (kernels.fused_attention_long_bwd.launches,
                  kernels.attention_lanes_bwd.launches)
        assert torch.equal(kernels.attention_long_qkv_bwd(*args, 4, 0.2,
                                                          seed), want)
        assert (kernels.fused_attention_long_bwd.launches,
                kernels.attention_lanes_bwd.launches) == (before[0] + 1,
                                                          before[1] + lanes)
    q, k, v, gh, _, _, core_seed = _core_inputs(cuda_device,
                                                (2, 4, 64, c // 4))
    gh_t = gh.transpose(-1, -2).contiguous().transpose(-1, -2)
    want = kernels.fused_attention_bwd(q, k, v, gh, 0.2, core_seed)
    before = kernels.fused_attention_bwd.launches
    for got, plain in zip(kernels.fused_attention_bwd(
            _shifted(q), k, v, gh_t, 0.2, core_seed), want):
        assert torch.equal(got, plain)
    assert kernels.fused_attention_bwd.launches == before + 1


def _hmma_counts(pattern, sources=("fused_attention_long",
                                   "fused_attention")):
    """{source: {kernel: HMMA instructions in its SASS}} of the kernels whose
    mangled name holds `pattern`, in each library of `sources` (by default
    both that build the tensor-core attention kernels); a skip where the
    toolkit has no cuobjdump to read the SASS with."""
    import os
    import re
    import shutil
    import subprocess

    from gpnf_tpu_torch.ops.kernels import _native

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(cuobjdump):
        pytest.skip("no cuobjdump in the CUDA toolkit: the SASS cannot be "
                    "read here")
    counts = {}
    for source in sources:
        _native.build([source])
        sass = subprocess.run([cuobjdump, "-sass",
                               str(_native.library_path(source))],
                              capture_output=True, text=True,
                              check=True).stdout
        hmma, fn = {}, None
        for line in sass.splitlines():
            name = re.search(rf"Function : (\S*{pattern}\S*)", line)
            if "Function : " in line:
                fn = name.group(1) if name else None
                if fn:
                    hmma[fn] = 0
            elif fn and "HMMA" in line:
                hmma[fn] += 1
        counts[source] = hmma
    return counts


@pytest.mark.cuda
def test_mma_backward_kernels_run_on_the_tensor_cores(cuda_device):
    """Every instantiation of the tensor-core dq and dK/dV kernels (the 9
    built widths, the flagship's Dh 24 among them, with and without
    dropout, in both libraries that build them, and the split heads' bf16
    ones at every width but 4 in their own) holds HMMA instructions in its
    SASS. Skipped only where the toolkit has no cuobjdump to read the
    SASS with."""
    for source, hmma in _hmma_counts("attention_mma_d").items():
        layouts = 1 if source == "fused_attention_long" else 2
        assert len(hmma) == 2 * 2 * len(fa.HEAD_DIMS) * layouts, sorted(hmma)
        dh24 = [n for name, n in hmma.items() if "ILi24E" in name]
        assert len(dh24) == 2 * 2 * layouts, sorted(hmma)
        assert all(n > 0 for n in hmma.values()), hmma
    # the split heads on bf16 operands (fused_attention_bf16.cu), at every
    # width but 4
    hmma = _hmma_counts("attention_mma_d", ("fused_attention_bf16",))[
        "fused_attention_bf16"]
    assert len(hmma) == 2 * 2 * (len(fa.HEAD_DIMS) - 1), sorted(hmma)
    assert all("nv_bfloat16" in name and n > 0 for name, n in hmma.items())


@pytest.mark.cuda
def test_mma_forward_kernel_runs_on_the_tensor_cores(cuda_device):
    """Every instantiation of the tensor-core forward (the 9 built widths,
    the flagship's Dh 24 among them, with and without dropout, in both
    libraries that build it) holds HMMA instructions in its SASS."""
    for source, hmma in _hmma_counts("attention_mma_fwd").items():
        layouts = 1 if source == "fused_attention_long" else 2
        assert len(hmma) == 2 * len(fa.HEAD_DIMS) * layouts, sorted(hmma)
        dh24 = [n for name, n in hmma.items() if "ILi24E" in name]
        assert len(dh24) == 2 * layouts, sorted(hmma)
        assert all(n > 0 for n in hmma.values()), hmma


@pytest.mark.cuda
def test_gemm_kernels_run_on_the_tensor_cores(cuda_device):
    """Every instantiation of the GEMM kernel (three layouts, two tiles,
    16- and 4-byte copies) holds HMMA instructions in its SASS."""
    hmma = _hmma_counts("gemm_mma_kernel", ("attention_gemm",))
    hmma = hmma["attention_gemm"]
    assert len(hmma) == 3 * 2 * 2, sorted(hmma)
    assert all(n > 0 for n in hmma.values()), hmma


@pytest.mark.cuda
@pytest.mark.parametrize("batch,s,c", [(16, 256, 512), (16, 16, 512),
                                       (2, 100, 160), (1, 7, 8),
                                       (64, 256, 96), (64, 64, 96),
                                       (64, 16, 96), (16, 64, 512),
                                       (1, 7, 6)])
def test_projection_gemms_match_plain_on_card(cuda_device, batch, s, c):
    """The wide route's GEMM kernels (qkv = seq w^T, dseq = dqkv w, dW =
    dqkv^T seq) against torch.matmul, within 1e-5 of the largest magnitude
    (a sum of up to B S float32 products), ragged tiles among the shapes
    (and C = 6, rows not a multiple of 4 floats: the 4-byte copies); two
    calls bit for bit; each call counts one launch."""
    seq, w, _, _ = _attention_inputs(cuda_device, s, batch, c, seed=s + c)
    dqkv = _normal(np.random.default_rng(c), (batch, s, 3 * c)).to(
        cuda_device)
    for fn, a, b, want in (
            (kernels.attention_qkv_gemm, seq, w, torch.matmul(seq, w.t())),
            (kernels.attention_dseq_gemm, dqkv, w, torch.matmul(dqkv, w)),
            (kernels.attention_dw_gemm, dqkv, seq,
             torch.einsum("bso,bsc->oc", dqkv, seq))):
        before = fn.launches
        got = fn(a, b)
        assert fn.launches == before + 1
        assert got.shape == want.shape
        assert _rel_max(got, want) <= 1e-5, fn.__name__
        assert torch.equal(got, fn(a, b))


def _gemm_calls(seq, w, dqkv):
    """(wrapper, its two operands, float64 torch.matmul of the product) of
    the three GEMMs."""
    d = lambda x: x.double()
    return ((kernels.attention_qkv_gemm, seq, w,
             torch.matmul(d(seq), d(w).t())),
            (kernels.attention_dseq_gemm, dqkv, w, torch.matmul(d(dqkv), d(w))),
            (kernels.attention_dw_gemm, dqkv, seq,
             torch.einsum("bso,bsc->oc", d(dqkv), d(seq))))


@pytest.mark.cuda
@pytest.mark.parametrize("product,batch,s,c", [("dseq", 16, 256, 512),
                                               ("dw", 64, 256, 96),
                                               ("qkv", 4, 256, 1024)])
def test_gemms_hold_same_sign_inputs_on_card(cuda_device, product, batch, s,
                                             c):
    """Uniform [0, 1) inputs, the worst case for a biased rounding: every
    product adds to the sum. dseq over K = 1536, dW over K = B S = 16,384
    (split), qkv over K = 1024; within 1e-5 of the largest entry of a
    float64 torch.matmul, two calls bit for bit. The tensor cores' fp32
    accumulation truncates: the kernel sums each K chunk apart and adds
    the chunks in fp32."""
    gen = torch.Generator(device=cuda_device).manual_seed(c + s)
    rand = lambda *shape: torch.rand(shape, generator=gen, device=cuda_device)
    seq, w, dqkv = rand(batch, s, c), rand(3 * c, c), rand(batch, s, 3 * c)
    fn, a, b, want = _gemm_calls(seq, w, dqkv)[
        ("qkv", "dseq", "dw").index(product)]
    got = fn(a, b)
    assert _rel_max(got.double(), want) <= 1e-5, fn.__name__
    assert torch.equal(got, fn(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [96, 512])
def test_gemms_take_shifted_and_strided_operands_on_card(cuda_device, c):
    """Each operand of each GEMM at a base one float past a 16-byte
    boundary (the 4-byte copies), and as a transposed (non-contiguous)
    view (copied contiguous by the wrapper): the aligned, contiguous call's
    bits, one launch counted, no error."""
    r = np.random.default_rng(c)
    seq, w, dqkv = (_normal(r, shape).to(cuda_device) for shape in (
        (2, 64, c), (3 * c, c), (2, 64, 3 * c)))
    strided = lambda x: x.transpose(-1, -2).contiguous().transpose(-1, -2)
    for fn, a, b, _ in _gemm_calls(seq, w, dqkv):
        want = fn(a, b)
        for args in ((_shifted(a), b), (a, _shifted(b)), (strided(a), b),
                     (a, strided(b))):
            before = fn.launches
            assert torch.equal(fn(*args), want), fn.__name__
            assert fn.launches == before + 1


# the entry each width takes at the 32-px levels' S = 256, 64, 16
WIDTH_ROUTES = {8: "www", 48: "www", 128: "ppp", 160: "www", 192: "wpp",
                512: "www"}


@pytest.mark.cuda
@pytest.mark.parametrize("s", [256, 64, 16])
@pytest.mark.parametrize("c", sorted(WIDTH_ROUTES))
def test_gated_attn_at_every_width_on_card_matches_cpu(cuda_device, c, s):
    """GatedAttn (4 heads) on the card against the same weights on the CPU,
    the plain path, in eval mode (batch 2): output within rtol 1e-4, atol
    1e-5 (the bar against the JAX GatedAttn), the gradients of x and of the
    weights within 1e-4 of their largest; the launch counts show the route
    `attention_route` names (proj, or the long entry with the GEMM kernels
    around it, and the lane-split kernels at C = 512)."""
    from gpnf_tpu_torch.ops.mixlogcdf import GatedAttn

    side = int(s ** 0.5)
    cpu = GatedAttn(c, generator=torch.Generator().manual_seed(c)).eval()
    card = GatedAttn(c).to(cuda_device).eval()
    card.load_state_dict(cpu.state_dict())
    r = np.random.default_rng(c + s)
    x, g = _normal(r, (2, side, side, c)), _normal(r, (2, side, side, c), 0.5)
    wide = WIDTH_ROUTES[c][[256, 64, 16].index(s)] == "w"
    assert card.route(s).entry == ("wide" if wide else "proj")
    x_card = x.to(cuda_device).requires_grad_()
    x_cpu = x.clone().requires_grad_()
    kernels.reset_launch_counts()
    out = card(x_card)
    out.backward(g.to(cuda_device))
    counts = kernels.launch_counts()
    want = cpu(x_cpu)
    want.backward(g)
    lanes = int(c == 512)
    # either route runs the projection twice (the backward recomputes it)
    # and the long entry's key-tiled kernels after and between the GEMMs;
    # the proj entry counts its own calls too
    proj = {} if wide else {"fused_attention_proj": 1,
                            "fused_attention_proj_bwd": 1}
    assert counts == {**dict.fromkeys(counts, 0), "fused_attention_long": 1,
                      "fused_attention_long_bwd": 1, "attention_qkv_gemm": 2,
                      "attention_dseq_gemm": 1, "attention_dw_gemm": 1,
                      "attention_lanes": lanes, "attention_lanes_bwd": lanes,
                      **proj}
    _close(out, want, rtol=1e-4, atol=1e-5)
    assert _rel_max(x_card.grad.cpu(), x_cpu.grad) <= 1e-4
    for (name, p_card), p_cpu in zip(card.named_parameters(),
                                     cpu.parameters()):
        assert _rel_max(p_card.grad.cpu(), p_cpu.grad) <= 1e-4, name


# -- the proj forward and backward as stages, and the GEMM's split K -------------
# (batch, C, S): the flagship's 32-px levels and the proj route's Dh = 48
PROJ_BWD_SHAPES = [(64, 96, 256), (64, 96, 64), (64, 96, 16), (64, 192, 64)]
PROJ_BWD_COUNTS = {"fused_attention_proj_bwd": 1, "attention_qkv_gemm": 1,
                   "fused_attention_long_bwd": 1, "attention_dseq_gemm": 1,
                   "attention_dw_gemm": 1}
PROJ_FWD_COUNTS = {"fused_attention_proj": 1, "attention_qkv_gemm": 1,
                   "fused_attention_long": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("batch,c,s", PROJ_BWD_SHAPES)
def test_proj_fwd_at_the_path_shapes_matches_plain_on_card(cuda_device, batch,
                                                           c, s, rate):
    """The full batch of the paths, one seed for the stages and the plain
    version (the same mask): out within 1e-5 absolute (the proj bar), two
    calls bit for bit, and each call launches the entry and each stage
    once (`PROJ_FWD_COUNTS`: the qkv GEMM and the tensor-core forward),
    nothing else."""
    seq, w, _, seed = _attention_inputs(cuda_device, s, batch, c, seed=c + s)
    kernels.reset_launch_counts()
    got = kernels.fused_attention_proj(seq, w, 4, rate, seed)
    counts = kernels.launch_counts()
    assert counts == {**dict.fromkeys(counts, 0), **PROJ_FWD_COUNTS}
    assert torch.isfinite(got).all()
    _close(got, kernels.attention_proj_plain(seq, w, 4, rate, seed), rtol=0,
           atol=1e-5)
    assert torch.equal(got, kernels.fused_attention_proj(seq, w, 4, rate,
                                                         seed))


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_proj_autograd_matches_plain_forward_and_backward_on_card(cuda_device,
                                                                  rate):
    """fused_attention_proj through autograd at the flagship's level 0
    (batch 8, S 256, C 96): out and the gradients of seq and w against the
    plain forward and backward at the same seed. The backward regenerates
    the mask from the seed, so a forward that dropped other scores than
    its backward would miss one of the two bars."""
    seq, w, g, seed = _attention_inputs(cuda_device, 256, batch=8)
    seq_r, w_r = seq.clone().requires_grad_(), w.clone().requires_grad_()
    kernels.reset_launch_counts()
    out = kernels.fused_attention_proj(seq_r, w_r, 4, rate, seed)
    out.backward(g)
    counts = kernels.launch_counts()
    assert counts == {**dict.fromkeys(counts, 0), **PROJ_BWD_COUNTS,
                      **PROJ_FWD_COUNTS, "attention_qkv_gemm": 2}
    _close(out, kernels.attention_proj_plain(seq, w, 4, rate, seed), rtol=0,
           atol=1e-5)
    want = kernels.attention_proj_plain_bwd(seq, w, g, 4, rate, seed)
    assert _rel_max(seq_r.grad, want[0]) <= 1e-4
    assert _rel_max(w_r.grad, want[1]) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("batch,c,s", PROJ_BWD_SHAPES)
def test_proj_bwd_at_the_path_shapes_matches_plain_on_card(cuda_device, batch,
                                                           c, s, rate):
    """The full batch of the paths, one seed for kernels and plain version
    (the same mask): dseq and dW within 1e-4 of the largest |plain| (dW sums
    B S = 1024-16384 rows in another order; chip_smoke's bar at these
    shapes), two calls bit for bit, and each call launches the entry and
    each stage once (`PROJ_BWD_COUNTS`), nothing else."""
    seq, w, g, seed = _attention_inputs(cuda_device, s, batch, c, seed=c + s)
    kernels.reset_launch_counts()
    got = kernels.fused_attention_proj_bwd(seq, w, g, 4, rate, seed)
    counts = kernels.launch_counts()
    assert counts == {**dict.fromkeys(counts, 0), **PROJ_BWD_COUNTS}
    again = kernels.fused_attention_proj_bwd(seq, w, g, 4, rate, seed)
    want = kernels.attention_proj_plain_bwd(seq, w, g, 4, rate, seed)
    for x, y, z in zip(got, again, want):
        assert torch.isfinite(x).all()
        assert _rel_max(x, z) <= 1e-4
        assert torch.equal(x, y)


# (m, n, K) products that few output tiles walk: dW at C = 96 over B S =
# 1024 / 4096 / 16384 rows, and dseq at C = 512, B = 16, S = 16
SPLIT_GEMMS = [("dw", 96, 16, 64), ("dw", 96, 64, 64), ("dw", 96, 256, 64),
               ("dseq", 512, 16, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("product,c,s,batch", SPLIT_GEMMS)
def test_split_gemms_match_matmul_on_card(cuda_device, product, c, s, batch):
    """Where `gemm_splits` cuts K, the GEMM against torch.matmul within
    1e-5 of the largest magnitude (the bar of the unsplit GEMMs), two calls
    bit for bit (the splits summed in a fixed order, no atomics)."""
    seq, w, _, _ = _attention_inputs(cuda_device, s, batch, c, seed=s + c)
    dqkv = _normal(np.random.default_rng(c + s), (batch, s, 3 * c)).to(
        cuda_device)
    rows = batch * s
    if product == "dw":
        fn, a, b, mnk = kernels.attention_dw_gemm, dqkv, seq, (3 * c, c, rows)
        want = torch.einsum("bso,bsc->oc", dqkv, seq)
    else:
        fn, a, b, mnk = kernels.attention_dseq_gemm, dqkv, w, (rows, c, 3 * c)
        want = torch.matmul(dqkv, w)
    assert fa.gemm_splits(*mnk) > 1
    got = fn(a, b)
    assert _rel_max(got, want) <= 1e-5
    assert torch.equal(got, fn(a, b))


class NoLibraryProducts(TorchFunctionMode):
    """Raises on every PyTorch product and attention call."""

    banned = {"matmul", "mm", "bmm", "einsum", "linear",
              "scaled_dot_product_attention", "__matmul__", "__rmatmul__",
              "addmm", "baddbmm"}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") in self.banned:
            raise AssertionError(f"library call {func.__name__}")
        return func(*args, **(kwargs or {}))


@pytest.mark.cuda
def test_proj_fwd_runs_no_library_product_on_card(cuda_device):
    """The proj forward on the card at the flagship's level 1, rate 0.2,
    under a mode that raises on every PyTorch product and attention call:
    it runs the qkv GEMM kernel and the tensor-core forward, nothing
    else."""
    seq, w, _, seed = _attention_inputs(cuda_device, 64, 8)
    kernels.reset_launch_counts()
    with NoLibraryProducts():
        out = kernels.fused_attention_proj(seq, w, 4, 0.2, seed)
        with pytest.raises(AssertionError, match="library call"):
            torch.matmul(seq, w.t())  # the mode is in effect
    counts = kernels.launch_counts()
    assert counts == {**dict.fromkeys(counts, 0), **PROJ_FWD_COUNTS}
    _close(out, kernels.attention_proj_plain(seq, w, 4, 0.2, seed), rtol=0,
           atol=1e-5)


@pytest.mark.cuda
def test_proj_bwd_runs_no_library_product_on_card(cuda_device):
    """The proj backward on the card at the flagship's level 1, and the
    backward at Dh = 128 (the wide route's whole backward at the CLIs' C =
    512 and the core entry on split heads: the tensor-core kernels), rate
    0.2, under a TorchFunctionMode that raises on every PyTorch product and
    attention call: they run this repo's kernels only."""
    seq, w, g, seed = _attention_inputs(cuda_device, 64, 8)
    wide = _attention_inputs(cuda_device, 64, 2, c=512)
    q, k, v, gh, _, _, core_seed = _core_inputs(cuda_device, (2, 4, 64, 128))
    lanes = kernels.attention_lanes_bwd.launches
    with NoLibraryProducts():
        dseq, dw = kernels.fused_attention_proj_bwd(seq, w, g, 4, 0.2, seed)
        wide_grads = kernels.fused_attention_long_bwd(*wide[:3], 4, 0.2,
                                                      wide[3])
        core_grads = kernels.fused_attention_bwd(q, k, v, gh, 0.2, core_seed)
        with pytest.raises(AssertionError, match="library call"):
            torch.matmul(seq, w.t())  # the mode is in effect
    assert kernels.attention_lanes_bwd.launches == lanes + 2
    want = kernels.attention_proj_plain_bwd(seq, w, g, 4, 0.2, seed)
    assert _rel_max(dseq, want[0]) <= 1e-4
    assert _rel_max(dw, want[1]) <= 1e-4
    want = kernels.attention_proj_plain_bwd(*wide[:3], 4, 0.2, wide[3])
    for got, plain in zip(wide_grads, want):
        assert _rel_max(got, plain) <= 1e-4
    want = kernels.attention_plain_bwd(q, k, v, gh, 0.2, core_seed)
    for got, plain in zip(core_grads, want):
        assert _rel_max(got, plain) <= 1e-4


# -- bf16 serving: the qkv GEMM and the attention forward in bf16 -------------------
def _bf16(t):
    return t.to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,s,c", [(64, 256, 96), (64, 64, 96),
                                       (64, 16, 96), (16, 256, 512),
                                       (3, 37, 96), (2, 33, 20)])
def test_bf16_qkv_gemm_matches_plain_on_card(cuda_device, batch, s, c):
    """The bf16 GEMM at the flagship's three levels (tiles 128 x 96), the
    CLIs' C 512 (128 x 128), a ragged M (TMA's zero fill), all on the TMA +
    wgmma kernel, and a K (20) that is not a multiple of 8 (the unaligned
    route's one-value copies): within one bf16 ulp of `bf16_matmul` (plus
    the float32 sums' spread, `bf16_product_close`), two calls bit for bit,
    one launch counted on the entry and on the bf16 kernel, and on the
    unaligned route's count only at C 20."""
    r = np.random.default_rng(30)
    seq = _bf16(_normal(r, (batch, s, c), 0.5)).to(cuda_device)
    w = _bf16(_normal(r, (3 * c, c), 0.1)).to(cuda_device)
    before = (kernels.attention_qkv_gemm.launches,
              kernels.attention_qkv_gemm_bf16.launches,
              kernels.attention_gemm_bf16_unaligned.launches)
    got = kernels.attention_qkv_gemm(seq, w)
    assert (kernels.attention_qkv_gemm.launches,
            kernels.attention_qkv_gemm_bf16.launches,
            kernels.attention_gemm_bf16_unaligned.launches) == (
                before[0] + 1, before[1] + 1, before[2] + (c % 8 != 0))
    assert got.dtype == torch.bfloat16 and got.shape == (batch, s, 3 * c)
    assert torch.equal(got, kernels.attention_qkv_gemm(seq, w))
    assert fa.bf16_product_close(got, fa.bf16_matmul(seq, w.t()), seq, w)


@pytest.mark.cuda
def test_bf16_qkv_gemm_takes_unaligned_operands_on_card(cuda_device):
    """An operand that starts off a 16-byte boundary, which TMA cannot
    take, goes to the unaligned route (the kernel's one-value copies, one
    launch on its count): within the bar of the plain version, two calls
    bit for bit; the aligned call stays on the TMA + wgmma kernel."""
    r = np.random.default_rng(31)
    seq = _bf16(_normal(r, (4, 64, 96), 0.5)).to(cuda_device)
    w = _bf16(_normal(r, (288, 96), 0.1)).to(cuda_device)
    before = kernels.attention_gemm_bf16_unaligned.launches
    want = kernels.attention_qkv_gemm(seq, w)
    assert kernels.attention_gemm_bf16_unaligned.launches == before
    shifted = torch.empty(seq.numel() + 1, dtype=torch.bfloat16,
                          device=cuda_device)[1:].view_as(seq).copy_(seq)
    assert shifted.data_ptr() % 16
    got = kernels.attention_qkv_gemm(shifted, w)
    assert kernels.attention_gemm_bf16_unaligned.launches == before + 1
    assert torch.equal(got, kernels.attention_qkv_gemm(shifted, w))
    assert fa.bf16_product_close(got, want, seq, w)
    assert fa.bf16_product_close(got, fa.bf16_matmul(seq, w.t()), seq, w)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("batch,s,c", [(64, 256, 96), (64, 64, 96),
                                       (64, 16, 96), (4, 1024, 96),
                                       (16, 256, 512), (3, 100, 96),
                                       (2, 70, 512), (4, 256, 1024),
                                       (2, 40, 1024)])
def test_bf16_forward_matches_plain_on_card(cuda_device, batch, s, c, rate):
    """The bf16 forward on TMA + wgmma at Dh 24 (the flagship's levels, the
    64-px level 0, a ragged S), Dh 128 (the CLIs' C 512, a ragged S) and
    Dh 256 (C 1024, a ragged S), one seed for both (the same mask): within
    2^-7 max|v| of `attention_long_plain` (the kernel rounds the
    unnormalised P, the plain version the normalised one, each within
    2^-9), its (m, 1/l) within 1e-4 of `attention_stats_plain` (m
    absolute, 1/l relative), two calls bit for bit, out the same bits with
    and without the statistics' store, one device launch a call (a CUDA
    graph), one launch counted on the entry and on the bf16 kernel."""
    from gpnf_tpu_torch.utils.cuda_timing import graph_launches

    r = np.random.default_rng(32)
    qkv = _bf16(_normal(r, (batch, s, 3 * c))).to(cuda_device)
    seed = torch.tensor([9], dtype=torch.int32, device=cuda_device)
    before = kernels.attention_fwd_bf16.launches
    got = kernels.attention_long_qkv(qkv, 4, rate, seed)
    assert kernels.attention_fwd_bf16.launches == before + 1
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, kernels.attention_long_qkv(qkv, 4, rate, seed))
    want = kernels.attention_long_plain(qkv, 4, rate, seed)
    bar = 2.0 ** -7 * float(qkv[..., c:2 * c].float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= bar
    out, stats = kernels.attention_long_qkv(qkv, 4, rate, seed,
                                            with_stats=True)
    assert torch.equal(out, got)
    plain = fa.attention_stats_plain(qkv, 4)
    assert float((stats[..., 0] - plain[..., 0]).abs().max()) <= 1e-4
    assert float(((stats[..., 1] - plain[..., 1]) / plain[..., 1]).abs()
                 .max()) <= 1e-4
    assert graph_launches(
        lambda: kernels.attention_long_qkv(qkv, 4, rate, seed)) == 1


@pytest.mark.cuda
def test_bf16_forward_takes_unaligned_operands_on_card(cuda_device):
    """A bf16 qkv that starts off a 16-byte boundary is copied aligned by
    the wrapper before the kernel's TMA loads (a tensor map's base is
    16-byte aligned): the aligned call's bits, one launch counted."""
    r = np.random.default_rng(36)
    qkv = _bf16(_normal(r, (2, 64, 288))).to(cuda_device)
    seed = torch.tensor([3], dtype=torch.int32, device=cuda_device)
    want = kernels.attention_long_qkv(qkv, 4, 0.2, seed)
    shifted = torch.empty(qkv.numel() + 1, dtype=torch.bfloat16,
                          device=cuda_device)[1:].view_as(qkv).copy_(qkv)
    assert shifted.data_ptr() % 16
    before = kernels.attention_fwd_bf16.launches
    assert torch.equal(kernels.attention_long_qkv(shifted, 4, 0.2, seed),
                       want)
    assert kernels.attention_fwd_bf16.launches == before + 1


@pytest.mark.cuda
def test_bf16_proj_forward_launches_the_bf16_kernels(cuda_device):
    """A bf16 proj forward (the flagship's level 1, rate 0.2) runs the bf16
    qkv GEMM and the bf16 forward, one launch each, and no float32 or
    library product: the plain proj forward's values within the forward's
    bar."""
    r = np.random.default_rng(33)
    seq = _bf16(_normal(r, (8, 64, 96), 0.5)).to(cuda_device)
    w = _bf16(_normal(r, (288, 96), 0.1)).to(cuda_device)
    seed = torch.tensor([4], dtype=torch.int32, device=cuda_device)
    kernels.reset_launch_counts()
    with NoLibraryProducts():
        out = kernels.fused_attention_proj(seq, w, 4, 0.2, seed)
    counts = kernels.launch_counts()
    assert counts == {**dict.fromkeys(counts, 0), **PROJ_FWD_COUNTS,
                      "attention_qkv_gemm_bf16": 1, "attention_fwd_bf16": 1}
    want = kernels.attention_proj_plain(seq, w, 4, 0.2, seed)
    qkv = fa.bf16_matmul(seq, w.t())
    bar = 2.0 ** -7 * float(qkv[..., 96:192].float().abs().max())
    assert float((out.float() - want.float()).abs().max()) <= 2 * bar


@pytest.mark.cuda
def test_bf16_refusals_name_the_kernel_and_the_limit(cuda_device):
    """No fallback: what the bf16 kernels do not take raises before any
    launch: a head width above 256 (on the card as on the CPU), mixed bf16
    / float32 operands (the proj entry, the GEMMs, the backward, the fused
    gated conv's forward and backward, the core entries)."""
    r = np.random.default_rng(34)
    seq = _bf16(_normal(r, (2, 64, 96), 0.5)).to(cuda_device)
    w = _bf16(_normal(r, (288, 96), 0.1)).to(cuda_device)
    g = _bf16(_normal(r, (2, 64, 96))).to(cuda_device)
    dqkv = _bf16(_normal(r, (2, 64, 288))).to(cuda_device)
    kernels.reset_launch_counts()
    wide = _bf16(_normal(r, (2, 64, 3 * 4 * 264))).to(cuda_device)  # Dh 264
    with pytest.raises(ValueError, match="264 not in"):
        kernels.attention_long_qkv(wide, 4)
    with pytest.raises(ValueError, match="264 not in"):
        kernels.attention_long_qkv_bwd(wide, wide[..., :4 * 264], 4)
    with pytest.raises(ValueError, match="264 > 256"):
        kernels.attention_route(64, 4 * 264, 4)
    for call in (lambda: kernels.fused_attention_proj(seq, w.float(), 4),
                 lambda: kernels.fused_attention_proj_bwd(seq, w, g.float(),
                                                          4),
                 lambda: kernels.attention_long_qkv_bwd(dqkv, g.float(), 4),
                 lambda: kernels.attention_qkv_gemm(seq, w.float()),
                 lambda: kernels.attention_dseq_gemm(dqkv, w.float()),
                 lambda: kernels.attention_dw_gemm(dqkv.float(), seq)):
        with pytest.raises(TypeError, match="dtype"):
            call()
    q = _bf16(_normal(r, (2, 4, 64, 24))).to(cuda_device)
    with pytest.raises(TypeError, match="fused_attention.*dtype"):
        kernels.fused_attention(q, q.float(), q)
    with pytest.raises(TypeError, match="fused_attention_qkv_bwd.*dtype"):
        kernels.fused_attention_qkv_bwd(dqkv, g.float(), 4)
    x, w1, b1, wg, bg, g = (_bf16(t_).to(cuda_device) for t_ in
                            _gated_conv_inputs("cpu", 16, 8, 8))
    for call in (lambda: kernels.fused_gated_conv(x, w1.float(), b1, wg, bg),
                 lambda: kernels.fused_gated_conv(x, w1, b1, wg, bg.float()),
                 lambda: kernels.fused_gated_conv_bwd(x, w1, b1, wg, bg,
                                                      g.float())):
        with pytest.raises(TypeError, match="fused_gated_conv.*dtype"):
            call()
    counts = kernels.launch_counts()
    assert counts == dict.fromkeys(counts, 0)


class NoUpcast(TorchFunctionMode):
    """Raises where a bf16 tensor is converted to float32 or float64: a
    bf16 attention entry that detoured through the float32 kernels would
    (the model itself upcasts by design: the weight norm of its bf16
    layers is float32, as the JAX package's)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (getattr(func, "__name__", "") in ("float", "double", "to", "type")
                and isinstance(args[0], torch.Tensor)
                and args[0].dtype == torch.bfloat16
                and isinstance(out, torch.Tensor)
                and out.dtype in (torch.float32, torch.float64)):
            raise AssertionError(f"bf16 upcast by {func.__name__}")
        return out


@pytest.mark.cuda
def test_bf16_model_trains_on_card(cuda_device):
    """A small bf16 mAR-SCF (C 96, Dh 24) on the card: encode bits/dim and
    one training step at dropout 0 against the port on the CPU on the same
    weights, the loss within the larger of 1e-3 and half of the CPU's
    bf16-vs-float32 gap; every gradient float32, finite and within its own
    bar (grad_parity: the larger of 1e-3 of its largest float32 value and
    3 times its CPU bf16 noise, from the CPU's float32 step and two CPU
    bf16 steps on weights moved by 2^-22), and the whole gradient's L2
    distance from the CPU's float32 at most 1.5 times the CPU bf16's; a
    training step with dropout launches the bf16 backward kernels for
    every attention call and no float32 attention or GEMM kernel, and no
    bf16 GEMM call takes the unaligned route."""
    small = dict(SMALL, hidden_channels=96, drop_prob=0.0)
    cfg = dict(small, compute_dtype="bfloat16")
    unaligned = kernels.attention_gemm_bf16_unaligned.launches
    cpu = MarScfFlow(MarScfConfig(**cfg), device="cpu").eval()
    card = MarScfFlow(MarScfConfig(**cfg), device=cuda_device).eval()
    card.load_state_dict(cpu.state_dict())
    f32 = MarScfFlow(MarScfConfig(**small), device="cpu").eval()
    f32.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.default_rng(35).random(
        (2, 3, 16, 16), dtype=np.float32) - 0.5)
    noise = torch.full_like(x, 0.5)
    with torch.no_grad():
        want = cpu(x, noise=noise)[1]
        gap = float((want - f32(x, noise=noise)[1]).abs().max())
        got = card(x.to(cuda_device), noise=noise.to(cuda_device))[1].cpu()
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= max(1e-3, 0.5 * gap)
    moved = []
    for seed in (1, 2):
        net = MarScfFlow(MarScfConfig(**cfg), device="cpu")
        net.load_state_dict(grad_parity.perturbed(cpu, seed))
        moved.append(net)
    losses, grads = [], []  # dropout 0: one function on the card and CPU
    for net, dev in ((cpu, "cpu"), (f32, "cpu"), (card, cuda_device),
                     *((net, "cpu") for net in moved)):
        net.train()
        loss = net(x.to(dev), noise=noise.to(dev))[1].mean()
        loss.backward()
        losses.append(float(loss.detach()))
        grads.append({k: p.grad.detach().cpu()
                      for k, p in net.named_parameters()})
    assert abs(losses[2] - losses[0]) <= max(1e-3, 0.5 * abs(
        losses[0] - losses[1]))
    for p in card.parameters():
        assert p.grad.dtype == torch.float32 and torch.isfinite(
            p.grad).all()
    c16, c32, got = grads[:3]
    rows = grad_parity.bf16_grad_parity(got, c16, c32, grads[3:])
    assert len(rows) == len(list(card.parameters())) and rows[0][0] <= 1.0, (
        rows[:4])
    l2 = lambda g: sum(float(((g[k] - c32[k]) ** 2).sum()) for k in c32)
    assert l2(got) <= 1.5 ** 2 * l2(c16), (l2(got), l2(c16))
    train = MarScfFlow(MarScfConfig(**dict(cfg, drop_prob=0.2)),
                       device=cuda_device).train()
    train.load_state_dict(cpu.state_dict())
    kernels.reset_launch_counts()
    loss = train(x.to(cuda_device), generator=torch.Generator(
        device=cuda_device).manual_seed(1))[1].mean()
    loss.backward()
    counts = kernels.launch_counts()
    n = counts["attention_fwd_bf16"]
    assert n > 0 and counts["attention_bwd_bf16"] == n
    assert counts["attention_qkv_gemm_bf16"] == counts[
        "attention_qkv_gemm"] == 2 * n
    for name in ("dseq", "dw"):
        assert counts[f"attention_{name}_gemm_bf16"] == counts[
            f"attention_{name}_gemm"] == n
    assert counts["fused_attention_long_bwd"] == n
    assert counts["attention_lanes"] == counts["attention_lanes_bwd"] == 0
    assert kernels.attention_gemm_bf16_unaligned.launches == unaligned


@pytest.mark.cuda
def test_bf16_kernels_run_bf16_on_the_tensor_cores(cuda_device):
    """The bf16 GEMM's unaligned route (every tile and layout) and the dq
    and dK/dV kernels (Dh 24, 128 and 256, with and without dropout) hold
    bf16 HMMA instructions (HMMA.16816.F32.BF16) in their SASS; the bf16
    forward (Dh 24, 128 and 256, with and without dropout and the
    statistics' store) bf16 warpgroup products (HGMMA ... BF16) and TMA
    loads (UTMALDG)."""
    import os
    import shutil

    from gpnf_tpu_torch.bench_mixture import sass_counts
    from gpnf_tpu_torch.ops.kernels import _native

    if not os.path.exists(shutil.which("cuobjdump")
                          or "/usr/local/cuda/bin/cuobjdump"):
        pytest.skip("no cuobjdump in the CUDA toolkit: the SASS cannot be "
                    "read here")
    _native.build(["fused_attention_long"])
    fwd = {fn: row for fn, row in sass_counts(_native.library_path(
        "fused_attention_long")).items() if "attention_wgmma_fwd_kernel" in fn}
    assert len(fwd) == 12 and all(
        any("BF16" in op for op in row["hgmma_ops"])
        and row["tma_ops"].get("UTMALDG", 0) for row in fwd.values()), fwd
    for source, pattern, n in (("attention_gemm", "gemm_bf16_kernel", 6),
                               ("fused_attention_long",
                                "attention_bf16_dq_kernel", 6),
                               ("fused_attention_long",
                                "attention_bf16_dkv_kernel", 6)):
        _native.build([source])
        hmma = {fn: row["hmma_ops"].get("HMMA.16816.F32.BF16", 0)
                for fn, row in sass_counts(
                    _native.library_path(source)).items() if pattern in fn}
        assert len(hmma) == n and all(v > 0 for v in hmma.values()), hmma


# -- bf16 training: the dq and dK/dV pair, dseq and dW in bf16 ---------------------
def _bwd_thirds_err(got, want, c):
    """max |got - want| / max |want| of each third of dqkv (dK, dV, dq)."""
    return [float((got[..., i * c:(i + 1) * c].float()
                   - want[..., i * c:(i + 1) * c].float()).abs().max()
                  / want[..., i * c:(i + 1) * c].float().abs().max())
            for i in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("batch,s,c,in_fp32", [
    (64, 256, 96, True), (64, 64, 96, True), (64, 16, 96, True),
    (4, 1024, 96, False), (16, 256, 512, False), (3, 100, 96, False),
    (2, 70, 512, True), (2, 40, 1024, False)])
def test_bf16_backward_matches_plain_on_card(cuda_device, batch, s, c,
                                             in_fp32, rate):
    """The bf16 dq and dK/dV pair at Dh 24 (the flagship's levels with the
    proj entry's dq, the 64-px level 0, a ragged S), 128 (the CLIs' C 512,
    a ragged S) and 256, one seed for kernel and plain version (the same
    mask): each of dK, dV and dq within 2^-7 of its largest |plain| (the
    forward's bar: the kernels round the same values, summed in another
    order), two calls bit for bit, one launch counted."""
    r = np.random.default_rng(40)
    qkv = _bf16(_normal(r, (batch, s, 3 * c))).to(cuda_device)
    g = _bf16(_normal(r, (batch, s, c), 0.5)).to(cuda_device)
    seed = torch.tensor([12], dtype=torch.int32, device=cuda_device)
    run = lambda: kernels.attention_long_qkv_bwd(qkv, g, 4, rate, seed,
                                                 scale_dq_in_fp32=in_fp32)
    before = kernels.attention_bwd_bf16.launches
    got = run()
    assert kernels.attention_bwd_bf16.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == qkv.shape
    assert torch.equal(got, run())
    want = kernels.attention_long_plain_bwd(qkv, g, 4, rate, seed, None,
                                            in_fp32)
    assert max(_bwd_thirds_err(got, want, c)) <= 2.0 ** -7


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("batch,s,c", [(64, 256, 96), (4, 1024, 96),
                                       (16, 256, 512), (3, 100, 96),
                                       (2, 40, 1024)])
def test_bf16_backward_from_the_forward_statistics_on_card(cuda_device, batch,
                                                           s, c, rate):
    """Training's pair: the forward with its statistics' store gives out
    bit for bit as without it, and (m, 1/l) within 1e-4 of
    `attention_stats_plain` (m absolute, 1/l relative); the backward given
    them is 2 device launches (the dq and dK/dV kernels) and the same bits
    as the backward that runs the forward first for them (3 launches)."""
    from gpnf_tpu_torch.utils.cuda_timing import graph_launches

    r = np.random.default_rng(45)
    qkv = _bf16(_normal(r, (batch, s, 3 * c))).to(cuda_device)
    g = _bf16(_normal(r, (batch, s, c), 0.5)).to(cuda_device)
    seed = torch.tensor([6], dtype=torch.int32, device=cuda_device)
    out, stats = kernels.attention_long_qkv(qkv, 4, rate, seed,
                                            with_stats=True)
    assert torch.equal(out, kernels.attention_long_qkv(qkv, 4, rate, seed))
    assert stats.shape == (batch, 4, s, 2) and stats.dtype == torch.float32
    plain = fa.attention_stats_plain(qkv, 4)
    assert float((stats[..., 0] - plain[..., 0]).abs().max()) <= 1e-4
    assert float(((stats[..., 1] - plain[..., 1]) / plain[..., 1]).abs()
                 .max()) <= 1e-4
    given = lambda: kernels.attention_long_qkv_bwd(qkv, g, 4, rate, seed,
                                                   stats=stats)
    alone = lambda: kernels.attention_long_qkv_bwd(qkv, g, 4, rate, seed)
    assert torch.equal(given(), alone())
    assert (graph_launches(given), graph_launches(alone)) == (2, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [4, 8, 16, 32, 48, 64, 256])
def test_bf16_every_width_trains_on_card(cuda_device, dh):
    """Every head width in HEAD_DIMS that is not built in bf16 runs padded
    (Dh 4, 8, 16 to 24; 32, 48, 64 to 128), and 256 as it is: the long
    entry's forward and backward through autograd (rate 0.2, one seed)
    against the plain versions on the card, the forward within 2^-7 max |v|
    of the projection, the gradients dseq and dW within 2^-7 of their
    largest |plain|; the bf16 kernels launched, once each."""
    r = np.random.default_rng(41 + dh)
    c = 4 * dh
    seq = _bf16(_normal(r, (3, 40, c), 0.5)).to(cuda_device)
    w = _bf16(_normal(r, (3 * c, c), 0.1)).to(cuda_device)
    g = _bf16(_normal(r, (3, 40, c), 0.5)).to(cuda_device)
    seed = torch.tensor([8], dtype=torch.int32, device=cuda_device)
    kernels.reset_launch_counts()
    seq_t, w_t = seq.clone().requires_grad_(), w.clone().requires_grad_()
    out = kernels.fused_attention_long(seq_t, w_t, 4, 0.2, seed)
    out.backward(g)
    counts = kernels.launch_counts()
    assert (counts["attention_fwd_bf16"], counts["attention_bwd_bf16"],
            counts["attention_dseq_gemm_bf16"],
            counts["attention_dw_gemm_bf16"]) == (1, 1, 1, 1)
    pad = fa.padded_head_dim(dh)
    want = fa._unpad_heads(kernels.attention_long_plain(
        fa._pad_heads(fa.qkv_plain(seq, w), dh, pad), 4, 0.2, seed,
        None if pad == dh else dh ** -0.5), dh, pad)
    bar = 2.0 ** -7 * float(fa.qkv_plain(seq, w)[..., c:2 * c].float()
                            .abs().max())
    assert float((out.float() - want.float()).abs().max()) <= bar
    dqkv = fa._unpad_heads(kernels.attention_long_plain_bwd(
        fa._pad_heads(fa.qkv_plain(seq, w), dh, pad),
        fa._pad_heads(g, dh, pad), 4, 0.2, seed,
        None if pad == dh else dh ** -0.5), dh, pad)
    dseq, dw = fa._project_bwd(dqkv, seq, w)
    for got, plain in ((seq_t.grad, dseq), (w_t.grad, dw)):
        assert got.dtype == torch.bfloat16
        assert float((got.float() - plain.float()).abs().max()) <= \
            2.0 ** -7 * float(plain.float().abs().max())


@pytest.mark.cuda
def test_bf16_backward_takes_unaligned_operands_on_card(cuda_device):
    """A bf16 qkv and g that start off a 16-byte boundary are copied
    aligned by the wrapper before the kernels' cp.async loads: the aligned
    call's bits, one launch counted."""
    r = np.random.default_rng(42)
    qkv = _bf16(_normal(r, (2, 64, 288))).to(cuda_device)
    g = _bf16(_normal(r, (2, 64, 96))).to(cuda_device)
    seed = torch.tensor([3], dtype=torch.int32, device=cuda_device)
    want = kernels.attention_long_qkv_bwd(qkv, g, 4, 0.2, seed)
    shift = lambda t: torch.empty(t.numel() + 1, dtype=torch.bfloat16,
                                  device=cuda_device)[1:].view_as(t).copy_(t)
    sq, sg = shift(qkv), shift(g)
    assert sq.data_ptr() % 16 and sg.data_ptr() % 16
    before = kernels.attention_bwd_bf16.launches
    assert torch.equal(kernels.attention_long_qkv_bwd(sq, sg, 4, 0.2, seed),
                       want)
    assert kernels.attention_bwd_bf16.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("batch,s,c", [(64, 256, 96), (64, 64, 96),
                                       (64, 16, 96), (16, 256, 512),
                                       (3, 37, 96), (2, 33, 20)])
def test_bf16_dseq_and_dw_gemms_match_plain_on_card(cuda_device, batch, s,
                                                    c):
    """dseq = dqkv w (bf16, one bf16 ulp plus the float32 sums' spread of
    `bf16_matmul`) and dW = dqkv^T seq (float32, within the spread of two
    orders of its float32 sums of `dw_plain`) at the flagship's levels (dW
    split along B S inside its one launch), the CLIs' C 512, a ragged M
    and N on the TMA + wgmma kernel, and a C (20) that is not a multiple of
    8 (the unaligned route's one-value copies); two calls bit for bit; one
    launch counted on each entry and its bf16 kernel; an operand off a
    16-byte boundary goes to the unaligned route, within the same bars."""
    r = np.random.default_rng(43)
    seq = _bf16(_normal(r, (batch, s, c), 0.5)).to(cuda_device)
    w = _bf16(_normal(r, (3 * c, c), 0.1)).to(cuda_device)
    dqkv = _bf16(_normal(r, (batch, s, 3 * c), 0.1)).to(cuda_device)
    before = (kernels.attention_dseq_gemm_bf16.launches,
              kernels.attention_dw_gemm_bf16.launches,
              kernels.attention_gemm_bf16_unaligned.launches)
    dseq = kernels.attention_dseq_gemm(dqkv, w)
    dw = kernels.attention_dw_gemm(dqkv, seq)
    assert (kernels.attention_dseq_gemm_bf16.launches,
            kernels.attention_dw_gemm_bf16.launches,
            kernels.attention_gemm_bf16_unaligned.launches) == (
                before[0] + 1, before[1] + 1, before[2] + 2 * (c % 8 != 0))
    assert dseq.dtype == torch.bfloat16 and dw.dtype == torch.float32
    assert torch.equal(dseq, kernels.attention_dseq_gemm(dqkv, w))
    assert torch.equal(dw, kernels.attention_dw_gemm(dqkv, seq))
    d2, s2 = dqkv.reshape(-1, 3 * c), seq.reshape(-1, c)
    assert fa.bf16_product_close(dseq, fa.bf16_matmul(dqkv, w), d2, w.t())
    spread = batch * s * 2.0 ** -24 * (d2.float().abs().t()
                                       @ s2.float().abs())
    assert bool(((dw - fa.dw_plain(dqkv, seq)).abs() <= spread).all())
    shifted = torch.empty(dqkv.numel() + 1, dtype=torch.bfloat16,
                          device=cuda_device)[1:].view_as(dqkv).copy_(dqkv)
    unaligned = kernels.attention_gemm_bf16_unaligned.launches
    got = kernels.attention_dseq_gemm(shifted, w)
    assert fa.bf16_product_close(got, fa.bf16_matmul(dqkv, w), d2, w.t())
    got = kernels.attention_dw_gemm(shifted, seq)
    assert bool(((got - fa.dw_plain(dqkv, seq)).abs() <= spread).all())
    assert kernels.attention_gemm_bf16_unaligned.launches == unaligned + 2


@pytest.mark.cuda
def test_wgmma_gemm_runs_hgmma_and_tma_on_card(cuda_device):
    """Every instantiation of the bf16 GEMM's TMA + wgmma kernel (three
    layouts, tiles 96 and 128 wide, bf16 and float32 c, clusters of 8 and
    2 for split K) holds bf16
    warpgroup products (HGMMA ... BF16) and TMA loads and stores (UTMALDG,
    UTMASTG) in its SASS, and no mma.sync (HMMA)."""
    import os
    import shutil

    from gpnf_tpu_torch.bench_mixture import sass_counts
    from gpnf_tpu_torch.ops.kernels import _native

    if not os.path.exists(shutil.which("cuobjdump")
                          or "/usr/local/cuda/bin/cuobjdump"):
        pytest.skip("no cuobjdump in the CUDA toolkit: the SASS cannot be "
                    "read here")
    _native.build(["attention_gemm"])
    rows = {fn: row for fn, row in sass_counts(
        _native.library_path("attention_gemm")).items()
        if "gemm_wgmma_bf16_kernel" in fn}
    assert len(rows) == 24, sorted(rows)
    for fn, row in rows.items():
        assert any(op.startswith("HGMMA.") and "BF16" in op
                   for op in row["hgmma_ops"]), (fn, row["hgmma_ops"])
        assert row["tma_ops"].get("UTMALDG", 0) > 0, (fn, row["tma_ops"])
        assert row["tma_ops"].get("UTMASTG", 0) > 0, (fn, row["tma_ops"])
        assert row["hmma"] == 0, fn


# (B, S, C) of the bf16 GEMM's products on the paths: the flagship's 32-px
# levels, the C 192 step's level 1, the CLIs' C 512 at the 32-px levels
BF16_GEMM_PATH_SHAPES = [(64, 256, 96), (64, 64, 96), (64, 16, 96),
                         (64, 64, 192), (16, 256, 512), (16, 64, 512),
                         (16, 16, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("batch,s,c", BF16_GEMM_PATH_SHAPES)
def test_bf16_gemm_is_one_device_launch_on_card(cuda_device, batch, s, c):
    """qkv, dseq and dW at the paths' shapes: the TMA + wgmma route
    (`gemm_bf16_plan`), one device launch a call (a CUDA graph's kernel
    nodes), split K included, and the split counters left zero."""
    from gpnf_tpu_torch.utils.cuda_timing import graph_launches

    r = np.random.default_rng(45)
    seq = _bf16(_normal(r, (batch, s, c), 0.5)).to(cuda_device)
    w = _bf16(_normal(r, (3 * c, c), 0.1)).to(cuda_device)
    dqkv = _bf16(_normal(r, (batch, s, 3 * c), 0.1)).to(cuda_device)
    rows = batch * s
    for run, (m, n, k, ta, tb, splits) in (
            (lambda: kernels.attention_qkv_gemm(seq, w),
             (rows, 3 * c, c, False, True, 1)),
            (lambda: kernels.attention_dseq_gemm(dqkv, w),
             (rows, c, 3 * c, False, False, None)),
            (lambda: kernels.attention_dw_gemm(dqkv, seq),
             (3 * c, c, rows, True, False, None))):
        plan = fa.gemm_bf16_plan(m, n, k, 0, 0, 0, ta, tb, splits)
        assert plan.route == "wgmma"
        assert graph_launches(run) == 1, plan
    torch.cuda.synchronize()
    for buf in fa._WGMMA_COUNTERS.values():
        assert int(buf.abs().sum()) == 0


@pytest.mark.cuda
def test_bf16_dw_gemm_at_long_k_against_float64(cuda_device):
    """dW at the flagship's level 0 (K = B S = 16,384, split in
    `wgmma_splits` ranges, each kept in the tensor core's fp32
    accumulators): its error against the float64 product within K 2^-24
    of sum |products| element by element (the bar of two float32 orders)
    at split counts of one to 64 (clusters of 2 and 8), each bit for bit on a
    second call; at the rule's count also within 8 times the plain float32
    product's own error (one split, all 16,384 in the tensor core, read
    1.06e-6 of sum |products| against the plain product's 1.4e-8 on an
    H100)."""
    r = np.random.default_rng(46)
    seq = _bf16(_normal(r, (64, 256, 96), 0.5)).to(cuda_device)
    dqkv = _bf16(_normal(r, (64, 256, 288), 0.1)).to(cuda_device)
    d2, s2 = dqkv.reshape(-1, 288), seq.reshape(-1, 96)
    exact = d2.double().t() @ s2.double()
    mag = d2.double().abs().t() @ s2.double().abs()
    k = d2.shape[0]
    plain = float(((fa.dw_plain(dqkv, seq).double() - exact).abs()
                   / mag).max())
    for splits in (None, 1, 2, 4, 8, 16, 32, 64):
        run = lambda: fa._gemm_bf16("dw", dqkv, seq, (288, 96), 288, 96, k,
                                    True, False, torch.float32, splits)
        got = run()
        err = float(((got.double() - exact).abs() / mag).max())
        assert err <= k * 2.0 ** -24, (splits, err)
        assert splits is not None or err <= 8 * plain, (err, plain)
        assert torch.equal(got, run())


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_bf16_proj_backward_launches_the_bf16_kernels(cuda_device, rate):
    """A bf16 proj backward (the flagship's level 1) from the forward's
    statistics runs the bf16 qkv GEMM, the bf16 dq and dK/dV pair and the
    bf16 dseq and dW GEMMs, one launch each (no forward), no library product
    and no bf16 tensor upcast: dseq and dW (bf16,
    w's dtype) within 2^-7 of the largest |plain| of
    `attention_proj_plain_bwd`."""
    r = np.random.default_rng(44)
    seq = _bf16(_normal(r, (8, 64, 96), 0.5)).to(cuda_device)
    w = _bf16(_normal(r, (288, 96), 0.1)).to(cuda_device)
    g = _bf16(_normal(r, (8, 64, 96), 0.5)).to(cuda_device)
    seed = torch.tensor([4], dtype=torch.int32, device=cuda_device)
    # the forward's statistics, as training's autograd passes them
    _, stats = fa._forward(seq, w, 4, rate, seed, with_stats=True)
    kernels.reset_launch_counts()
    with NoLibraryProducts(), NoUpcast():
        dseq, dw = kernels.fused_attention_proj_bwd(seq, w, g, 4, rate,
                                                    seed, stats)
    counts = kernels.launch_counts()
    assert counts == {**dict.fromkeys(counts, 0), **PROJ_BWD_COUNTS,
                      "attention_qkv_gemm_bf16": 1, "attention_bwd_bf16": 1,
                      "attention_dseq_gemm_bf16": 1,
                      "attention_dw_gemm_bf16": 1}
    want = kernels.attention_proj_plain_bwd(seq, w, g, 4, rate, seed)
    for got, plain in zip((dseq, dw), want):
        assert got.dtype == plain.dtype == torch.bfloat16
        assert float((got.float() - plain.float()).abs().max()) <= \
            2.0 ** -7 * float(plain.float().abs().max())


# -- the fused GatedConv in bf16 (compute_dtype="bfloat16", fused_gated_conv) --------
GATED_CONV_NAMES = ("out", "dx", "dw1", "db1", "dwg", "dbg")


def _gated_conv_bf16_inputs(device, c, h, w, batch, seed=0):
    return [_bf16(t_).to(device) for t_ in _gated_conv_inputs(
        "cpu", c, h, w, batch=batch, seed=seed)]


def _gated_conv_bf16_held(got, args, rate, seed, moved=False):
    """Each result of the bf16 kernels (out, then dx, dw1, db1, dwg, dbg)
    within its bar of the plain bf16 versions (`gated_conv_bf16_readings`:
    out and dx bf16 with at most 5% and 10% of their values differing,
    the weight and bias gradients float32); with `moved`, the plain
    versions with a rounding point moved each outside them (C >= 48: a
    bias gradient of a few channels may miss a fault that moves each term
    by a third of its rounding error)."""
    x, w1, b1, wg, bg, g = args
    fgc = importlib.import_module(
        "gpnf_tpu_torch.ops.kernels.fused_gated_conv")
    for name, a in zip(GATED_CONV_NAMES, got):
        assert a.dtype == (torch.bfloat16 if name in ("out", "dx")
                           else torch.float32), name
        assert torch.isfinite(a).all(), name
    readings = fgc.gated_conv_bf16_readings(got, *args, rate, seed)
    assert readings["held"], "; ".join(
        f"{n} " + " ".join(f"{k} {v:.4g}" for k, v in readings[n].items()
                           if k in ("over_bar", "share", "rms_over_rss"))
        for n in GATED_CONV_NAMES)
    for point in fgc.GATED_CONV_MOVED if moved else ():
        assert not fgc.gated_conv_bf16_readings(got, *args, rate, seed,
                                                (point,))["held"], point


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("c,h,w,batch", [
    (96, 16, 16, 64), (96, 8, 8, 64), (96, 4, 4, 64), (96, 32, 32, 16),
    (512, 16, 16, 16), (512, 8, 8, 16), (512, 4, 4, 16), (12, 16, 16, 16),
    (12, 4, 4, 16), (48, 16, 16, 16), (48, 4, 4, 16), (160, 16, 16, 16),
    (160, 4, 4, 16), (13, 5, 7, 4), (4, 6, 6, 4), (128, 8, 8, 4)])
def test_gated_conv_bf16_kernels_match_plain_on_card(cuda_device, c, h, w,
                                                     batch, rate):
    """One seed for kernel and plain version (the same mask): out and dx
    within one bf16 ulp of the largest |plain| plus their last product's
    float32 spread with at most 5% (out) and 10% (dx) of their values
    differing, each weight and bias gradient within its bar
    (`gated_conv_bf16_readings`), which the plain versions with a rounding
    point moved miss; a call counts
    one launch on its entry and one on its bf16 counter. The paths' shapes
    (the 32-px levels at batch 64, the 64-px level 0, --C 512's levels),
    the narrow path (C 13, C 4) and every tile (C 96 on 64 x 96, C 128 on 64
    x 128, C 512 on 128 x 128), split K at the small images."""
    args = _gated_conv_bf16_inputs(cuda_device, c, h, w, batch)
    seed = torch.tensor([4242 + c], dtype=torch.int32, device=cuda_device)
    kernels.reset_launch_counts()
    out = kernels.fused_gated_conv(*args[:5], rate, seed)
    grads = kernels.fused_gated_conv_bwd(*args, rate, seed)
    counts = kernels.launch_counts()
    assert counts == {**dict.fromkeys(counts, 0), "fused_gated_conv": 1,
                      "fused_gated_conv_bf16": 1, "fused_gated_conv_bwd": 1,
                      "fused_gated_conv_bwd_bf16": 1}
    _gated_conv_bf16_held((out, *grads), args, rate, seed, moved=c >= 48)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [96, 160])
def test_gated_conv_bf16_bwd_repeats_bit_for_bit(cuda_device, c):
    """Two calls of the bf16 forward and backward give the same bits (the
    splits and db1's row ranges summed in a fixed order)."""
    args = _gated_conv_bf16_inputs(cuda_device, c, 16, 16, 8)
    seed = torch.tensor([7], dtype=torch.int32, device=cuda_device)
    assert torch.equal(kernels.fused_gated_conv(*args[:5], 0.2, seed),
                       kernels.fused_gated_conv(*args[:5], 0.2, seed))
    first = kernels.fused_gated_conv_bwd(*args, 0.2, seed)
    again = kernels.fused_gated_conv_bwd(*args, 0.2, seed)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_gated_conv_bf16_takes_misaligned_operands(cuda_device):
    """x and g starting 2 bytes past a 16-byte boundary take the narrow
    path (one value a copy): within the bars of the plain versions on the
    aligned tensors."""
    args = _gated_conv_bf16_inputs(cuda_device, 16, 8, 8, 4)
    shift = lambda t_: torch.cat([t_.new_zeros(1), t_.flatten()])[1:].view(
        t_.shape)
    xs, gs = shift(args[0]), shift(args[5])
    assert xs.data_ptr() % 16 == 2 and xs.is_contiguous()
    out = kernels.fused_gated_conv(xs, *args[1:5])
    grads = kernels.fused_gated_conv_bwd(xs, *args[1:5], gs)
    _gated_conv_bf16_held((out, *grads), args, 0.0, None)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 16, 16, 96), (64, 4, 4, 96),
                                   (64, 32, 32, 96), (16, 16, 16, 512),
                                   (16, 4, 4, 512), (4, 5, 7, 13)])
def test_gated_conv_bf16_plan_launches(cuda_device, shape):
    """A bf16 call launches as many kernels as the source's plan says (the
    kernel nodes of a CUDA graph that captures it): its products, their
    split sums, the mask table at rate > 0, and in the backward db1's two
    column-sum launches (so at least 8 a backward call)."""
    from gpnf_tpu_torch.ops.kernels.fused_gated_conv import gated_conv_plan
    from gpnf_tpu_torch.utils.cuda_timing import graph_launches
    b, h, w, c = shape
    args = _gated_conv_bf16_inputs(cuda_device, c, h, w, b)
    seed = torch.tensor([11], dtype=torch.int32, device=cuda_device)
    for rate in (0.0, 0.2):
        fwd = gated_conv_plan(b, h, w, c, rate > 0.0, False, c % 8 == 0,
                              torch.bfloat16)[1]
        bwd = gated_conv_plan(b, h, w, c, rate > 0.0, True, c % 8 == 0,
                              torch.bfloat16)[1]
        assert graph_launches(lambda: kernels.fused_gated_conv(
            *args[:5], rate, seed)) == fwd
        assert graph_launches(lambda: kernels.fused_gated_conv_bwd(
            *args, rate, seed)) == bwd
        assert bwd >= 8 + (rate > 0.0)


@pytest.mark.cuda
def test_gated_conv_bf16_kernels_run_bf16_on_the_tensor_cores(cuda_device):
    """Every bf16 instantiation of the gated-conv kernel (OpBf16: each
    product, tile and copy width) holds bf16 HMMA instructions
    (HMMA.16816.F32.BF16) and no TF32 one; the float32 ones the reverse."""
    import os
    import shutil

    from gpnf_tpu_torch.bench_mixture import sass_counts
    from gpnf_tpu_torch.ops.kernels import _native

    if not os.path.exists(shutil.which("cuobjdump")
                          or "/usr/local/cuda/bin/cuobjdump"):
        pytest.skip("no cuobjdump in the CUDA toolkit: the SASS cannot be "
                    "read here")
    _native.build(["fused_gated_conv"])
    rows = {fn: row["hmma_ops"] for fn, row in sass_counts(
        _native.library_path("fused_gated_conv")).items()
        if "gated_conv_mma_kernel" in fn}
    bf16 = {fn: ops for fn, ops in rows.items() if "OpBf16" in fn}
    f32 = {fn: ops for fn, ops in rows.items() if "OpF32" in fn}
    assert bf16 and f32 and len(bf16) + len(f32) == len(rows)
    for ops in bf16.values():
        assert ops.get("HMMA.16816.F32.BF16", 0) > 0 and not any(
            "TF32" in op for op in ops), ops
    for ops in f32.values():
        assert ops.get("HMMA.1688.F32.TF32", 0) > 0 and not any(
            "BF16" in op for op in ops), ops


@pytest.mark.cuda
def test_bf16_fused_model_trains_on_card(cuda_device):
    """A small bf16 mAR-SCF with fused_gated_conv (C 96) on the card: one
    training step at dropout 0 against the port on the CPU on the same
    weights, the loss within the larger of 1e-3 and half of the CPU's
    bf16-vs-float32 gap, every gradient within its own grad_parity bar
    (the CPU's float32 step and two CPU bf16 steps on moved weights) and
    the whole gradient's L2 distance from the CPU's float32 at most 1.5
    times the CPU bf16's; a step at dropout 0.2 launches only bf16
    gated-conv kernels, one each way a block."""
    small = dict(SMALL, hidden_channels=96, drop_prob=0.0,
                 fused_gated_conv=True)
    cfg = dict(small, compute_dtype="bfloat16")
    cpu = MarScfFlow(MarScfConfig(**cfg), device="cpu")
    card = MarScfFlow(MarScfConfig(**cfg), device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    f32 = MarScfFlow(MarScfConfig(**small), device="cpu")
    f32.load_state_dict(cpu.state_dict())
    moved = []
    for seed in (1, 2):
        net = MarScfFlow(MarScfConfig(**cfg), device="cpu")
        net.load_state_dict(grad_parity.perturbed(cpu, seed))
        moved.append(net)
    x = torch.from_numpy(np.random.default_rng(36).random(
        (2, 3, 16, 16), dtype=np.float32) - 0.5)
    noise = torch.full_like(x, 0.5)
    losses, grads = [], []
    for net, dev in ((cpu, "cpu"), (f32, "cpu"), (card, cuda_device),
                     *((net, "cpu") for net in moved)):
        net.train()
        loss = net(x.to(dev), noise=noise.to(dev))[1].mean()
        loss.backward()
        losses.append(float(loss.detach()))
        grads.append({k: p.grad.detach().cpu()
                      for k, p in net.named_parameters()})
    assert abs(losses[2] - losses[0]) <= max(1e-3, 0.5 * abs(
        losses[0] - losses[1]))
    c16, c32, got = grads[:3]
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all()
               for g in got.values())
    rows = grad_parity.bf16_grad_parity(got, c16, c32, grads[3:])
    assert len(rows) == len(c32) and rows[0][0] <= 1.0, rows[:4]
    l2 = lambda g: sum(float(((g[k] - c32[k]) ** 2).sum()) for k in c32)
    assert l2(got) <= 1.5 ** 2 * l2(c16), (l2(got), l2(c16))
    train = MarScfFlow(MarScfConfig(**dict(cfg, drop_prob=0.2)),
                       device=cuda_device).train()
    train.load_state_dict(cpu.state_dict())
    kernels.reset_launch_counts()
    train(x.to(cuda_device), generator=torch.Generator(
        device=cuda_device).manual_seed(1))[1].mean().backward()
    counts = kernels.launch_counts()
    blocks = SMALL["L"] * SMALL["K"] * SMALL["num_blocks"]
    for name in ("fused_gated_conv", "fused_gated_conv_bwd"):
        assert counts[name] == counts[f"{name}_bf16"] == blocks, counts
