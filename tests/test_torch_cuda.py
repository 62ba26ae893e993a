"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: without a card each test skips (decided in the fixture, when
the test runs). This file imports neither jax nor the JAX package, so it
also runs where only PyTorch is installed; tests/conftest.py does import
jax, so there it is run without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from gpnf_tpu_torch.models.marscf import MarScfConfig, MarScfFlow
from gpnf_tpu_torch.ops import kernels, logistic

SMALL = dict(image_shape=(16, 16, 3), L=2, K=2, hidden_channels=16,
             num_blocks=2, num_components=4, prior_hidden=8, prior_layers=3)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    _close(x, kernels.mixture_inverse_plain(y, pi, mu, s), rtol=0, atol=1e-4)
    _close(torch.exp(logistic.mixture_log_cdf(x, pi, mu, s)), y, rtol=0,
           atol=2e-6)


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
