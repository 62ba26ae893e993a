"""The ImageNet-64 slice at a small size against the JAX package (float32,
CPU): GatedAttn at S = 576 (the long-sequence entry), a small mAR-SCF at
48x48x3 whose level 0 has S = 24 * 24 = 576 (encode, one training step's
loss and every gradient at dropout 0, eps_std=0 sampling), and the
ImageNet-32/64 readers (npz shards, a PNG image folder, the synthetic
fallback) and the PNG decoder, on the same files."""
import functools
import math
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpnf_tpu.data import datasets as j_datasets
from gpnf_tpu.models.marscf import MarScfConfig as JaxConfig
from gpnf_tpu.models.marscf import MarScfFlow as JaxFlow
from gpnf_tpu.ops import mixlogcdf as j_mix
from gpnf_tpu.utils import png as j_png
from gpnf_tpu_torch import convert
from gpnf_tpu_torch.data import datasets
from gpnf_tpu_torch.models.marscf import MarScfConfig, MarScfFlow
from gpnf_tpu_torch.ops import mixlogcdf
from gpnf_tpu_torch.utils import png
from torch_parity import close, load, n, normal, rng, t

SMALL = dict(image_shape=(48, 48, 3), L=2, K=1, hidden_channels=8,
             num_blocks=1, num_components=4, drop_prob=0.0, prior_hidden=8,
             prior_layers=3)
NUM_DIMS = 48 * 48 * 3


def test_gated_attn_at_576_takes_the_long_entry_and_matches_jax(monkeypatch):
    calls = []
    long_entry = mixlogcdf.fused_attention_long

    def spy(seq, *args):
        calls.append(seq.shape)
        return long_entry(seq, *args)

    monkeypatch.setattr(mixlogcdf, "fused_attention_long", spy)
    x = normal(rng(5), (2, 24, 24, 32))
    j = j_mix.GatedAttn(32)
    p = j.init(jax.random.PRNGKey(0))
    close(load(mixlogcdf.GatedAttn(32), p)(t(x)), j.apply(p, jnp.asarray(x)))
    assert calls == [(2, 576, 32)]


@pytest.fixture(scope="module")
def models():
    jm = JaxFlow(JaxConfig(**SMALL, remat=False))
    params = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    tm = MarScfFlow(MarScfConfig(**SMALL), device="cpu")
    convert.load_jax_params(tm, params)
    return jm, params, tm


def _batch(seed=0):
    r = rng(seed)
    return (r.random((2, 3, 48, 48), dtype=np.float32) - 0.5,
            r.random((2, 3, 48, 48), dtype=np.float32))


def test_encode_at_48px_matches_jax(models):
    """Bits/dim within 1e-4 and the final z within 1e-4."""
    jm, params, tm = models
    x, _ = _batch()
    logdet = np.full((2,), -math.log(256.0) * NUM_DIMS, np.float32)
    zf_j, obj_j = jax.jit(jm.encode)(params, jnp.asarray(x),
                                     jnp.asarray(logdet))
    with torch.no_grad():
        zf, obj = tm.eval().encode(t(x), t(logdet))
    bpd = lambda o: -n(o) / (math.log(2.0) * NUM_DIMS)
    close(bpd(obj), bpd(obj_j), rtol=0, atol=1e-4)
    close(zf, zf_j, rtol=0, atol=1e-4)


def test_train_step_loss_and_every_gradient_at_48px_match_jax(models):
    """Training mode at dropout 0: the bits/dim loss within 1e-5 and each
    parameter's gradient within 1e-4 of its largest magnitude."""
    jm, params, tm = models
    x, noise = _batch(1)

    def loss_fn(p):
        logdet = jnp.full((2,), -math.log(256.0) * NUM_DIMS)
        _, obj = jm.encode(p, jnp.asarray(x + noise / 256.0), logdet)
        return jnp.mean(-obj / (math.log(2.0) * NUM_DIMS))

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = convert.jax_to_state_dict(jax.device_get(grads_j))
    tm.train()
    tm.zero_grad()
    loss = torch.mean(tm(t(x), noise=t(noise))[1])
    loss.backward()
    close(loss, loss_j, rtol=0, atol=1e-5)
    for name, p in tm.named_parameters():
        scale = float(np.abs(want[name]).max())
        close(p.grad, want[name], rtol=0, atol=1e-4 * scale + 1e-12)


def test_sample_eps_std_zero_at_48px_matches_jax(models):
    jm, params, tm = models
    want = jax.jit(functools.partial(jm.sample, batch=2, eps_std=0.0))(
        params, jax.random.PRNGKey(1))
    with torch.no_grad():
        got = tm.eval().sample(2, eps_std=0.0)
    assert got.shape == (2, 3, 48, 48)
    close(got, want, rtol=0, atol=1e-3)


# -- the ImageNet readers ----------------------------------------------------------
def _write_npz_shards(root, size, n_train=(3, 2), n_val=2, seed=0):
    r = rng(seed)
    for i, n_ in enumerate(n_train, start=1):
        np.savez(root / f"train_data_batch_{i}.npz",
                 data=r.integers(0, 256, (n_, 3 * size * size), np.uint8))
    np.savez(root / "val_data.npz",
             data=r.integers(0, 256, (n_val, 3 * size * size), np.uint8))


def _write_image_folder(root, size, seed=1):
    r = rng(seed)
    for split, names in (("train", ("a/0", "a/1", "b/0")), ("val", ("0", "1"))):
        for name in names:
            path = root / split / f"{name}.png"
            path.parent.mkdir(parents=True, exist_ok=True)
            png.write_png(str(path),
                          r.integers(0, 256, (size, size, 3), np.uint8))


def _same_loaders(got, want):
    port_train, port_test, port_shape = got
    jax_train, jax_test, jax_shape = want
    assert port_shape == jax_shape
    for loader, ref in ((port_train, jax_train), (port_test, jax_test)):
        np.testing.assert_array_equal(loader.images, ref.images)
        assert len(loader) == len(ref)
        for a, b in zip(loader, ref):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,size", [("imagenet_64", 64),
                                       ("imagenet_32", 32)])
@pytest.mark.parametrize("layout", ["npz", "folder"])
def test_imagenet_readers_match_jax(tmp_path, name, size, layout):
    if layout == "npz":
        _write_npz_shards(tmp_path, size)
    else:
        _write_image_folder(tmp_path, size)
    got = datasets.get_dataset(name, 2, str(tmp_path), seed=3)
    want = j_datasets.get_dataset(name, 2, str(tmp_path), seed=3)
    _same_loaders(got, want)
    assert got[0].images.shape[1:] == (3, size, size)


def test_imagenet_64_falls_back_to_synthetic_at_64px(tmp_path):
    got = datasets.get_dataset("imagenet_64", 64, str(tmp_path / "none"))
    want = j_datasets.get_dataset("imagenet_64", 64, str(tmp_path / "none"))
    np.testing.assert_array_equal(got[0].images, want[0].images)
    np.testing.assert_array_equal(got[1].images, want[1].images)
    assert got[2] == want[2] == (64, 64, 3)
    assert got[0].images.shape == (2048, 3, 64, 64)


def _png_with_filter(img, ft):
    """An 8-bit PNG of img (H, W, C) with every scanline filtered by `ft`
    (0 none, 1 sub, 2 up, 3 average, 4 Paeth)."""
    h, w, ch = img.shape
    rows = img.reshape(h, w * ch).astype(np.int32)
    raw = b""
    for y in range(h):
        cur = rows[y]
        prev = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(ch, np.int32), cur[:-ch]])
        up_left = np.concatenate([np.zeros(ch, np.int32), prev[:-ch]])
        if ft == 0:
            pred = np.zeros_like(cur)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = prev
        elif ft == 3:
            pred = (left + prev) >> 1
        else:
            pred = np.array([png._paeth(a, b, c) for a, b, c in
                             zip(left, prev, up_left)], np.int32)
        raw += bytes([ft]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes()

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, 2 if ch == 3 else 6, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [3, 4])
def test_read_png_decodes_every_filter_as_jax_does(tmp_path, channels):
    img = rng(channels).integers(0, 256, (5, 7, channels), np.uint8)
    for ft in range(5):
        path = tmp_path / f"f{ft}.png"
        path.write_bytes(_png_with_filter(img, ft))
        got = png.read_png(str(path))
        np.testing.assert_array_equal(got, img[:, :, :3])
        np.testing.assert_array_equal(got, j_png.read_png(str(path)))
