"""The training slice at a small size against the JAX package (float32,
CPU): the loss and every parameter's gradient of the whole model with the
same weights and dequantisation noise, checkpoints that cross between the
two packages in both directions, train-mode dropout, the CIFAR
augmentation, and a 3-step run of the training CLI."""
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpnf_tpu.data import datasets as j_datasets
from gpnf_tpu.models.marscf import MarScfConfig as JaxConfig
from gpnf_tpu.models.marscf import MarScfFlow as JaxFlow
from gpnf_tpu.training.checkpoints import CheckpointManager as JaxCheckpoints
from gpnf_tpu.training.checkpoints import _flatten
from gpnf_tpu_torch import convert, train_marscf
from gpnf_tpu_torch.data import datasets
from gpnf_tpu_torch.models.marscf import MarScfConfig, MarScfFlow
from gpnf_tpu_torch.models.prior import ChannelPriorUniScale
from gpnf_tpu_torch.ops import mixlogcdf
from gpnf_tpu_torch.training.checkpoints import CheckpointManager
from torch_parity import close, n, rng, t

SMALL = dict(image_shape=(16, 16, 3), L=2, K=1, hidden_channels=16,
             num_blocks=2, num_components=4, prior_hidden=8, prior_layers=3)
NUM_DIMS = 16 * 16 * 3


@pytest.fixture(scope="module")
def models():
    # remat only changes the JAX package's memory schedule, not its numbers
    jm = JaxFlow(JaxConfig(**SMALL, drop_prob=0.0, remat=False))
    params = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    tm = MarScfFlow(MarScfConfig(**SMALL, drop_prob=0.0), device="cpu")
    convert.load_jax_params(tm, params)
    return jm, params, tm


def _batch(seed=0, batch=2):
    r = rng(seed)
    return (r.random((batch, 3, 16, 16), dtype=np.float32) - 0.5,
            r.random((batch, 3, 16, 16), dtype=np.float32))


def test_loss_and_every_gradient_match_jax(models):
    """Training mode at dropout 0: the bits/dim loss within 1e-5 and each
    parameter's gradient within 1e-4 of its largest magnitude."""
    jm, params, tm = models
    x, noise = _batch()

    def loss_fn(p):
        logdet = jnp.full((x.shape[0],), -math.log(256.0) * NUM_DIMS)
        _, obj = jm.encode(p, jnp.asarray(x + noise / 256.0), logdet)
        return jnp.mean(-obj / (math.log(2.0) * NUM_DIMS))

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = convert.jax_to_state_dict(jax.device_get(grads_j))
    tm.train()
    tm.zero_grad()
    loss = torch.mean(tm(t(x), noise=t(noise))[1])
    loss.backward()
    close(loss, loss_j, rtol=0, atol=1e-5)
    names = [name for name, _ in tm.named_parameters()]
    assert len(names) > 50
    for name, p in tm.named_parameters():
        scale = float(np.abs(want[name]).max())
        close(p.grad, want[name], rtol=0, atol=1e-4 * scale + 1e-12)


def test_convert_back_restacks_the_jax_layout(models):
    _, params, tm = models
    back = convert.state_dict_to_jax(tm.state_dict())
    want = _flatten(params)
    assert set(back) == set(want)
    for key, value in back.items():
        close(value, want[key], 0, 0)
    again = convert.jax_to_state_dict(back)
    for key, value in tm.state_dict().items():
        close(again[key], value, 0, 0)


def test_port_checkpoint_restores_in_jax(models, tmp_path):
    jm, params, tm = models
    ckpt = CheckpointManager(str(tmp_path))
    assert ckpt.save(7, tm, metric=1.5)
    assert not ckpt.save(8, tm, metric=2.5)
    restored = JaxCheckpoints(str(tmp_path)).restore({"params": params},
                                                     best=True)["params"]
    flat = _flatten(restored)
    for key, value in _flatten(params).items():
        close(flat[key], value, 0, 0)
    meta = json.loads((tmp_path / "meta.json").read_text())
    assert meta == {"best_metric": 1.5, "best_step": 7}


def test_jax_checkpoint_restores_in_port(models, tmp_path):
    _, params, tm = models
    shifted = jax.tree.map(lambda a: np.asarray(a) + 0.25, params)
    JaxCheckpoints(str(tmp_path)).save(3, {"params": shifted}, metric=2.0)
    fresh = MarScfFlow(MarScfConfig(**SMALL), device="cpu",
                       generator=torch.Generator().manual_seed(5))
    ckpt = CheckpointManager(str(tmp_path))
    assert ckpt.latest_step() == 3
    for kwargs in ({"best": True}, {"step": 3}, {}):
        ckpt.restore(fresh, **kwargs)
        want = convert.jax_to_state_dict(shifted)
        for key, value in fresh.state_dict().items():
            close(value, want[key], 0, 0)


def test_checkpoints_keep_newest_and_multiples(models, tmp_path):
    _, _, tm = models
    ckpt = CheckpointManager(str(tmp_path), keep=2, keep_every=4)
    for step in range(1, 10):
        ckpt.save(step, tm)
    assert sorted(p.name for p in tmp_path.glob("step_*.npz")) == [
        "step_4.npz", "step_8.npz", "step_9.npz"]
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(tm)


def test_dropout_in_training_mode_only(models):
    """drop_prob 0.2: a training forward depends on the generator's seed and
    only on it; eval mode and ddi run without dropout."""
    _, params, _ = models
    tm = MarScfFlow(MarScfConfig(**SMALL), device="cpu")
    convert.load_jax_params(tm, params)
    x, noise = map(t, _batch(1))
    run = lambda seed: tm(x, noise=noise, generator=torch.Generator(
        ).manual_seed(seed))[1]
    with torch.no_grad():
        a, b, c = run(1), run(1), run(2)
        tm.eval()
        d = run(1)
        ref = MarScfFlow(MarScfConfig(**SMALL, drop_prob=0.0), device="cpu")
        convert.load_jax_params(ref, params)
        e = ref.eval()(x, noise=noise)[1]
    close(a, b, 0, 0)
    assert not np.allclose(n(a), n(c))
    close(d, e, 0, 0)
    tm.train()
    ddi_train, ddi_eval = MarScfFlow(MarScfConfig(**SMALL), device="cpu"), \
        MarScfFlow(MarScfConfig(**SMALL, drop_prob=0.0), device="cpu").eval()
    for m in (ddi_train, ddi_eval):
        convert.load_jax_params(m, params)
        m.ddi(x, noise=noise)
    assert ddi_train.training
    for key, value in ddi_eval.state_dict().items():
        close(ddi_train.state_dict()[key], value, 0, 0)


def test_channel_dropout_keeps_or_drops_whole_maps():
    x = torch.ones(4, 32, 3, 3)
    y = mixlogcdf.channel_dropout(x, 0.5, torch.Generator().manual_seed(0))
    per_map = y.reshape(4, 32, 9)
    assert torch.all(per_map == per_map[..., :1])  # one keep per (b, c)
    assert set(per_map[..., 0].unique().tolist()) == {0.0, 2.0}


def test_prior_dropout_zeroes_teacher_forced_channels():
    prior = ChannelPriorUniScale(3, 16, 16, 1, 2, hidden_size=8, num_layers=2,
                                 dp_rate=0.5)
    z = (t(rng(3).standard_normal((2, 6, 8, 8))),
         t(rng(4).standard_normal((2, 6, 8, 8))))
    with torch.no_grad():
        prior.eval()
        off = prior.log_likelihood(z)
        prior.train()
        on = prior.log_likelihood(z, torch.Generator().manual_seed(1))
        prior.dp_rate = 0.0
        zero_rate = prior.log_likelihood(z)
    assert not np.allclose(n(on), n(off))
    close(zero_rate, off, 0, 0)


def test_cifar_augmentation_matches_jax():
    images = (rng(5).random((16, 3, 32, 32)) * 255).astype(np.uint8)
    r = rng(6)
    shifts = r.integers(0, 6, size=16).astype(np.int32)
    horiz = (r.random(16) < 0.5).astype(np.uint8)
    flip = (r.random(16) < 0.5).astype(np.uint8)
    np.testing.assert_array_equal(
        datasets.shift_flip(images, 3, shifts, horiz, flip),
        j_datasets._numpy_shift_flip(images, 3, shifts, horiz, flip))
    port = datasets.NumpyLoader(images, 8, shuffle=True, augment="cifar",
                                seed=3)
    jax_loader = j_datasets.NumpyLoader(images, 8, shuffle=True,
                                        augment="cifar", seed=3)
    for got, want in zip(port, jax_loader):
        np.testing.assert_array_equal(got, want)


def test_train_cli_three_steps_on_cpu(tmp_path, monkeypatch):
    """3 Adamax steps on a cut synthetic set (64 training, 32 test images),
    then the eval and the best-NLL checkpoint in the JAX layout."""
    synthetic = datasets._synthetic
    monkeypatch.setattr(datasets, "_synthetic",
                        lambda size: synthetic(size, n_train=64, n_test=32))
    monkeypatch.chdir(tmp_path)
    out = train_marscf.main([
        "--dataset_name", "synthetic", "--batch_size", "8", "--L", "1",
        "--K", "1", "--C", "8", "--max_steps", "3", "--warm_up", "16",
        "--checkpoint_dir", "ck", "--log_path", "log.jsonl",
        "--device", "cpu"])
    assert math.isfinite(out["best_test_nll"]) and out["best_test_nll"] < 30
    run = tmp_path / "ck" / "marscf_synthetic_mixlogcdf_1_8"
    meta = json.loads((run / "meta.json").read_text())
    assert meta["best_step"] == 3
    assert (run / "best.npz").exists() and (run / "step_3.npz").exists()
    records = [json.loads(ln) for ln in (tmp_path / "log.jsonl").open()]
    assert records[-1]["step"] == 3 and "test_nll" in records[-1]
    # the card by default, and no quiet fall back to the CPU without one
    assert train_marscf.parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_marscf.main(["--dataset_name", "synthetic"])
