"""Checkpoint path: the JAX package writes best.npz with its own
CheckpointManager; the port's CLI restores it on the CPU, evaluates test
bits/dim over the synthetic test set and writes a PNG sample grid. The
bits/dim must equal the JAX model's on the same images and the same
dequantisation noise. Also the training CLI's checkpoint directory for an
affine model without attention, which the eval CLIs of both packages look
up, and a training run on ImageNet-32 npz shards."""
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gpnf_tpu.models.marscf import MarScfConfig as JaxConfig
from gpnf_tpu.models.marscf import MarScfFlow as JaxFlow
from gpnf_tpu.training.checkpoints import CheckpointManager
from gpnf_tpu_torch import eval_marscf, train_marscf
from gpnf_tpu_torch.data import datasets
from gpnf_tpu_torch.data.datasets import get_dataset
from torch_parity import close

# the CLI's model at 32x32 (10 blocks, 32 components, 3-layer prior), cut to
# one level of one step at hidden width 8
L, K, C, BATCH, SEED = 1, 1, 8, 128, 0
NUM_DIMS = 32 * 32 * 3


def test_cli_restores_jax_checkpoint_and_matches_jax(tmp_path, monkeypatch):
    jm = JaxFlow(JaxConfig(image_shape=(32, 32, 3), L=L, K=K, hidden_channels=C,
                           coupling="mixlogcdf"))
    params = jm.init(jax.random.PRNGKey(0))
    ckpt_dir = tmp_path / "ckpt" / f"marscf_synthetic_mixlogcdf_{K}_{C}"
    CheckpointManager(str(ckpt_dir)).save(0, {"params": params}, metric=1.0)

    monkeypatch.chdir(tmp_path)
    result = eval_marscf.main([
        "--dataset_name", "synthetic", "--coupling", "mixlogcdf",
        "--batch_size", str(BATCH), "--L", str(L), "--K", str(K),
        "--C", str(C), "--checkpoint_dir", str(tmp_path / "ckpt"),
        "--seed", str(SEED), "--device", "cpu"])

    # the JAX model on the port's batches with the port's noise stream
    encode = jax.jit(jm.encode)
    _, test_loader, _ = get_dataset("synthetic", BATCH)
    gen = torch.Generator().manual_seed(SEED + 1)
    logdet = jnp.full((BATCH,), -math.log(256.0) * NUM_DIMS)
    nlls = []
    for batch in test_loader:
        noise = torch.rand(batch.shape, generator=gen).numpy()
        _, obj = encode(params, jnp.asarray(batch + noise / 256.0), logdet)
        nlls.append(float(jnp.mean(-obj / (math.log(2.0) * NUM_DIMS))))
    close(result["nll"], np.mean(nlls), rtol=0, atol=1e-4)

    png = tmp_path / "samples" / f"torch_marscf_synthetic_mixlogcdf_{K}_{C}.png"
    assert result["samples"] == os.path.join(
        ".", "samples", png.name) and png.exists()
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_affine_checkpoint_dir_is_the_one_the_eval_clis_read(tmp_path,
                                                            monkeypatch):
    """`--coupling affine --no_attention`: the best checkpoint lands under
    marscf_<ds>_affine_<K>_<C>, the JAX package's name, so the port's eval
    CLI restores it, and the JAX CheckpointManager reads it into the JAX
    model of the same configuration."""
    synthetic = datasets._synthetic
    monkeypatch.setattr(datasets, "_synthetic",
                        lambda size: synthetic(size, n_train=16, n_test=8))
    monkeypatch.chdir(tmp_path)
    flags = ["--dataset_name", "synthetic", "--coupling", "affine",
             "--no_attention", "--batch_size", "8", "--L", "1", "--K", "1",
             "--C", "8", "--checkpoint_dir", "ck", "--device", "cpu"]
    out = train_marscf.main(flags + ["--max_steps", "1"])
    run = tmp_path / "ck" / "marscf_synthetic_affine_1_8"
    assert (run / "best.npz").exists()
    assert json.loads((run / "meta.json").read_text())["best_step"] == 1
    result = eval_marscf.main(flags)
    close(result["nll"], out["best_test_nll"], rtol=0, atol=1e-5)
    jm = JaxFlow(JaxConfig(image_shape=(32, 32, 3), L=1, K=1,
                           hidden_channels=8, coupling="affine",
                           use_attention=False))
    restored = CheckpointManager(str(run)).restore(
        {"params": jm.init(jax.random.PRNGKey(0))}, best=True)["params"]
    assert jax.tree.leaves(restored)


def test_train_cli_on_imagenet_32_npz_shards(tmp_path, monkeypatch):
    """One step on downsampled-ImageNet npz shards written here (4 training
    and 2 validation images of 32x32x3), then the eval and the checkpoint."""
    r = np.random.default_rng(0)
    data = tmp_path / "data"
    data.mkdir()
    np.savez(data / "train_data_batch_1.npz",
             data=r.integers(0, 256, (4, 3 * 32 * 32), np.uint8))
    np.savez(data / "val_data.npz",
             data=r.integers(0, 256, (2, 3 * 32 * 32), np.uint8))
    monkeypatch.chdir(tmp_path)
    out = train_marscf.main([
        "--dataset_name", "imagenet_32", "--data_root", str(data), "--L", "1",
        "--K", "1", "--C", "8", "--batch_size", "2", "--max_steps", "1",
        "--checkpoint_dir", "ck", "--device", "cpu"])
    assert math.isfinite(out["best_test_nll"])
    run = tmp_path / "ck" / "marscf_imagenet_32_mixlogcdf_1_8"
    assert (run / "best.npz").exists() and (run / "step_1.npz").exists()
