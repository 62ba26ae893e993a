"""Checkpoint path: the JAX package writes best.npz with its own
CheckpointManager; the port's CLI restores it on the CPU, evaluates test
bits/dim over the synthetic test set and writes a PNG sample grid. The
bits/dim must equal the JAX model's on the same images and the same
dequantisation noise."""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gpnf_tpu.models.marscf import MarScfConfig as JaxConfig
from gpnf_tpu.models.marscf import MarScfFlow as JaxFlow
from gpnf_tpu.training.checkpoints import CheckpointManager
from gpnf_tpu_torch import eval_marscf
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
