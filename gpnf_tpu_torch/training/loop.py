"""mAR-SCF training, evaluation and sampling.

Counterpart of gpnf_tpu/training/loop.py (`bits_per_dim_loss`, `train`,
`nll_metric`, `evaluate`, `save_sample_grid`). Dequantisation noise,
dropout and sampling noise come from explicit torch.Generators on the
model's device. The training cadence is the JAX package's: a log line
every 50 updates, with one host read of the loss per window; an eval of
test bits/dim every `eval_every_steps` updates, or after every
`test_epoch_interval`-th epoch, and at the end; a checkpoint in the JAX
npz layout at each new best test NLL. The JAX package's single-program
data-parallel step over a device mesh, its background batch prefetch and
its overlapped checkpoint save are not ported: the port trains on one
card.
"""
from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from ..utils.png import write_png

LOG_EVERY = 50  # updates per log line (one host read of the loss)


@dataclass
class TrainConfig:
    dataset: str = "cifar10"
    data_root: Optional[str] = None
    batch_size: int = 64
    warm_up: int = 10000  # in samples, like the reference
    lr: float = 1e-4
    epochs: int = 100000
    test_epoch_interval: int = 1
    eval_every_steps: Optional[int] = None  # else eval per epoch
    max_steps: Optional[int] = None
    checkpoint_dir: str = "./checkpoints"
    log_path: Optional[str] = None  # JSON lines of the log and eval records
    seed: int = 0
    device: str = "cuda"


def bits_per_dim_loss(model, batch: torch.Tensor,
                      generator=None) -> torch.Tensor:
    """Mean bits/dim of a batch; dropout is on when the model is in
    training mode."""
    return torch.mean(model(batch, generator=generator)[1])


def train_step(model, opt, batch: torch.Tensor,
               generator=None) -> torch.Tensor:
    """One Adamax update on one batch; returns the loss as a tensor on the
    model's device. The only host read is the optimizer's check that the
    gradients are finite."""
    opt.zero_grad()
    loss = bits_per_dim_loss(model, batch, generator)
    loss.backward()
    opt.step()
    return loss.detach()


@torch.no_grad()
def nll_metric(model, batch: torch.Tensor, generator=None) -> torch.Tensor:
    """Per-image test bits/dim, (B,)."""
    return model(batch, generator=generator)[1]


@torch.no_grad()
def evaluate(model, test_loader, *, generator=None) -> float:
    """Mean over batches of the batch-mean bits/dim (fresh noise per batch)."""
    nlls = []
    for batch in test_loader:
        x = torch.from_numpy(np.ascontiguousarray(batch)).to(model.device)
        nlls.append(float(torch.mean(nll_metric(model, x, generator))))
    return float(np.mean(nlls)) if nlls else float("nan")


def train(model_cfg, train_cfg: TrainConfig, *, log_fn=print):
    """Train from a random init (seeded) with ddi on the first batch;
    returns (model, best test NLL)."""
    from ..data.datasets import get_dataset
    from ..models.marscf import MarScfFlow
    from ..utils.device import resolve_device
    from .checkpoints import CheckpointManager
    from .optim import AdamaxWarmup

    device = resolve_device(train_cfg.device)
    train_loader, test_loader, image_shape = get_dataset(
        train_cfg.dataset, train_cfg.batch_size, train_cfg.data_root,
        seed=train_cfg.seed)
    model_cfg = replace(model_cfg, image_shape=image_shape)
    model = MarScfFlow(model_cfg, device=device, generator=torch.Generator(
        ).manual_seed(train_cfg.seed))
    gen = torch.Generator(device=device).manual_seed(train_cfg.seed)
    eval_gen = torch.Generator(device=device).manual_seed(train_cfg.seed + 1)
    to_device = lambda b: torch.from_numpy(b).to(device)
    model.ddi(to_device(next(iter(train_loader))), generator=gen)
    model.train()
    opt = AdamaxWarmup(model.parameters(), lr=train_cfg.lr,
                       warm_up=train_cfg.warm_up,
                       batch_size=train_cfg.batch_size)
    setting_id = (f"marscf_{train_cfg.dataset}_{model_cfg.coupling}_"
                  f"{model_cfg.K}_{model_cfg.hidden_channels}")
    ckpt = CheckpointManager(os.path.join(train_cfg.checkpoint_dir, setting_id))

    log_file = None
    if train_cfg.log_path:
        os.makedirs(os.path.dirname(train_cfg.log_path) or ".", exist_ok=True)
        log_file = open(train_cfg.log_path, "a")

    def emit(record):
        if log_file:
            log_file.write(json.dumps(record) + "\n")
            log_file.flush()

    best_test_nll = math.inf
    global_step = 0
    last_eval_step = -1

    def run_eval(epoch):
        nonlocal best_test_nll
        model.eval()
        test_nll = evaluate(model, test_loader, generator=eval_gen)
        model.train()
        if math.isfinite(test_nll) and test_nll < best_test_nll:
            best_test_nll = test_nll
            ckpt.save(global_step, model, metric=test_nll)
        log_fn(f"epoch {epoch}: test NLL {test_nll:.4f} "
               f"(best {best_test_nll:.4f})")
        emit({"step": global_step, "epoch": epoch, "test_nll": test_nll,
              "best_test_nll": best_test_nll})

    try:
        stop = False
        for epoch in range(train_cfg.epochs):
            for batch in train_loader:
                loss = train_step(model, opt, to_device(batch), gen)
                global_step += 1
                if global_step % LOG_EVERY == 0:
                    loss = float(loss)  # one host read per window
                    log_fn(f"epoch {epoch} step {global_step} nll {loss:.3f} "
                           f"bits/dim | lr {opt.lr:.3g} | "
                           f"{opt.total_notfinite} skipped")
                    emit({"step": global_step, "epoch": epoch, "nll": loss,
                          "skipped": opt.total_notfinite})
                if (train_cfg.eval_every_steps
                        and global_step % train_cfg.eval_every_steps == 0):
                    run_eval(epoch)
                    last_eval_step = global_step
                if train_cfg.max_steps and global_step >= train_cfg.max_steps:
                    stop = True
                    break
            epoch_eval = (train_cfg.eval_every_steps is None
                          and epoch % train_cfg.test_epoch_interval == 0)
            if (epoch_eval or stop) and last_eval_step != global_step:
                run_eval(epoch)
                last_eval_step = global_step
            if stop:
                break
    finally:
        if log_file:
            log_file.close()
    return model, best_test_nll


@torch.no_grad()
def sample_images(model, n: int, eps_std: float = 1.0, generator=None):
    """n samples as numpy (n, C, H, W) in [0, 1]: NaN -> -0.5, clipped to
    [-0.5, 0.5], shifted; also returns the NaN count before the clamp."""
    xs = model.sample(n, eps_std=eps_std, generator=generator).cpu().numpy()
    nan_count = int(np.isnan(xs).sum())
    xs = np.clip(np.where(np.isnan(xs), -0.5, xs), -0.5, 0.5) + 0.5
    return xs, nan_count


def save_sample_grid(model, path: str, n: int = 64, eps_std: float = 1.0,
                     generator=None):
    """Sample n images and write them as a PNG grid -> (path, NaN count)."""
    xs, nan_count = sample_images(model, n, eps_std, generator)
    cols = int(math.ceil(math.sqrt(n)))
    rows = int(math.ceil(n / cols))
    _, c, h, w = xs.shape
    grid = np.zeros((c, rows * h, cols * w), xs.dtype)
    for i in range(n):
        r, cc = divmod(i, cols)
        grid[:, r * h:(r + 1) * h, cc * w:(cc + 1) * w] = xs[i]
    img = (np.transpose(grid, (1, 2, 0)) * 255).astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_png(path, img)
    return path, nan_count
