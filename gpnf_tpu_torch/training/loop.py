"""mAR-SCF evaluation and sampling.

Counterpart of `nll_metric`, `evaluate` and `save_sample_grid` in
gpnf_tpu/training/loop.py. Dequantisation and sampling noise come from
explicit torch.Generators on the model's device. Training arrives with
the training slice.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..utils.png import write_png


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
