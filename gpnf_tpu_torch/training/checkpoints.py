"""Restore mAR-SCF weights from the JAX package's npz checkpoints.

Counterpart of the best-checkpoint restore of
gpnf_tpu/training/checkpoints.py: a checkpoint directory holds `best.npz`,
a flat {"params/levels/0/...": array} dict. Saving, keep-N, step
checkpoints and resume arrive with the training slice.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from ..convert import load_jax_params


def read_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def restore_best(model: torch.nn.Module, directory: str) -> torch.nn.Module:
    """Load `<directory>/best.npz` into `model`."""
    return load_jax_params(model, read_npz(os.path.join(directory, "best.npz")))
