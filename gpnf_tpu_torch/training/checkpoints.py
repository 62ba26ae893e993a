"""mAR-SCF checkpoints in the JAX package's npz layout.

Counterpart of gpnf_tpu/training/checkpoints.py `CheckpointManager`: a
directory holds `step_<N>.npz` (flat {"params/levels/0/steps/...": array}
dicts, each level's K steps stacked as the JAX model keeps them),
`meta.json` with the best metric and its step, and `best.npz`, a copy of
the checkpoint with the lowest metric. The `keep` newest step files stay,
and every multiple of `keep_every`. A checkpoint written here restores in
the JAX package and the other way round. Saves are synchronous (the JAX
package can overlap them with training on a thread).
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Dict, Optional

import numpy as np
import torch

from ..convert import load_jax_params, state_dict_to_jax


def read_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 2, keep_every: int = 10000):
        self.dir = directory
        self.keep = keep
        self.keep_every = keep_every
        os.makedirs(directory, exist_ok=True)

    def _meta_path(self):
        return os.path.join(self.dir, "meta.json")

    def _load_meta(self):
        if os.path.exists(self._meta_path()):
            with open(self._meta_path()) as f:
                return json.load(f)
        return {"best_metric": None, "best_step": None}

    def _save_meta(self, meta):
        tmp = self._meta_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, self._meta_path())

    def save(self, step: int, model: torch.nn.Module,
             metric: Optional[float] = None) -> bool:
        """Write the model's parameters; True if `metric` is the new best
        (lower is better)."""
        flat = {f"params/{k}": v
                for k, v in state_dict_to_jax(model.state_dict()).items()}
        path = os.path.join(self.dir, f"step_{step}.npz")
        tmp = path + ".tmp.npz"
        np.savez(tmp, **flat)
        os.replace(tmp, path)

        meta = self._load_meta()
        is_best = False
        if metric is not None and np.isfinite(metric):
            if meta["best_metric"] is None or metric < meta["best_metric"]:
                meta["best_metric"] = float(metric)
                meta["best_step"] = step
                shutil.copyfile(path, os.path.join(self.dir, "best.npz"))
                is_best = True
        self._save_meta(meta)
        self._gc()
        return is_best

    def _steps(self):
        steps = []
        for fn in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)\.npz", fn)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def _gc(self):
        for s in self._steps()[: -self.keep]:
            if self.keep_every and s > 0 and s % self.keep_every == 0:
                continue
            os.remove(os.path.join(self.dir, f"step_{s}.npz"))

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, model: torch.nn.Module, step: Optional[int] = None,
                best: bool = False) -> torch.nn.Module:
        """Load a step's checkpoint (the newest by default, or best.npz)."""
        if best:
            path = os.path.join(self.dir, "best.npz")
        else:
            step = self.latest_step() if step is None else step
            if step is None:
                raise FileNotFoundError(f"no checkpoint in {self.dir}")
            path = os.path.join(self.dir, f"step_{step}.npz")
        return load_jax_params(model, read_npz(path))
