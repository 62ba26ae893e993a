"""Adamax with the lagged, sample-counted warmup, skipping non-finite updates.

Counterpart of gpnf_tpu/training/optim.py (`reference_adamax`,
`reference_warmup`) and of the optimizer that gpnf_tpu/training/loop.py
builds from them: `optax.apply_if_finite(reference_adamax(
reference_warmup(lr, warm_up, batch_size)), max_consecutive_errors=100)`.

- `reference_adamax` replicates torch.optim.Adamax (eps inside the max of
  the infinity-norm buffer), so the port uses torch.optim.Adamax itself.
- `reference_warmup` is the original trainer's LambdaLR stepped with a
  sample count after each update: update n (0-based) runs at
  lr * min(1, max(n - 1, 0) * batch_size / warm_up), so updates 0 and 1
  run at lr 0. Here a LambdaLR with that factor, stepped once per update.
- apply_if_finite: an update whose gradients are not all finite changes
  nothing (parameters, moments and the schedule's count stay); after more
  than `max_consecutive_errors` such updates in a row it is applied
  anyway. Finiteness is read from the L1 norm of all gradients (one
  multi-tensor reduction), so a finite gradient whose norm overflows
  float32 counts as non-finite. Deciding costs one host read per update.
- `flatten_small` has no counterpart: it packs the tiny parameter leaves
  into one vector so that the TPU runs one update kernel instead of
  hundreds at its launch floor; torch's multi-tensor (foreach) Adamax
  already updates all tensors in a few kernels.
"""
from __future__ import annotations

from typing import Iterable

import torch


def warmup_factor(warm_up: int, batch_size: int):
    """LambdaLR factor of update n: min(1, max(n - 1, 0) * bs / warm_up)."""
    wu = float(max(warm_up, 1))
    return lambda n: min(1.0, max(n - 1, 0) * batch_size / wu)


class AdamaxWarmup:
    """torch.optim.Adamax + the lagged warmup + apply-if-finite."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float = 1e-4,
                 warm_up: int = 10000, batch_size: int = 64,
                 max_consecutive_errors: int = 100):
        self.params = [p for p in params if p.requires_grad]
        self.optimizer = torch.optim.Adamax(self.params, lr=lr,
                                            betas=(0.9, 0.999), eps=1e-8)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, warmup_factor(warm_up, batch_size))
        self.max_consecutive_errors = max_consecutive_errors
        self.notfinite_count = 0  # non-finite updates in a row
        self.total_notfinite = 0

    @property
    def lr(self) -> float:
        """The learning rate of the next applied update."""
        return self.optimizer.param_groups[0]["lr"]

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def grads_finite(self) -> bool:
        grads = [p.grad for p in self.params if p.grad is not None]
        return bool(torch.isfinite(torch.nn.utils.get_total_norm(grads, 1.0)))

    def step(self) -> bool:
        """Apply the update if the gradients are finite (or after too many
        non-finite ones in a row); returns whether it was applied."""
        if self.grads_finite():
            self.notfinite_count = 0
        else:
            self.notfinite_count += 1
            self.total_notfinite += 1
            if self.notfinite_count <= self.max_consecutive_errors:
                return False
        self.optimizer.step()
        self.scheduler.step()
        return True
