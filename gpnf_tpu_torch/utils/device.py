"""Device selection: the card by default, the CPU only when asked for."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """torch.device for `device`; raise rather than fall back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device here: the port runs on the card by default; "
                "pass device='cpu' to run its plain PyTorch versions instead")
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device
