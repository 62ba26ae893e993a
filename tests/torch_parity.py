"""Shared pieces of the port's parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; JAX
runs on the CPU (conftest.py), the port with device="cpu", so its kernel
wrappers take their plain PyTorch versions.
"""
import json
import os

import jax
import numpy as np
import torch

from gpnf_tpu_torch import convert

# GPNF_TORCH_PARITY_REPORT=<file>: every close() appends its measured max
# abs difference there (the maxima quoted in CHANGES.md come from it)
REPORT = os.environ.get("GPNF_TORCH_PARITY_REPORT")

# The suite runs in parallel workers that keep every core busy; there torch's
# OpenMP pool waits on descheduled threads at each of the thousands of small
# ops of a whole-model test (a 6 s CLI test took 375 s). One thread each.
torch.set_num_threads(1)


def rng(seed=0):
    return np.random.default_rng(seed)


def normal(r, shape, scale=1.0):
    return (r.standard_normal(shape) * scale).astype(np.float32)


def t(a):
    """numpy/JAX array -> CPU float32 torch tensor."""
    return torch.from_numpy(np.array(a, dtype=np.float32))


def n(x):
    """torch tensor or JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def close(got, want, rtol=1e-5, atol=1e-5):
    got, want = n(got), n(want)
    if REPORT:
        _record(got, want, rtol, atol)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _record(got, want, rtol, atol):
    """One JSON line per comparison: the test, the max abs difference and
    the tolerance it was held to."""
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    test = os.environ.get("PYTEST_CURRENT_TEST", "").split(" ")[0]
    with open(REPORT, "a") as f:
        f.write(json.dumps({"test": test, "max_abs": float(diff.max(initial=0)),
                            "rtol": rtol, "atol": atol}) + "\n")


def load(module, jax_params):
    """Copy a JAX param tree into the port module of the same layout."""
    return convert.load_jax_params(module, jax.device_get(jax_params))
