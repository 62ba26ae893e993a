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


# -- the 3xTF32 arithmetic of the tensor-core kernels (csrc/mma_tf32.cuh) --
def tf32_round(x):
    """float32 values rounded to TF32 as cvt.rna.tf32.f32 rounds them: to
    nearest, ties away from zero, the low 13 mantissa bits cleared (half
    the dropped part added to the magnitude's bits, a carry rounding up,
    which is what `tf32_bits` does); inf and NaN stay as they are."""
    a = np.atleast_1d(np.ascontiguousarray(x, dtype=np.float32))
    bits = a.view(np.uint32)
    finite = (bits & np.uint32(0x7F800000)) != np.uint32(0x7F800000)
    rounded = (bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return np.where(finite, rounded, bits).astype(np.uint32).view(np.float32)


def split(x):
    """(hi, lo) of a float32 tensor: hi = tf32(x), lo = tf32(x - hi)."""
    hi = torch.from_numpy(tf32_round(x.numpy())).reshape(x.shape)
    lo = torch.from_numpy(tf32_round((x - hi).numpy())).reshape(x.shape)
    return hi, lo


def mm3(a, b, sets=1):
    """a @ b in 3xTF32 as `mma_3xtf32` runs it: k steps of 8 in order, each
    lo*hi, hi*lo, then hi*hi into one float32 accumulator; with `sets`
    above 1, step i into accumulator i % sets, the sets added in order at
    the end (the forward's S = q K^T, the dK/dV kernel's S^T and dPd^T)."""
    ah, al = split(a)
    bh, bl = split(b)
    shape = a.shape[:-1] + b.shape[-1:]
    acc = [torch.zeros(shape) for _ in range(sets)]
    for step, k0 in enumerate(range(0, a.shape[-1], 8)):
        p = step % sets
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            acc[p] = acc[p] + x[..., k0:k0 + 8] @ y[..., k0:k0 + 8, :]
    total = acc[0]
    for part in acc[1:]:
        total = total + part
    return total


def load(module, jax_params):
    """Copy a JAX param tree into the port module of the same layout."""
    return convert.load_jax_params(module, jax.device_get(jax_params))
