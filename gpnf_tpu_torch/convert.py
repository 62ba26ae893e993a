"""Carry parameters between the JAX package and the port's modules.

The port's modules are named after the JAX parameter tree, so a JAX path
such as `levels/0/steps/coupling/net/blocks/3/attn/in_proj/v` is the
state-dict key `levels.0.steps.<j>.coupling.net.blocks.3.attn.in_proj.v`.
Two input forms are accepted:

- the nested pytree of numpy arrays (after `jax.device_get`);
- the flat `"params/levels/0/steps/..."` dict that the JAX
  `CheckpointManager` writes into its .npz files.

Each level's `steps` may be K-stacked (a leading K axis on every leaf, the
JAX default `scan_steps=True`) or a list of K step trees; stacked steps are
unstacked here, wherever they sit in the tree: a JAX `FlowGP` joint tree
{"gp": {...}, "flow": {...}} loads whole into the port's `FlowGP`, whose
state-dict keys are `gp.log_lengthscale` and `flow.levels.0...`. The
Gaussian-prior flow's splits are `splits/<i>/conv/{w,b,logs}` and the
affine coupling's convs carry `an_bias`/`an_logs` (Conv2d) or `b`/`logs`
(Conv2dZeros), the same names in both packages. A missing or extra key,
or a shape mismatch, raises. Leaves are cast to float32 unless the caller
asks for another dtype or, with dtype=None, keeps the source's (load into
a `model.double()` to run in float64). Parameters are float32 in both
packages under either compute dtype: a `compute_dtype="bfloat16"` model
holds, loads and saves the same float32 trees as a float32 one (its bf16
casts happen in the forward). `gp_params_from_jax` loads a JAX GP
hyperparameter dict alone.

`state_dict_to_jax` is the way back: the port's state dict as the flat
JAX dict with each level's K steps stacked again, the layout the JAX
`CheckpointManager` writes under "params/".
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

_STEPS = re.compile(r"^((?:[^/]+/)*?levels/\d+/steps)/(.+)$")
_STEP_KEY = re.compile(r"^((?:[^.]+\.)*?levels\.\d+\.steps)\.(\d+)\.(.+)$")
GP_KEYS = ("log_lengthscale", "log_variance", "log_noise")


def flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts/lists -> {"a/b/0/c": array}, the JAX checkpoint layout."""
    out = {}
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _as_flat(params: Any) -> Dict[str, np.ndarray]:
    is_flat = isinstance(params, Mapping) and all(
        not isinstance(v, (Mapping, list, tuple)) for v in params.values())
    flat = ({k: np.asarray(v) for k, v in params.items()} if is_flat
            else flatten(params))
    if flat and all(k.startswith("params/") for k in flat):
        flat = {k[len("params/"):]: v for k, v in flat.items()}
    return flat


def jax_to_state_dict(params: Any) -> Dict[str, np.ndarray]:
    """JAX mAR-SCF params (either form) -> {state-dict key: array}."""
    out = {}
    for key, value in _as_flat(params).items():
        m = _STEPS.match(key)
        if m and not m.group(2).split("/")[0].isdigit():  # K-stacked steps
            for j in range(value.shape[0]):
                out[f"{m.group(1)}/{j}/{m.group(2)}".replace("/", ".")] = value[j]
        else:
            out[key.replace("/", ".")] = value
    return out


def state_dict_to_jax(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """{state-dict key: tensor} -> {"levels/0/steps/...": array} with the K
    steps of each level stacked on a leading axis (inverse of
    `jax_to_state_dict`)."""
    out, steps = {}, {}
    for key, value in state.items():
        arr = value.detach().cpu().numpy()
        m = _STEP_KEY.match(key)
        if m:
            steps.setdefault((m.group(1), m.group(3)), {})[int(m.group(2))] = arr
        else:
            out[key.replace(".", "/")] = arr
    for (prefix, rest), by_step in steps.items():
        if sorted(by_step) != list(range(len(by_step))):
            raise ValueError(f"steps of {prefix} are not 0..K-1: "
                             f"{sorted(by_step)}")
        out[f"{prefix}.{rest}".replace(".", "/")] = np.stack(
            [by_step[j] for j in range(len(by_step))])
    return out


def load_jax_params(model: torch.nn.Module, params: Any,
                    dtype: Optional[torch.dtype] = torch.float32
                    ) -> torch.nn.Module:
    """Copy JAX params into `model` (on its device, cast to `dtype`, or in
    the source's dtype with dtype=None); raise on any mismatch."""
    arrays = jax_to_state_dict(params)
    expected = model.state_dict()
    missing = sorted(set(expected) - set(arrays))
    extra = sorted(set(arrays) - set(expected))
    if missing or extra:
        raise ValueError(f"checkpoint does not match the model: missing "
                         f"{missing[:8]}{'...' if len(missing) > 8 else ''}, "
                         f"extra {extra[:8]}{'...' if len(extra) > 8 else ''}"
                         f" — stale checkpoint for a different architecture?")
    state = {}
    for key, ref in expected.items():
        value = arrays[key]
        if tuple(value.shape) != tuple(ref.shape):
            raise ValueError(
                f"checkpoint leaf '{key}' has shape {tuple(value.shape)} but "
                f"the model expects {tuple(ref.shape)} — stale checkpoint for "
                f"a different architecture?")
        tensor = torch.from_numpy(np.array(value))
        state[key] = tensor if dtype is None else tensor.to(dtype)
    model.load_state_dict(state, strict=True)
    return model


def gp_params_from_jax(gp: torch.nn.Module, params: Mapping[str, Any],
                       dtype: Optional[torch.dtype] = torch.float32
                       ) -> torch.nn.Module:
    """Copy a JAX `GPRegression` param dict {"log_lengthscale",
    "log_variance", "log_noise"} into the port's `GPRegression`."""
    if set(params) != set(GP_KEYS):
        raise ValueError(f"GP params have keys {sorted(params)}, expected "
                         f"{sorted(GP_KEYS)}")
    return load_jax_params(gp, {k: np.asarray(v) for k, v in params.items()},
                           dtype)
