"""Hand-written CUDA kernels of the port (counterpart of gpnf_tpu/ops/pallas).

Each module holds a wrapper with a `launches` count, the kernel's plain
PyTorch version, and the shape, dtype and device checks. The sources are in
gpnf_tpu_torch/csrc/; `_native` builds and loads them.
"""
from .fused_attention import (attention_proj_plain, attention_proj_plain_bwd,
                              fused_attention_proj, fused_attention_proj_bwd)
from .fused_mixlogcdf import mixlogcdf_forward, mixlogcdf_plain
from .fused_mixture_inverse import mixture_inverse, mixture_inverse_plain

KERNELS = (fused_attention_proj, fused_attention_proj_bwd, mixlogcdf_forward,
           mixture_inverse)


def reset_launch_counts() -> None:
    for kernel in KERNELS:
        kernel.launches = 0


def launch_counts() -> dict:
    return {kernel.__name__: kernel.launches for kernel in KERNELS}
