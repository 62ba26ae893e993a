"""Hand-written CUDA kernels of the port (counterpart of gpnf_tpu/ops/pallas).

Each module holds a wrapper with a `launches` count, the kernel's plain
PyTorch version, and the shape, dtype and device checks. The sources are in
gpnf_tpu_torch/csrc/; `_native` builds and loads them.
"""
from .cholesky import (cholesky, cholesky_device_launches, cholesky_high,
                       cholesky_plain)
from .fused_attention import (attention_bwd_bf16, attention_dseq_gemm,
                              attention_dseq_gemm_bf16, attention_dw_gemm,
                              attention_dw_gemm_bf16,
                              attention_fwd_bf16,
                              attention_gemm_bf16_unaligned, attention_lanes,
                              attention_lanes_bwd,
                              attention_long_plain, attention_long_plain_bwd,
                              attention_long_qkv, attention_long_qkv_bwd,
                              attention_plain, attention_plain_bwd,
                              attention_proj_plain, attention_proj_plain_bwd,
                              attention_qkv_gemm, attention_qkv_gemm_bf16,
                              attention_route, core_bf16_padded,
                              fused_attention, fused_attention_bf16,
                              fused_attention_bwd, fused_attention_bwd_bf16,
                              fused_attention_long, fused_attention_long_bwd,
                              fused_attention_proj, fused_attention_proj_bwd,
                              fused_attention_qkv, fused_attention_qkv_bf16,
                              fused_attention_qkv_bwd,
                              fused_attention_qkv_bwd_bf16)
from .fused_coupling import fused_affine_forward, fused_affine_plain
from .fused_gated_conv import (fused_gated_conv, fused_gated_conv_bf16,
                               fused_gated_conv_bwd,
                               fused_gated_conv_bwd_bf16,
                               gated_conv_keep_plain, gated_conv_plain,
                               gated_conv_plain_bwd)
from .fused_mixlogcdf import mixlogcdf_forward, mixlogcdf_plain
from .fused_mixture_inverse import mixture_inverse, mixture_inverse_plain
from .trisolve import (tril_solve, tril_solve_device_launches,
                       tril_solve_plain)

KERNELS = (fused_attention_proj, fused_attention_proj_bwd, fused_attention_long,
           fused_attention_long_bwd, mixlogcdf_forward, mixture_inverse,
           fused_affine_forward, cholesky, tril_solve, fused_gated_conv,
           fused_gated_conv_bwd, fused_attention, fused_attention_bwd,
           fused_attention_qkv, fused_attention_qkv_bwd, attention_lanes,
           attention_lanes_bwd, attention_qkv_gemm, attention_dseq_gemm,
           attention_dw_gemm, attention_qkv_gemm_bf16, attention_fwd_bf16,
           attention_bwd_bf16, attention_dseq_gemm_bf16,
           attention_dw_gemm_bf16, fused_gated_conv_bf16,
           fused_gated_conv_bwd_bf16, fused_attention_bf16,
           fused_attention_bwd_bf16, fused_attention_qkv_bf16,
           fused_attention_qkv_bwd_bf16, cholesky_high)


def reset_launch_counts() -> None:
    for kernel in KERNELS:
        kernel.launches = 0


def launch_counts() -> dict:
    return {kernel.__name__: kernel.launches for kernel in KERNELS}
