"""Build, load and call the port's CUDA kernels.

Each source in `gpnf_tpu_torch/csrc/` is compiled by nvcc into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds) and loaded with ctypes. Libraries land in `build/gpnf_tpu_torch/`
at the root of the checkout, named by a hash of their source and flags, so
an edited source is rebuilt and an unchanged one is reused. Nothing is
built when this module is imported: the first CUDA call of a kernel builds
it, or `build()` builds several at once (one nvcc process per source, all
started together).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "gpnf_tpu_torch"
# -fno-gnu-unique: a static local of an inline or template function (the
# bf16 forward's once-a-kernel shared-memory attribute) is otherwise one
# object for the whole process, and two libraries that instantiate the same
# template (fused_attention_long and fused_attention_bf16 both launch the
# packed bf16 kernels) would share it: the second's kernel would launch
# without its attribute set
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xcompiler",
              "-fno-gnu-unique", "-Xptxas", "-v")
SOURCES = ("fused_attention_long", "mixlogcdf_forward", "mixture_inverse",
           "fused_affine", "tril_solve", "cholesky", "fused_gated_conv",
           "fused_attention", "fused_attention_bf16", "attention_gemm")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signature of every entry point: argument types, restype int (a cudaError_t)
SIGNATURES = {
    "fused_attention_long": {
        "gpnf_attention_long_fwd": [_P] * 3 + [_I] * 4 + [_F, _U, _F, _P],
        "gpnf_attention_long_bwd": [_P] * 5 + [_I] * 4 + [_F, _U, _F, _P],
        "gpnf_attention_long_fwd_bf16": [_P] * 4 + [_I] * 4 + [_F, _U, _F,
                                                               _P],
        "gpnf_attention_long_bwd_bf16": [_P] * 7 + [_I] * 4 + [_F, _F, _I,
                                                               _U, _F, _P],
    },
    "mixlogcdf_forward": {
        "gpnf_mixlogcdf_forward": [_P] * 8 + [_I, _I, _I, _P],
    },
    "mixture_inverse": {
        "gpnf_mixture_inverse": [_P] * 5 + [_I, _I, _I, _P],
        "gpnf_mixture_group": [],
    },
    "fused_affine": {
        "gpnf_fused_affine_f32": [_P] * 5 + [_I, _I, _P],
        "gpnf_fused_affine_f64": [_P] * 5 + [_I, _I, _P],
    },
    "tril_solve": {
        "gpnf_tril_solve_f32": [_P] * 3 + [_I] * 3 + [_P],
        "gpnf_tril_solve_f64": [_P] * 3 + [_I] * 3 + [_P],
    },
    "cholesky": {
        "gpnf_cholesky_f32": [_P, _P, _I, _P],
        "gpnf_cholesky_f64": [_P, _P, _I, _P],
        "gpnf_cholesky_high_f32": [_P, _P, _I, _I, _P],
        "gpnf_cholesky_high_f64": [_P, _P, _I, _I, _P],
        "gpnf_cholesky_trailing_high_f32": [_P, _P, _I, _I, _I, _P],
        "gpnf_cholesky_trailing_high_f64": [_P, _P, _I, _I, _I, _P],
    },
    "fused_gated_conv": {
        "gpnf_gated_conv_fwd": [_P] * 8 + [_I] * 4 + [_U, _F, _L, _P],
        "gpnf_gated_conv_bwd": [_P] * 16 + [_I] * 4 + [_U, _F, _L, _P],
        "gpnf_gated_conv_fwd_bf16": [_P] * 8 + [_I] * 4 + [_U, _F, _L, _P],
        "gpnf_gated_conv_bwd_bf16": [_P] * 17 + [_I] * 4 + [_U, _F, _L, _P],
        "gpnf_gated_conv_plan": [_I] * 8 + [ctypes.POINTER(_L),
                                            ctypes.POINTER(_I)],
    },
    "fused_attention": {
        "gpnf_attention_fwd": [_P] * 5 + [_I] * 4 + [_U, _F, _P],
        "gpnf_attention_bwd": [_P] * 9 + [_I] * 4 + [_U, _F, _P],
        "gpnf_attention_qkv_fwd": [_P] * 3 + [_I] * 4 + [_F, _U, _F, _P],
        "gpnf_attention_qkv_bwd": [_P] * 5 + [_I] * 4 + [_F, _U, _F, _P],
    },
    "fused_attention_bf16": {
        "gpnf_attention_fwd_bf16": [_P] * 5 + [_I] * 4 + [_U, _F, _P],
        "gpnf_attention_bwd_bf16": [_P] * 9 + [_I] * 4 + [_U, _F, _P],
        "gpnf_attention_qkv_fwd_bf16": [_P] * 4 + [_I] * 4 + [_F, _U, _F,
                                                              _P],
        "gpnf_attention_qkv_bwd_bf16": [_P] * 7 + [_I] * 4 + [_F, _F, _I,
                                                              _U, _F, _P],
    },
    "attention_gemm": {
        "gpnf_attention_gemm": [_P] * 4 + [_I] * 6 + [_P],
        "gpnf_attention_gemm_bf16": [_P] * 5 + [_I] * 7 + [_P],
        "gpnf_attention_gemm_bf16_unaligned": [_P] * 3 + [_I] * 6 + [_P],
    },
}
# the C entry point's suffix for each dtype a kernel takes
SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card, from gpnf_tpu_torch/csrc/")


def library_path(name: str) -> Path:
    """The library of one source, named by a hash of the source, the shared
    headers of csrc/ and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile the named sources that are not built yet, all at once.

    Returns {name: ptxas report} for the sources compiled by this call (the
    registers, shared memory and spills of each kernel)."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{stderr}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        reports[name] = stdout + stderr
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check_cuda_inputs(kernel: str, *, dtypes=(torch.float32,),
                      **tensors: torch.Tensor) -> torch.device:
    """Raise unless every tensor is a contiguous CUDA tensor on one device,
    all of one dtype among `dtypes` (the kernel's instantiations). Tensors
    that require grad are taken as they are: the kernels run inside the
    forward and backward of `torch.autograd.Function`s."""
    device, dtype = None, None
    for arg, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{kernel}: '{arg}' is on {t.device}, the kernel "
                             f"takes CUDA tensors only")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{kernel}: '{arg}' is on {t.device}, expected "
                             f"{device}")
        if t.dtype not in dtypes or (dtype is not None and t.dtype != dtype):
            raise TypeError(f"{kernel}: '{arg}' has dtype {t.dtype}, the "
                            f"kernel takes one of {tuple(dtypes)}, the same "
                            f"for every input")
        dtype = t.dtype
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: '{arg}' is not contiguous")
    return device


def launch(name: str, fn: str, device: torch.device, *args) -> None:
    """Call one C entry point on the current stream of `device`; raise on a
    non-zero cudaError_t (a refused launch never runs and would otherwise go
    unnoticed)."""
    lib = load(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err}")
