"""Time the Cholesky kernels on the card against other versions of their source.

    python -m gpnf_tpu_torch.bench_cholesky --ref NAME=PATH [--ref ...] \\
        [--out FILE]

Builds gpnf_tpu_torch/csrc/cholesky.cu (`change`) and each --ref source,
another version of it (say the parent commit's, from `git show
<commit>:gpnf_tpu_torch/csrc/cholesky.cu`), all at once with the package's
nvcc flags. A ref's includes are found beside it first, then in the
package's csrc/. Then, on one card, for each build:

- its factor against float64 torch.linalg.cholesky, relative to max |L|,
  at every size below;
- the median device time of one call (a copy of A, then the factorization,
  as `kernels.cholesky` runs it; chip_smoke's cold-L2 timer, 20 calls) at
  n = 1000, 1024, 2048, 4096 in float32 and 1024, 4096 in float64, the
  builds timed in turns: refs, change, change, refs reversed (parent /
  change / change / parent), with torch.linalg.cholesky_ex beside them;
- one factorization under torch.profiler at n = 1024 and 4096 in both
  dtypes: launches and device time by kernel, hence the diagonal step's
  time per panel.

Prints the card's name and power limit and one JSON object per result, and
writes all of them to --out.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import time

import torch

from .ops.kernels import _native
from .utils.cuda_timing import Timer, card_line, trace

SIZES = ((1000, torch.float32), (1024, torch.float32), (2048, torch.float32),
         (4096, torch.float32), (1024, torch.float64), (4096, torch.float64))
PROFILE_SIZES = ((1024, torch.float32), (1024, torch.float64),
                 (4096, torch.float32), (4096, torch.float64))
OUT_DIR = _native.BUILD_DIR.parent / "bench_cholesky"


def build_all(sources):
    """Compile {name: path of a cholesky.cu} at once; return {name: loaded
    library} and {name: ptxas report}."""
    procs = {}
    for name, src in sources.items():
        d = OUT_DIR / name
        d.mkdir(parents=True, exist_ok=True)
        lib = d / "cholesky.so"
        cmd = [_native._nvcc(), *_native.NVCC_FLAGS, f"-I{_native.CSRC}",
               "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       lib)
    libs, reports, failed = {}, {}, []
    for name, (proc, lib) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{err}")
            continue
        reports[name] = out + err
        libs[name] = ctypes.CDLL(str(lib))
        for fn, argtypes in _native.SIGNATURES["cholesky"].items():
            getattr(libs[name], fn).argtypes = argtypes
            getattr(libs[name], fn).restype = ctypes.c_int
    if failed:
        raise RuntimeError("build failed:\n" + "\n".join(failed))
    return libs, reports


def factor(lib, a, out, inv):
    """`a` copied into `out` and factored there in place by `lib`."""
    out.copy_(a)
    fn = getattr(lib, f"gpnf_cholesky_{_native.SUFFIX[out.dtype]}")
    err = fn(out.data_ptr(), inv.data_ptr(), out.shape[0],
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"cholesky: CUDA error {err}")
    return out


def spd(n, dtype, device, seed=4321):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, n), generator=gen, device=device, dtype=torch.float64)
    return (x @ x.T / n + torch.eye(n, dtype=torch.float64,
                                    device=device)).to(dtype)


def by_kernel(fn):
    """{kernel name: [launches, device us]} of one call of `fn`, the copy
    of A left out."""
    out = {}
    for name, _, us in trace(fn)[0]:
        if name.startswith("chol_"):
            row = out.setdefault(name.split("<")[0], [0, 0.0])
            row[0] += 1
            row[1] += us
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ref", action="append", default=[],
                   help="NAME=PATH of another cholesky.cu to time beside")
    p.add_argument("--out", default=str(OUT_DIR / "bench_cholesky.json"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_cholesky: no CUDA device")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    refs = dict(spec.split("=", 1) for spec in args.ref)
    if "change" in refs:
        raise SystemExit("bench_cholesky: 'change' names the package's source")
    t0 = time.perf_counter()
    libs, reports = build_all({**refs, "change": _native.CSRC / "cholesky.cu"})
    results = [{"card": card, "build_s": time.perf_counter() - t0,
                "ptxas": {k: [ln.strip() for ln in v.splitlines()
                              if "registers" in ln or "spill" in ln]
                          for k, v in reports.items()}}]
    names = [*refs, "change"]
    timer = Timer(device)

    def emit(row):
        results.append(row)
        print(json.dumps(row), flush=True)

    for n, dtype in SIZES:
        a = spd(n, dtype, device)
        want = torch.linalg.cholesky(a.double())
        out = torch.empty_like(a)
        inv = torch.empty((64, 64), dtype=dtype, device=device)
        row = {"n": n, "dtype": str(dtype).removeprefix("torch."),
               "card": card}
        for name in names:
            l = factor(libs[name], a, out, inv).double()
            row[f"{name}_err"] = float((l - want).abs().max()
                                       / want.abs().max())
        times = {name: [] for name in names}
        for name in [*refs, "change", "change", *reversed(refs)]:
            times[name].append(timer(
                lambda lib=libs[name]: factor(lib, a, out, inv)))
        row.update({f"{name}_ms": times[name] for name in names})
        row["cholesky_ex_ms"] = timer(lambda: torch.linalg.cholesky_ex(a))
        emit(row)
    for n, dtype in PROFILE_SIZES:
        a = spd(n, dtype, device)
        out = torch.empty_like(a)
        inv = torch.empty((64, 64), dtype=dtype, device=device)
        for name in names:
            kernels = by_kernel(lambda lib=libs[name]: factor(lib, a, out, inv))
            emit({"profile": name, "n": n,
                  "dtype": str(dtype).removeprefix("torch."),
                  "launches": sum(c for c, _ in kernels.values()),
                  "device_us": sum(t for _, t in kernels.values()),
                  "by_kernel": {k: {"launches": c, "us": t,
                                    "us_per_launch": t / c}
                                for k, (c, t) in kernels.items()},
                  "card": card})
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
