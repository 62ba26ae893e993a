"""Time the GP head's linear-algebra kernels on the card against other
versions of their source.

    python -m gpnf_tpu_torch.bench_linalg --kernel {cholesky,tril_solve} \\
        --ref NAME=PATH [--ref ...] [--out FILE]

Builds the package's gpnf_tpu_torch/csrc/<kernel>.cu (`change`) and each
--ref source, another version of it (say the parent commit's, from `git
show <commit>:gpnf_tpu_torch/csrc/<kernel>.cu`), all at once with the
package's nvcc flags. A ref's includes are found beside it first, then in
the package's csrc/. Then, on one card, for each build:

- its result against float64 torch.linalg (cholesky, solve_triangular),
  relative to the largest entry, at every shape below;
- the median device time of one call as the wrapper runs it (cholesky: a
  copy of A, then the factorization; tril_solve: a copy of b, the
  scratch's zero fill, then the solve), chip_smoke's cold-L2 timer, 20
  calls, the builds timed in turns: refs, change, change, refs reversed
  (parent / change / change / parent), with the library call beside them
  (torch.linalg.cholesky_ex, torch.linalg.solve_triangular);
- one call under torch.profiler at the profiled shapes: launches and
  device time by kernel.

For the Cholesky also the change's trailing_precision="high" at the JAX
package's default panel width (`hbm_panel_width(n)`), `change_high`: its
error against float64 and its time, taken in the same turns (refs,
change, change_high, change_high, change, refs reversed), and its device
time by kernel; and each ref's result against the change's, bit for bit
(`<ref>_same_bits`: a change that leaves "highest" alone keeps its bits).

cholesky: n = 1000, 1024, 2048, 4096 in float32 and 1024, 4096 in
float64. tril_solve: (n, p) = (1024, 1), (4096, 1), (1024, 1024),
(4096, 4096) and the posterior's (1024, 256) in float32, (4096, 1) and
(4096, 4096) in float64, both ways (L and L^T).

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
from .ops.kernels.cholesky import hbm_panel_width
from .ops.kernels.trisolve import tril_solve_scratch_words
from .utils.cuda_timing import Timer, card_line, trace

CHOL_SIZES = ((1000, torch.float32), (1024, torch.float32),
              (2048, torch.float32), (4096, torch.float32),
              (1024, torch.float64), (4096, torch.float64))
CHOL_PROFILE = ((1024, torch.float32), (1024, torch.float64),
                (4096, torch.float32), (4096, torch.float64))
SOLVE_SHAPES = ((1024, 1, torch.float32), (4096, 1, torch.float32),
                (1024, 1024, torch.float32), (4096, 4096, torch.float32),
                (1024, 256, torch.float32), (4096, 1, torch.float64),
                (4096, 4096, torch.float64))
SOLVE_PROFILE = ((1024, 1, torch.float32), (4096, 1, torch.float32),
                 (1024, 1024, torch.float32), (4096, 4096, torch.float32))
KERNEL_PREFIX = {"cholesky": "chol_", "tril_solve": "trsm_"}
OUT_DIR = _native.BUILD_DIR.parent / "bench_linalg"


def build_all(kernel, sources):
    """Compile {name: path of a <kernel>.cu} at once; return {name: loaded
    library} and {name: ptxas report}."""
    procs = {}
    for name, src in sources.items():
        d = OUT_DIR / kernel / name
        d.mkdir(parents=True, exist_ok=True)
        lib = d / f"{kernel}.so"
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
        for fn, argtypes in _native.SIGNATURES[kernel].items():
            if hasattr(libs[name], fn):  # a ref may predate an entry
                getattr(libs[name], fn).argtypes = argtypes
                getattr(libs[name], fn).restype = ctypes.c_int
    if failed:
        raise RuntimeError("build failed:\n" + "\n".join(failed))
    return libs, reports


def check(err, what):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def spd(n, dtype, device, seed=4321):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, n), generator=gen, device=device, dtype=torch.float64)
    return (x @ x.T / n + torch.eye(n, dtype=torch.float64,
                                    device=device)).to(dtype)


def dtype_name(dtype):
    return str(dtype).removeprefix("torch.")


def cholesky_case(n, dtype, device):
    """`a` copied into `out` and factored there in place by a build; the
    build "change_high" is the change's trailing_precision="high" at the
    default panel width."""
    a = spd(n, dtype, device)
    out = torch.empty_like(a)
    inv = torch.empty((64, 64), dtype=dtype, device=device)
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def run(lib, high=False):
        out.copy_(a)
        suffix = _native.SUFFIX[dtype]
        if high:
            check(getattr(lib, f"gpnf_cholesky_high_{suffix}")(
                out.data_ptr(), inv.data_ptr(), n, hbm_panel_width(n),
                stream()), "cholesky high")
            return out
        fn = getattr(lib, f"gpnf_cholesky_{suffix}")
        check(fn(out.data_ptr(), inv.data_ptr(), n, stream()), "cholesky")
        return out

    want = torch.linalg.cholesky(a.double())
    return ({"n": n, "dtype": dtype_name(dtype)}, run, want,
            lambda: torch.linalg.cholesky_ex(a), "cholesky_ex_ms")


def solve_case(n, p, dtype, trans, device, factors):
    """b copied into x, the scratch's flags zeroed (as the wrapper's fill;
    as many as 4-column tiles need, for any version), then a build's solve
    of op(L) x = b in place. The scratch is also large enough for an
    inverse per 64 x 64 diagonal tile (the parent's layout). `factors`
    caches L by (n, dtype)."""
    if (n, dtype) not in factors:
        factors[(n, dtype)] = torch.linalg.cholesky(
            spd(n, torch.float64, device)).to(dtype).contiguous()
    l = factors[(n, dtype)]
    gen = torch.Generator(device=device).manual_seed(n + p)
    b = torch.randn((n, p), generator=gen, device=device, dtype=dtype)
    x = torch.empty_like(b)
    words = max(tril_solve_scratch_words(n, p), 1 + -(-n // 64) * -(-p // 4))
    elem = torch.finfo(dtype).bits // 8
    scratch = torch.zeros(max(words, -(-n // 64) * 64 * 64 * elem // 4),
                          dtype=torch.int32, device=device)
    op = l.T if trans else l

    def run(lib):
        x.copy_(b)
        scratch[:words].zero_()
        fn = getattr(lib, f"gpnf_tril_solve_{_native.SUFFIX[dtype]}")
        check(fn(l.data_ptr(), x.data_ptr(), scratch.data_ptr(), n, p,
                 int(trans), torch.cuda.current_stream().cuda_stream),
              "tril_solve")
        return x

    want = torch.linalg.solve_triangular(op.double(), b.double(), upper=trans)
    return ({"n": n, "p": p, "trans": trans, "dtype": dtype_name(dtype)},
            run, want, lambda: torch.linalg.solve_triangular(op, b,
                                                             upper=trans),
            "solve_triangular_ms")


def cases(kernel, device, profile):
    """(key, run(lib), float64 reference, library call, its key) of each
    timed shape, or of each profiled one (the solve: L at p = 1, L^T at
    p = n, as the GP path runs them)."""
    if kernel == "cholesky":
        for n, dtype in CHOL_PROFILE if profile else CHOL_SIZES:
            yield cholesky_case(n, dtype, device)
        return
    factors = {}
    for n, p, dtype in SOLVE_PROFILE if profile else SOLVE_SHAPES:
        for trans in (p > 1,) if profile else (False, True):
            yield solve_case(n, p, dtype, trans, device, factors)


def by_kernel(fn, prefix):
    """{kernel name: [launches, device us]} of one call of `fn`: the
    kernels whose name starts with `prefix`, and the device launches of
    the call in all."""
    out, total = {}, 0
    for name, _, us in trace(fn)[0]:
        total += 1
        if name.startswith(prefix):
            row = out.setdefault(name.split("<")[0], [0, 0.0])
            row[0] += 1
            row[1] += us
    return out, total


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--kernel", choices=("cholesky", "tril_solve"),
                   required=True)
    p.add_argument("--ref", action="append", default=[],
                   help="NAME=PATH of another <kernel>.cu to time beside")
    p.add_argument("--out", default=None,
                   help="JSON output (default: build/bench_linalg/"
                        "<kernel>.json)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_linalg: no CUDA device")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    refs = dict(spec.split("=", 1) for spec in args.ref)
    if "change" in refs:
        raise SystemExit("bench_linalg: 'change' names the package's source")
    t0 = time.perf_counter()
    libs, reports = build_all(args.kernel, {
        **refs, "change": _native.CSRC / f"{args.kernel}.cu"})
    results = [{"kernel": args.kernel, "card": card,
                "build_s": time.perf_counter() - t0,
                "ptxas": {k: [ln.strip() for ln in v.splitlines()
                              if "registers" in ln or "spill" in ln]
                          for k, v in reports.items()}}]
    print(json.dumps(results[0]), flush=True)
    names = [*refs, "change"]
    # the builds timed in turns, each a runner of the library it names
    runners = {name: (lambda run, lib=libs[name]: run(lib)) for name in names}
    if args.kernel == "cholesky":
        names.append("change_high")
        runners["change_high"] = lambda run: run(libs["change"], high=True)
    turns = [*refs, *names[len(refs):], *reversed(names[len(refs):]),
             *reversed(refs)]
    timer = Timer(device)

    def emit(row):
        results.append(row)
        print(json.dumps(row), flush=True)

    for key, run, want, library, library_key in cases(args.kernel, device,
                                                      False):
        row = {**key, "card": card}
        scale = want.abs().max()
        change = runners["change"](run).clone()
        for name in names:
            got = runners[name](run)
            row[f"{name}_err"] = float((got.double() - want).abs().max()
                                       / scale)
            if name in refs:
                row[f"{name}_same_bits"] = torch.equal(got, change)
        times = {name: [] for name in names}
        for name in turns:
            times[name].append(timer(lambda f=runners[name]: f(run)))
        row.update({f"{name}_ms": times[name] for name in names})
        row[library_key] = timer(library)
        emit(row)
    for key, run, _, _, _ in cases(args.kernel, device, True):
        for name in names:
            kernels, total = by_kernel(lambda f=runners[name]: f(run),
                                       KERNEL_PREFIX[args.kernel])
            emit({"profile": name, **key,
                  "launches": sum(c for c, _ in kernels.values()),
                  "device_launches_all": total,
                  "device_us": sum(t for _, t in kernels.values()),
                  "by_kernel": {k: {"launches": c, "us": t,
                                    "us_per_launch": t / c}
                                for k, (c, t) in kernels.items()},
                  "card": card})
    out = args.out or str(OUT_DIR / f"{args.kernel}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
