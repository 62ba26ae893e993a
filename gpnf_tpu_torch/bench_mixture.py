"""Time the mixture kernels on the card against other versions of their
sources.

    python -m gpnf_tpu_torch.bench_mixture [--kernel inverse|forward]
        [--ref NAME=DIR ...] [--out FILE]

DIR holds another version's csrc/ (its sources with the headers they
include): say the parent commit's, from `git archive <commit>
gpnf_tpu_torch/csrc | tar -x -C build/parent`, or a tuning variant, a copy
of csrc/ with one constant of mixture_lanes.cuh changed (kGroup for the
sweep of lane groups). Each ref source is built with the package's nvcc
flags and called through its C entry, whose signature every version
shares.

`--kernel inverse` (the default): `mixture_inverse.cu`, the sampling
pass's coupling inverse; `--kernel forward`: `mixlogcdf_forward.cu`, the
coupling forward of training and eval. At B 64, K 32 and D 1536 / 768 /
384 (the flagship's three levels) and at K 48, D 1536, for the change (the
package's wrapper) and each ref:

- the median device time of one call (chip_smoke's cold-L2 timer, 20
  calls), the versions in turns: refs, change, change, refs reversed; a
  ref that refuses the shape (K above its limit) is left out of it; and
  each once more after a flush that leaves L2's lines clean (the timer's
  flush leaves them dirty, and their write-back shares the memory bus);
- its output against the plain version on the card: the inverse bit for
  bit, with the plain version summing in that version's order (its
  `gpnf_mixture_group`, or k order for a version without one), and its
  residual max |CDF(x) - y|; the forward's max abs error (bar 1e-5); two
  calls bit for bit;
- the plain version's time and the bound: each input read once and each
  output written once at 3.35 TB/s, the operations of the module's
  OPS_PER_COMPONENT at 67 TFLOP/s (fp32 off the tensor cores), the larger;

and for every version the ptxas lines (registers, spills) and, from the
SASS of each kernel (`cuobjdump -sass`), its instructions, the
instructions of each loop body (the inverse's bisection and Newton
steps) and its special-function (MUFU) instructions by kind.

Prints the card's name and power limit and one JSON object per result, and
writes all of them to --out.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import statistics
import subprocess
import time

import torch

from .bench_attention import (_check, _ptxas_lines, _stream, _turns, bound,
                              build_refs)
from .ops import kernels, logistic
from .ops.kernels import _native
from .ops.kernels import fused_mixlogcdf as fm
from .ops.kernels import fused_mixture_inverse as fmi
from .utils.cuda_timing import Timer, card_line

SHAPES = ((64, 32, 1536), (64, 32, 768), (64, 32, 384), (64, 48, 1536))
SOURCES = {"inverse": "mixture_inverse", "forward": "mixlogcdf_forward"}
OUT_DIR = _native.BUILD_DIR.parent / "bench_mixture"


def sass_counts(lib_path):
    """{kernel: {"instructions": n, "loops": [instructions of each loop
    body, from a backward branch to its target], "mufu": {kind: n},
    "hmma": n, "hmma_ops": {opcode: n}}} of the SASS in one built library
    (cuobjdump -sass; an instruction every 16 bytes on sm_90; HMMA: the
    tensor cores' products, by shape and type, e.g.
    HMMA.16816.F32.BF16), with "hgmma_ops" {opcode: n} of the warpgroup
    products (HGMMA.64x96x16.F32.BF16 ...) and "tma_ops" {opcode: n} of the
    TMA's loads and stores (UTMALDG, UTMASTG)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    counts, row = {}, None
    for line in sass.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            row = counts[head.group(1)] = {"instructions": 0, "loops": [],
                                           "mufu": collections.Counter(),
                                           "hmma": 0,
                                           "hmma_ops": collections.Counter(),
                                           "hgmma_ops": collections.Counter(),
                                           "tma_ops": collections.Counter()}
            continue
        ins = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
        if row is None or not ins:
            continue
        addr, op = int(ins.group(1), 16), ins.group(2)
        row["instructions"] += 1
        if "HMMA." in op:
            row["hmma"] += 1
            row["hmma_ops"][re.search(r"HMMA\.\S+", op).group(0)] += 1
        hgmma = re.search(r"HGMMA\.\S+", op)
        if hgmma:
            row["hgmma_ops"][hgmma.group(0)] += 1
        tma = re.search(r"\bUTMA(?:LDG|STG)\b", op)
        if tma:
            row["tma_ops"][tma.group(0)] += 1
        for kind in re.findall(r"MUFU\.(\w+)", op):
            row["mufu"][kind] += 1
        target = re.search(r"BRA\s+0x([0-9a-f]+)", op)
        if target and int(target.group(1), 16) < addr:
            row["loops"].append((addr - int(target.group(1), 16)) // 16 + 1)
    return {k: dict(v, mufu=dict(v["mufu"]), hmma_ops=dict(v["hmma_ops"]),
                    hgmma_ops=dict(v["hgmma_ops"]),
                    tma_ops=dict(v["tma_ops"]))
            for k, v in counts.items()}


def _inverse_inputs(device, b, k, d, gen):
    randn = lambda *shape, s=1.0: torch.randn(shape, generator=gen,
                                              device=device) * s
    pi, mu, ls = randn(b, k, d), randn(b, k, d, s=2.0), randn(b, k, d, s=0.4)
    y = torch.exp(logistic.mixture_log_cdf(randn(b, d, s=2.0), pi, mu, ls))
    return y.clamp(1e-5, 1 - 1e-5).contiguous(), pi, mu, ls


def _forward_inputs(device, b, k, d, gen):
    randn = lambda *shape, s=1.0: torch.randn(shape, generator=gen,
                                              device=device) * s
    return (randn(b, d, s=0.5), randn(b, d, s=0.1), randn(b, d, s=0.1),
            randn(b, k, d), randn(b, k, d), randn(b, k, d, s=0.3))


def ref_inverse(lib, y, pi, mu, s):
    b, k, d = pi.shape
    x = torch.empty_like(y)
    _check(lib.gpnf_mixture_inverse(*(t.data_ptr() for t in (y, pi, mu, s, x)),
                                    b, k, d, _stream()), "ref mixture_inverse")
    return x


def ref_forward(lib, x, a, b_, pi, mu, s):
    b, k, d = pi.shape
    y, ldj = torch.empty_like(x), torch.empty_like(x)
    _check(lib.gpnf_mixlogcdf_forward(
        *(t.data_ptr() for t in (x, a, b_, pi, mu, s, y, ldj)), b, k, d,
        _stream()), "ref mixlogcdf_forward")
    return y, ldj


def _group(lib):
    """The lane group a version sums in: 1 (k order) before the lanes."""
    return lib.gpnf_mixture_group() if hasattr(lib,
                                               "gpnf_mixture_group") else 1


def rows(device, libs, timer, kind):
    clean = Timer(device, dirty=False)
    gen = torch.Generator(device=device).manual_seed(1234)
    for b, k, d in SHAPES:
        if kind == "inverse":
            args = _inverse_inputs(device, b, k, d, gen)
            versions = {"change": (lambda: kernels.mixture_inverse(*args),
                                   fmi.GROUP)}
            versions.update({name: (lambda lib=lib: ref_inverse(lib, *args),
                                    _group(lib)) for name, lib in libs.items()})
            plain = lambda: kernels.mixture_inverse_plain(*args)
            bytes_moved = 4 * (2 * b * d + 3 * b * k * d)
            ops = b * d * k * fmi.OPS_PER_COMPONENT
        else:
            args = _forward_inputs(device, b, k, d, gen)
            versions = {"change": (lambda: kernels.mixlogcdf_forward(*args),
                                   None)}
            versions.update({name: (lambda lib=lib: ref_forward(lib, *args),
                                    None) for name, lib in libs.items()})
            plain = lambda: kernels.mixlogcdf_plain(*args)
            bytes_moved = 4 * (3 * b * d + 3 * b * k * d + 2 * b * d)
            ops = b * d * k * fm.OPS_PER_COMPONENT
        row = {"kernel": kind, "shape": [b, k, d], "checks": {}}
        runs = {}
        for name, (run, group) in versions.items():
            try:
                got = run()
            except RuntimeError as err:  # a K above that version's limit
                row["checks"][name] = {"refused": str(err)}
                continue
            again = run()
            torch.cuda.synchronize()
            if kind == "inverse":
                want = kernels.mixture_inverse_plain(*args, group=group)
                got, again, want = [got], [again], [want]
            else:
                want = kernels.mixlogcdf_plain(*args)
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            check = {"max_abs_err": err,
                     "bit_for_bit_twice": all(torch.equal(g, a) for g, a in
                                              zip(got, again))}
            if kind == "inverse":
                check["equals_plain"] = torch.equal(got[0], want[0])
                check["group"] = group
                check["residual"] = float((torch.exp(logistic.mixture_log_cdf(
                    got[0], *args[1:])) - args[0]).abs().max())
            else:
                check["within_1e-5"] = all(torch.allclose(
                    g, w, rtol=1e-5, atol=1e-5) for g, w in zip(got, want))
            row["checks"][name] = check
            runs[name] = run
        row.update(_turns(timer, runs))
        # the same calls after a flush that leaves L2's lines clean: the
        # write-back of the dirty flush's lines shares the memory bus
        row["clean_l2_ms"] = {name: clean(run) for name, run in runs.items()}
        row["medians_ms"] = {name.removesuffix("_ms"): statistics.median(ms)
                             for name, ms in row.items()
                             if name.endswith("_ms") and isinstance(ms, list)}
        row["plain_ms"] = timer(plain)
        row["bound_ms"], row["bound_by"] = bound(bytes_moved, ops)
        yield row


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--kernel", choices=sorted(SOURCES), default="inverse",
                   help="the coupling inverse (sampling) or forward")
    p.add_argument("--ref", action="append", default=[],
                   help="NAME=DIR of another version's csrc/")
    p.add_argument("--out", default=None,
                   help="JSON output (default: build/bench_mixture/"
                        "<kernel>.json)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_mixture: no CUDA device")
    device = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    refs = dict(spec.split("=", 1) for spec in args.ref)
    if "change" in refs:
        raise SystemExit("bench_mixture: 'change' names the package's source")
    source = SOURCES[args.kernel]
    t0 = time.perf_counter()
    change_reports = _native.build([source])
    libs, reports = build_refs(refs, [source], _native.SIGNATURES, OUT_DIR)
    libs = {name: lib[source] for name, lib in libs.items()}
    _native.load(source)
    paths = {"change": _native.library_path(source),
             **{name: OUT_DIR / name / f"{source}.so" for name in refs}}
    head = {"card": card, "build_s": time.perf_counter() - t0,
            "ptxas": {**reports, **{f"change/{k}": _ptxas_lines(v)
                                    for k, v in change_reports.items()}},
            "sass": {name: sass_counts(path) for name, path in paths.items()}}
    print(json.dumps(head), flush=True)
    results = [head]
    for row in rows(device, libs, Timer(device), args.kernel):
        results.append(row)
        print(json.dumps(row), flush=True)
    out = args.out or str(OUT_DIR / f"{args.kernel}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
