"""Time the fused GatedConv's kernels on the card against other versions of
their source.

    python -m gpnf_tpu_torch.bench_gated_conv [--ref NAME=DIR ...] [--out FILE]

DIR holds another version's csrc/ (its sources with the headers they
include): say the parent commit's, from `git archive <commit>
gpnf_tpu_torch/csrc | tar -x -C build/parent`, or a tuning variant, a copy
of csrc/ with one constant of fused_gated_conv.cu changed. Each ref source
is built with the package's nvcc flags and called through its C entries:
a version with the tensor-core chain (`gated_conv_mma_kernel` in its
source) as the package's wrapper calls it, an older one (the SIMT kernels,
built for C in (8, 16, 96) only) with its own arguments (no forward
scratch, a weight-gradient partial every PARENT_K_CHUNK pixels).

At B 64, C 96 on 16x16 / 8x8 / 4x4 (the flagship's 32-px levels) and 32x32
(the 64-px level 0), and at B 16, C 512 (the CLIs' width) on 16x16 / 8x8 /
4x4, rate 0 and 0.2 (one seed: the same mask), for the change (the
package's wrapper) and each ref:

- the forward's and the backward's median device time (chip_smoke's
  cold-L2 timer, 20 calls), the versions in turns: refs, change, change,
  refs reversed; a ref that refuses the width (the parent at C 512) is
  left out of them;
- each version's error against the plain version on the card (forward
  within 1e-5 x max(1, max |out|), dx 1e-5 and each weight gradient 1e-4
  of its largest), two calls of each bit for bit, and whether each ref
  gives the change's bits;
- the plain version's times, the unfused chain's (the GatedConv module + x
  in NCHW: two cuDNN convs and ATen, the default path; forward, forward +
  backward) and the fused module's forward + backward (weight norm and the
  change's kernels);
- the bounds: the bytes and FLOP of `gated_conv_work` (each input read
  once and each output written once at 3.35 TB/s, 2 (9 2C C + 2C 2C) FLOP
  a pixel forward and three times that backward) at 3xTF32's 165 TFLOP/s
  on the tensor cores and at fp32's 67;
- the device launches of one call, from a profiler trace, against
  `gated_conv_plan`;

and for every version the ptxas lines (registers, spills) and, from the
SASS of each kernel (`cuobjdump -sass`), its instructions, the
instructions of each loop body and its HMMA (tensor-core) instructions.

With --dtype bfloat16 (MarScfConfig(compute_dtype="bfloat16",
fused_gated_conv=True)) it times the bf16 kernels instead, at the same
shapes and rates: in turns with the float32 kernels on the same values
(float32, bf16, bf16, float32), beside the plain bf16 versions and the
port's unfused bf16 chain (the GatedConv module + x in NCHW on bf16, the
default bf16 path: cuDNN convs and ATen; forward, forward + backward),
with each bf16 call's error against the plain bf16 version
(`gated_conv_bf16_readings`: within its bars, the weight gradients' worst
differences in three units, and the plain versions with each rounding
point of GATED_CONV_MOVED moved, which must miss the bars), two calls bit
for bit, its device launches against
`gated_conv_plan` and its bound at the bf16 tensor cores' 989 TFLOP/s;
the refs are not run, and the SASS is the bf16 instantiations'.

Prints the card's name and power limit and one JSON object per result, and
writes all of them to --out.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import os
import statistics
import time

import torch

from .bench_attention import (PEAK_BYTES, PEAK_OPS, PEAK_OPS_3XTF32, _check,
                              _ptxas_lines, _stream, _turns, bound,
                              build_refs)
from .bench_mixture import sass_counts
from .ops import kernels
from .ops.kernels import _native
from .ops.mixlogcdf import GatedConv
from .utils.cuda_timing import Timer, card_line, device_launches

# the module (the package exports a function of the same name)
fgc = importlib.import_module("gpnf_tpu_torch.ops.kernels.fused_gated_conv")

# (batch, H, W, C): the flagship's 32-px levels and the 64-px level 0, then
# the CLIs' width at the 32-px levels
SHAPES = ((64, 16, 16, 96), (64, 8, 8, 96), (64, 4, 4, 96), (64, 32, 32, 96),
          (16, 16, 16, 512), (16, 8, 8, 512), (16, 4, 4, 512))
RATES = (0.0, 0.2)
SOURCE = "fused_gated_conv"
OUT_DIR = _native.BUILD_DIR.parent / "bench_gated_conv"
PARENT_K_CHUNK = 512  # pixels a weight-gradient partial, before the chain
_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
# the C entries of a version before the tensor-core chain
PARENT_SIGNATURES = {
    "gpnf_gated_conv_fwd": [_P] * 7 + [_I] * 4 + [_U, _F, _P],
    "gpnf_gated_conv_bwd": [_P] * 16 + [_I] * 4 + [_U, _F, _I, _P],
}
NAMES = ("dx", "dw1", "db1", "dwg", "dbg")
PEAK_OPS_BF16 = 989e12  # dense bf16 on the tensor cores (NVIDIA data sheet)
BF16 = torch.bfloat16


def _threshold(rate):
    return (fgc.keep_threshold(rate), 1.0 / (1.0 - rate)) if rate else (0, 1.0)


def ref_fwd(lib, chain, x, w1, b1, wg, bg, rate, seed):
    """A ref's forward, called as its wrapper called it."""
    b, h, w, c = x.shape
    out = torch.empty_like(x)
    ptrs = [t.data_ptr() for t in (x, w1, b1, wg, bg, out)]
    floats = []
    if chain:  # twice the change's scratch: a ref may split more
        floats = [2 * fgc.gated_conv_plan(b, h, w, c, True)[0]]
        scratch = torch.empty(floats[0], device=x.device)
        ptrs.append(scratch.data_ptr())
    _check(lib.gpnf_gated_conv_fwd(seed.data_ptr() if rate else None, *ptrs,
                                   b, h, w, c, *_threshold(rate), *floats,
                                   _stream()),
           "ref gated conv forward")
    return out


def ref_bwd(lib, chain, x, w1, b1, wg, bg, g, rate, seed):
    """A ref's backward, called as its wrapper called it."""
    b, h, w, c = x.shape
    pixels = b * h * w
    grads = [torch.empty_like(t) for t in (x, w1, b1, wg, bg)]
    empty = lambda *shape: torch.empty(shape, device=x.device)
    if chain:  # twice the change's partials: a ref may split more
        floats = 2 * fgc.gated_conv_plan(b, h, w, c, rate > 0.0, True)[0]
        scratch = [empty(b, h, w, c), empty(b, h, w, 2 * c),
                   empty(b, h, w, 2 * c), empty(floats)]
        last = floats
    else:
        parts = -(-pixels // PARENT_K_CHUNK)
        scratch = [empty(b, h, w, c), empty(b, h, w, 2 * c),
                   empty(b, h, w, 2 * c), empty(parts, 18 * c + 1, c)]
        last = PARENT_K_CHUNK
    _check(lib.gpnf_gated_conv_bwd(
        seed.data_ptr() if rate else None,
        *(t.data_ptr() for t in (x, w1, b1, wg, bg, g, *grads, *scratch)),
        b, h, w, c, *_threshold(rate), last, _stream()),
        "ref gated conv backward")
    return grads


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _checks(fwd, bwd, args, g, rate, seed, change=None):
    """One version's errors against the plain versions and its repeats;
    against `change` (the change's (out, grads)), whether it gives the same
    bits."""
    out, again = fwd(), fwd()
    grads, grads_again = bwd(), bwd()
    torch.cuda.synchronize()
    same = None if change is None else torch.equal(out, change[0]) and all(
        torch.equal(a, b) for a, b in zip(grads, change[1]))
    want = kernels.gated_conv_plain(*args, rate, seed)
    want_b = kernels.gated_conv_plain_bwd(*args, g, rate, seed)
    fwd_err = float((out - want).abs().max())
    rel = {n: _rel(a, b) for n, a, b in zip(NAMES, grads, want_b)}
    return {"fwd_max_abs_err": fwd_err,
            "fwd_within": fwd_err <= 1e-5 * max(1.0, float(want.abs().max())),
            "bwd_rel_err": rel,
            "bwd_within": rel["dx"] <= 1e-5 and all(rel[n] <= 1e-4
                                                    for n in NAMES[1:]),
            "bit_for_bit_twice": torch.equal(out, again) and all(
                torch.equal(a, b) for a, b in zip(grads, grads_again)),
            "same_bits_as_change": same}


def _device_launches(fn):
    """Kernels one call of fn launches (a profiler trace)."""
    return sum(device_launches(fn).values())


def rows(device, libs, chains, timer):
    for batch, h, w, c in SHAPES:
        gen = torch.Generator().manual_seed(c + h)
        module = GatedConv(c, generator=gen).to(device)
        with torch.no_grad():
            w1 = module.conv.effective_weight().permute(2, 3, 1, 0).contiguous()
            wg = module.gate.effective_weight()[:, :, 0, 0].t().contiguous()
        b1, bg = module.conv.b.detach(), module.gate.b.detach()
        dgen = torch.Generator(device=device).manual_seed(h * 1000 + c)
        x = torch.randn((batch, h, w, c), generator=dgen, device=device)
        g = torch.randn((batch, h, w, c), generator=dgen, device=device)
        x_nchw = x.permute(0, 3, 1, 2).contiguous()
        g_nchw = g.permute(0, 3, 1, 2).contiguous()
        args = (x, w1, b1, wg, bg)
        pixels = batch * h * w
        for rate in RATES:
            seed = torch.tensor([97 + h], dtype=torch.int32, device=device)
            fwd = {"change": lambda: kernels.fused_gated_conv(*args, rate,
                                                              seed)}
            bwd = {"change": lambda: kernels.fused_gated_conv_bwd(
                *args, g, rate, seed)}
            for name, lib in libs.items():
                fwd[name] = (lambda lib=lib, ch=chains[name]: ref_fwd(
                    lib, ch, *args, rate, seed))
                bwd[name] = (lambda lib=lib, ch=chains[name]: ref_bwd(
                    lib, ch, *args, g, rate, seed))
            row = {"shape": [batch, h, w, c], "rate": rate, "checks": {}}
            change = fwd["change"](), bwd["change"]()
            for name in list(fwd):
                try:
                    row["checks"][name] = _checks(
                        fwd[name], bwd[name], args, g, rate, seed,
                        None if name == "change" else change)
                except RuntimeError as err:  # a width the version refuses
                    row["checks"][name] = {"refused": str(err)}
                    del fwd[name], bwd[name]
            with torch.no_grad():
                row["fwd"] = _turns(timer, fwd)
                row["bwd"] = _turns(timer, bwd)
                row["plain_fwd_ms"] = timer(
                    lambda: kernels.gated_conv_plain(*args, rate, seed))
                row["plain_bwd_ms"] = timer(
                    lambda: kernels.gated_conv_plain_bwd(*args, g, rate, seed))
            for part in ("fwd", "bwd"):
                row[part] = {"medians_ms": {
                    k.removesuffix("_ms"): statistics.median(v)
                    for k, v in row[part].items()}, **row[part]}
            module.drop_prob = rate
            module.train(rate > 0.0)  # the module's own Dropout2d
            chain = lambda xx: module(xx) + xx
            with torch.no_grad():
                row["unfused_fwd_ms"] = timer(lambda: chain(x_nchw))
            xr, xr_nchw = (t.clone().requires_grad_() for t in (x, x_nchw))
            params = list(module.parameters())
            row["unfused_fwd_bwd_ms"] = timer(lambda: torch.autograd.grad(
                chain(xr_nchw), [xr_nchw] + params, g_nchw))
            row["fused_module_fwd_bwd_ms"] = timer(
                lambda: torch.autograd.grad(module.apply_fused(xr),
                                            [xr] + params, g))
            module.eval()
            row["device_launches"] = {
                "fwd": _device_launches(fwd["change"]),
                "bwd": _device_launches(bwd["change"]),
                "predicted_fwd": fgc.gated_conv_plan(
                    batch, h, w, c, rate > 0.0)[1],
                "predicted_bwd": fgc.gated_conv_plan(
                    batch, h, w, c, rate > 0.0, True)[1]}
            for part in ("fwd", "bwd"):
                part_bytes, part_ops = fgc.gated_conv_work(pixels, c,
                                                           part == "bwd")
                row[f"{part}_bound_ms"], row[f"{part}_bound_by"] = bound(
                    part_bytes, part_ops, PEAK_OPS_3XTF32)
                row[f"{part}_bound_fp32_ms"] = max(
                    part_bytes / PEAK_BYTES, part_ops / PEAK_OPS) * 1e3
            yield row


def bf16_rows(device, timer):
    """The bf16 kernels' rows (--dtype bfloat16): SHAPES x RATES."""
    for batch, h, w, c in SHAPES:
        gen = torch.Generator().manual_seed(c + h)
        module = GatedConv(c, generator=gen).to(device)
        with torch.no_grad():
            w1 = module.conv.effective_weight(BF16).permute(
                2, 3, 1, 0).contiguous()
            wg = module.gate.effective_weight(BF16)[:, :, 0, 0].t(
                ).contiguous()
        b1, bg = module.conv.b.detach().to(BF16), module.gate.b.detach().to(
            BF16)
        dgen = torch.Generator(device=device).manual_seed(h * 1000 + c)
        x = torch.randn((batch, h, w, c), generator=dgen, device=device).to(
            BF16)
        g = torch.randn((batch, h, w, c), generator=dgen, device=device).to(
            BF16)
        args = (x, w1, b1, wg, bg)
        args32 = tuple(t.float() for t in args)
        g32 = g.float()
        x_nchw = x.permute(0, 3, 1, 2).contiguous()
        g_nchw = g.permute(0, 3, 1, 2).contiguous()
        pixels = batch * h * w
        for rate in RATES:
            seed = torch.tensor([97 + h], dtype=torch.int32, device=device)
            fwd = {"float32": lambda: kernels.fused_gated_conv(*args32, rate,
                                                               seed),
                   "change": lambda: kernels.fused_gated_conv(*args, rate,
                                                              seed)}
            bwd = {"float32": lambda: kernels.fused_gated_conv_bwd(
                       *args32, g32, rate, seed),
                   "change": lambda: kernels.fused_gated_conv_bwd(
                       *args, g, rate, seed)}
            row = {"shape": [batch, h, w, c], "rate": rate, "dtype": "bf16"}
            with torch.no_grad():
                out, again = fwd["change"](), fwd["change"]()
                grads, grads_again = bwd["change"](), bwd["change"]()
                got = (out, *grads)
                readings = fgc.gated_conv_bf16_readings(got, *args, g, rate,
                                                        seed)
                moved = {m: fgc.gated_conv_bf16_readings(
                    got, *args, g, rate, seed, (m,))
                    for m in fgc.GATED_CONV_MOVED}
            row["checks"] = {
                "max_abs_err": {n: readings[n]["max_abs"]
                                for n in fgc.GATED_CONV_RESULTS},
                "within_bars": readings["held"], "readings": readings,
                "moved_caught": {m: not r["held"] for m, r in moved.items()},
                "moved_readings": moved,
                "bit_for_bit_twice": torch.equal(out, again) and all(
                    torch.equal(a, b) for a, b in zip(grads, grads_again))}
            with torch.no_grad():
                row["fwd"] = _turns(timer, fwd)
                row["bwd"] = _turns(timer, bwd)
                row["plain_fwd_ms"] = timer(
                    lambda: kernels.gated_conv_plain(*args, rate, seed))
                row["plain_bwd_ms"] = timer(
                    lambda: kernels.gated_conv_plain_bwd(*args, g, rate,
                                                         seed))
            for part in ("fwd", "bwd"):
                row[part] = {"medians_ms": {
                    k.removesuffix("_ms"): statistics.median(v)
                    for k, v in row[part].items()}, **row[part]}
            module.drop_prob = rate
            module.train(rate > 0.0)  # the module's own Dropout2d
            chain = lambda xx: module(xx) + xx
            with torch.no_grad():
                row["unfused_fwd_ms"] = timer(lambda: chain(x_nchw))
            xr, xr_nchw = (t.clone().requires_grad_() for t in (x, x_nchw))
            params = list(module.parameters())
            row["unfused_fwd_bwd_ms"] = timer(lambda: torch.autograd.grad(
                chain(xr_nchw), [xr_nchw] + params, g_nchw))
            row["fused_module_fwd_bwd_ms"] = timer(
                lambda: torch.autograd.grad(module.apply_fused(xr),
                                            [xr] + params, g))
            module.eval()
            row["device_launches"] = {
                "fwd": _device_launches(fwd["change"]),
                "bwd": _device_launches(bwd["change"]),
                "predicted_fwd": fgc.gated_conv_plan(
                    batch, h, w, c, rate > 0.0, dtype=BF16)[1],
                "predicted_bwd": fgc.gated_conv_plan(
                    batch, h, w, c, rate > 0.0, True, dtype=BF16)[1]}
            for part in ("fwd", "bwd"):
                part_bytes, part_ops = fgc.gated_conv_work(
                    pixels, c, part == "bwd", BF16)
                row[f"{part}_bound_ms"], row[f"{part}_bound_by"] = bound(
                    part_bytes, part_ops, PEAK_OPS_BF16)
            yield row


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ref", action="append", default=[],
                   help="NAME=DIR of another version's csrc/")
    p.add_argument("--out", default=str(OUT_DIR / "bench.json"),
                   help="JSON output")
    p.add_argument("--dtype", choices=("float32", "bfloat16"),
                   default="float32",
                   help="bfloat16: the bf16 kernels against the float32 "
                        "ones and the unfused bf16 chain (no refs)")
    args = p.parse_args(argv)
    if args.dtype == "bfloat16" and args.ref:
        raise SystemExit("bench_gated_conv: --dtype bfloat16 runs no refs")
    if not torch.cuda.is_available():
        raise SystemExit("bench_gated_conv: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products sum in fp32, as the JAX package's
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    device = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    refs = dict(spec.split("=", 1) for spec in args.ref)
    if "change" in refs:
        raise SystemExit("bench_gated_conv: 'change' names the package's "
                         "source")
    chains = {name: "gated_conv_mma_kernel" in open(
        os.path.join(d, f"{SOURCE}.cu")).read() for name, d in refs.items()}
    t0 = time.perf_counter()
    change_reports = _native.build([SOURCE])
    libs, reports = build_refs(refs, [SOURCE], _native.SIGNATURES, OUT_DIR)
    libs = {name: lib[SOURCE] for name, lib in libs.items()}
    for name, lib in libs.items():
        if not chains[name]:
            for fn, argtypes in PARENT_SIGNATURES.items():
                getattr(lib, fn).argtypes = argtypes
    _native.load(SOURCE)
    paths = {"change": _native.library_path(SOURCE),
             **{name: OUT_DIR / name / f"{SOURCE}.so" for name in refs}}
    bf16 = args.dtype == "bfloat16"  # the bf16 instantiations, else the rest
    sass = {name: {k: {"instructions": v["instructions"], "hmma": v["hmma"],
                       "hmma_ops": dict(v["hmma_ops"]), "loops": v["loops"]}
                   for k, v in sass_counts(path).items()
                   if ("OpBf16" in k) == bf16}
            for name, path in paths.items()}
    head = {"card": card, "build_s": time.perf_counter() - t0,
            "ptxas": {**reports, **{f"change/{k}": _ptxas_lines(v)
                                    for k, v in change_reports.items()}},
            "sass": sass}
    print(json.dumps(head), flush=True)
    results = [head]
    gen = (bf16_rows(device, Timer(device)) if bf16 else
           rows(device, libs, chains, Timer(device)))
    for row in gen:
        results.append(row)
        print(json.dumps(row), flush=True)
    for row in results[1:]:
        if bf16:
            ck = row["checks"]
            rss = {n: (round(ck["readings"][n]["over_rss"], 3),
                       round(ck["readings"][n]["rms_over_rss"], 3))
                   for n in NAMES[1:]}
            med = lambda part: " ".join(f"{k} {v:.4f}" for k, v in
                                        row[part]["medians_ms"].items())
            print(f"bf16 {row['shape']} rate {row['rate']}: fwd "
                  f"[{med('fwd')}] bwd [{med('bwd')}] ms; plain bf16 "
                  f"{row['plain_fwd_ms']:.4f} / {row['plain_bwd_ms']:.4f}; "
                  f"unfused bf16 {row['unfused_fwd_ms']:.4f} / "
                  f"{row['unfused_fwd_bwd_ms']:.4f}; fused module fwd+bwd "
                  f"{row['fused_module_fwd_bwd_ms']:.4f}; bounds bf16 "
                  f"{row['fwd_bound_ms'] * 1e3:.2f} / "
                  f"{row['bwd_bound_ms'] * 1e3:.2f} us; within the bars "
                  f"{ck['within_bars']}, bit for bit twice "
                  f"{ck['bit_for_bit_twice']}, weight gradients over 2^-8 "
                  f"(sum (ab)^2)^1/2 (worst, rms) {rss}, "
                  f"moved rounding points caught {ck['moved_caught']}; "
                  f"launches {row['device_launches']}", flush=True)
            continue
        med = lambda part: " ".join(f"{k} {v:.4f}" for k, v in
                                    row[part]["medians_ms"].items())
        print(f"{row['shape']} rate {row['rate']}: fwd [{med('fwd')}] bwd "
              f"[{med('bwd')}] ms; plain {row['plain_fwd_ms']:.4f} / "
              f"{row['plain_bwd_ms']:.4f}; unfused {row['unfused_fwd_ms']:.4f}"
              f" / {row['unfused_fwd_bwd_ms']:.4f}; fused module fwd+bwd "
              f"{row['fused_module_fwd_bwd_ms']:.4f}; bounds 3xTF32 "
              f"{row['fwd_bound_ms'] * 1e3:.2f} / "
              f"{row['bwd_bound_ms'] * 1e3:.2f} us, fp32 "
              f"{row['fwd_bound_fp32_ms'] * 1e3:.2f} / "
              f"{row['bwd_bound_fp32_ms'] * 1e3:.2f} us; launches "
              f"{row['device_launches']}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
