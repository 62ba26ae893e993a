"""Time attention kernels on the card against other versions of their
sources.

    python -m gpnf_tpu_torch.bench_attention
        [--kernel proj|gemm|rows|lanes|lanes_bwd|rows_bwd|train]
        [--ref NAME=DIR ...]
        [--dtype float32|bfloat16] [--ref-splits parent|change]
        [--targets N,...] [--out FILE]

DIR holds another version's csrc/ (its sources with the headers they
include): say the parent commit's, from `git archive <commit>
gpnf_tpu_torch/csrc | tar -x -C build/parent`. Each ref source is built
with the package's nvcc flags and called through its C entry as that
version's wrappers called it; a tuning variant is a copy of csrc/ with one
constant changed.

`--kernel rows`: the forward at Dh <= 64 (the kernel of the core entries,
the long entry at the 64-px level 0, the wide route at padded narrow widths
and the proj forward's second stage), through fused_attention_long.cu's
`gpnf_attention_long_fwd` (qkv in, out), at 4 heads, B 64 and Dh 4, 8, 24
and 64 (C = 4 Dh; other widths by --head-dims), each at S = 256, 64, 16,
512, 100 (the core entries' shapes) and 1024 (the long entry's), rate 0
and 0.2: measured as `lanes` below measures it.

`--kernel lanes`: the forward at Dh = 128 and 256 (the kernel that
`attention_lanes` counts), through `gpnf_attention_long_fwd`, at the shapes
and rates of `lanes_bwd` below: the change (`attention_long_qkv`) and each
ref in the same turns; out against the plain forward on the card (relative
to its largest entry, and the max abs error); two calls bit for bit; SDPA
after a head split at rate 0 beside them; both bounds (two S x S x Dh
products and five operations a score, at 3xTF32's rate and at fp32's); one
call of each under torch.profiler; and the ptxas lines of every version's
kernels.

`--kernel lanes_bwd`: the backward at Dh = 128 and 256 (the kernels that
`attention_lanes_bwd` counts), through fused_attention_long.cu's
`gpnf_attention_long_bwd` (qkv, g, dqkv and the (B, H, S, 3) stats
scratch, the C signature every version since the lane-split kernels
has), at 4 heads and (B, C, S) = (16, 512, 256), (16, 512, 64), (16, 512,
16) (the CLIs' default width at the 32-px levels, Dh 128) and (4, 1024,
256) (Dh 256), rate 0 and 0.2: the change (`attention_long_qkv_bwd`) and
each ref in turns, refs, change, change, refs reversed (the median device
time of one call, chip_smoke's cold-L2 timer, 20 calls); dqkv against the
plain backward on the card (relative to its largest entry); two calls bit
for bit; autograd of SDPA at rate 0 beside them; both bounds (five S x S x
Dh products and five operations a score at the fp32 rate off the tensor
cores, 67 TFLOP/s, and at 3xTF32's, 495 / 3 = 165 TFLOP/s); one call of
each under torch.profiler (device time by kernel); and the ptxas lines
(registers, spills) of every version's kernels.

`--kernel rows_bwd`: the backward at Dh <= 64 (the kernels that the proj
backward's middle stage and the 64-px level 0 run, which only their entry
counts), measured as `lanes_bwd` measures it, at 4 heads and (B, C, S) =
(64, 96, 256), (64, 96, 64), (64, 96, 16), (64, 96, 1024) (Dh 24: the
flagship's 32-px levels and the 64-px level 0), (64, 192, 64) (Dh 48),
(16, 256, 256) (Dh 64), (64, 32, 256) (Dh 8) and (64, 16, 256) (Dh 4),
rate 0 and 0.2.

`--kernel gemm`: the projection GEMMs (qkv = seq w^T, dseq = dqkv w, dW =
dqkv^T seq; attention_gemm.cu's `gpnf_attention_gemm`, the 11-argument C
entry every version since the split K has) at the 21 products of
`gemm_cases` (B 64, C 96 at S 256 / 64 / 16, C 192 at S 64, B 16, C 512
at S 256 / 64 / 16): the change (K split by `gemm_splits`) and each ref
(K split as the SIMT kernel's wrapper split it, `parent_gemm_splits`, or
with `--ref-splits change` by `gemm_splits`, for a tuning variant of the
change) in turns, refs, change, change, refs reversed, `torch.mm` beside
them; the error against torch.matmul; two calls bit for bit; the bounds
at 3xTF32's rate and at fp32's, and the bytes'; the change at the splits
`gemm_splits` gives for other targets of blocks (`--targets`), the sweep
that chose GEMM_BLOCKS; one call of each under torch.profiler; and the
ptxas lines of every version.

`--kernel proj` (the default): `fused_attention_proj` at B = 64, 4 heads,
(C, S) = (96, 256), (96, 64), (96, 16) (the flagship's 32-px levels; the
64-px levels 1 and 2 have the shapes of the first two) and (192, 64) (Dh =
48), rate 0 and 0.2, against each ref's fused_attention_proj.cu:

- the forward: the change (its two stages, `attention_qkv_gemm` and the
  tensor-core forward) and each ref's fused kernel
  (`gpnf_attention_proj_fwd`, every version that has the file) in turns,
  refs, change, change, refs reversed; out against the plain forward (max
  abs error, and relative to its largest entry); two calls bit for bit;
  the change's stages timed alone; F.linear + SDPA at rate 0 beside them;
  the bound (the projection and two S x S x Dh products at 3xTF32's rate);
  peak device memory of one call over its inputs; one call of each under
  torch.profiler;
- the backward (`kernels.fused_attention_proj_bwd`) and the in-kernel
  backward of each ref that has one (`gpnf_attention_proj_bwd`, with dqkv
  and ceil(B S / 1024) partial dW slabs as scratch: the versions before
  the staged backward) in the same turns: dseq and dW against the plain
  backward, two calls bit for bit, the change's stages timed alone,
  autograd of F.linear + SDPA at rate 0 beside them, the bound, and one
  call of each under torch.profiler.

`--kernel gemm --dtype bfloat16`: the bf16 GEMM (attention_gemm.cu's
`gpnf_attention_gemm_bf16`, on TMA and wgmma) at BF16_GEMM_SHAPES (B 64,
C 96 at S 256 / 64 / 16, the flagship's 32-px levels; C 192 at S 64; B 16,
C 512 at S 256), qkv, dseq and dW through their wrappers, and each ref's
bf16 entry (the 12-argument one of the mma.sync kernel before it, K split
by `gemm_splits`, the partials added by a second launch) in turns, refs,
change, change, refs reversed, torch.matmul on bf16 beside them: the error
against the plain version (`bf16_product_close`; dW within K 2^-24 sum
|products| of `dw_plain`, and its largest error over sum |products|
against the float64 product, the plain version's beside it), two calls bit
for bit, the bound at 989 TFLOP/s and 3.35 TB/s, each call's device
launches (a CUDA graph) and host microseconds (no synchronize; the
change's wrapper, the change called as a ref is called, and each C entry
alone on outputs made beforehand), one call of each under torch.profiler,
the change's plan (tile, splits, ring), the change at every split count of
BF16_SPLIT_SWEEP for dseq and dW, and the ptxas lines of every version.

`--kernel rows --dtype bfloat16`: the bf16 forward (attention_wgmma.cuh's
`attention_wgmma_fwd_kernel`, counted by `attention_fwd_bf16`) at
BF16_FWD_SHAPES (BF16_SHAPES below and B 4, C 1024, S 256: Dh 256), rate 0
and 0.2, without and with its statistics' store, and each ref's
`gpnf_attention_long_fwd_bf16` in turns, refs, change, change, refs
reversed, SDPA on bf16 beside them: out against the plain version (over
the 2^-7 max |v| bar), the statistics against `attention_stats_plain`,
two calls bit for bit, out the same bits with and without the store,
device launches a call (a CUDA graph), host microseconds a call (the
wrapper; the C entry called as a ref is; each C entry alone on an output
made beforehand, in turns), the bounds (bytes, the two products at the
dense bf16 rate, one exponential a score at PEAK_EXP), device time by
kernel, and the SASS of every version's forward (HGMMA, UTMALDG, MUFU;
the key loop's FP32 and integer instructions a score, `key_loop_counts`).

`--dtype bfloat16` (with `--kernel rows_bwd` or `proj`): the bf16 kernels
(MarScfConfig(compute_dtype="bfloat16")) at BF16_SHAPES, B 64, C 96 at S
256 / 64 / 16 (the flagship's 32-px levels, the proj entry's dq recipe),
S 1024 (the 64-px level 0) and B 16, C 512 at S 256 (the CLIs' default
width; both the long entry's recipe), rate 0 and 0.2. `rows_bwd`: the dq
and dK/dV pair (`attention_long_qkv_bwd` with the forward's statistics,
`attention_bwd_bf16`) and each ref's `gpnf_attention_long_bwd_bf16` in
turns, a ref from before the forward kept its statistics (its source has
no `dsum`) called with its own (B, H, S, 3) scratch; dqkv against the
plain bf16 backward (each third relative to its largest entry, the bar
2^-7); two calls bit for bit; autograd of SDPA on the bf16 heads at rate 0;
the bound at the dense bf16 rate (989 TFLOP/s: five S x S x Dh products;
qkv, g and the statistics in, dqkv out); the bf16 forward with and without
its statistics' store in turns (out bit for bit the same); device time by
kernel. `proj`: the bf16 proj backward (`fused_attention_proj_bwd` with the
statistics) and, for each ref, the package's GEMMs around the ref's pair,
in turns, beside autograd of F.linear + SDPA on bf16. `train`: the bf16
flagship's train step (L 3, K 4, C 96, batch 64, dropout 0.2, Adamax;
`bench.py`'s default step) at 32 px and at 64 px, on the synthetic sets,
in windows of TRAIN_WINDOW_STEPS steps timed on the host clock to a loss
read, in turns, refs, change, change, refs reversed (TRAIN_TURNS rounds),
each ref's pair patched in place of the package's
(`attention_long_qkv_bwd`) with the rest of the step the package's; train
images/s from the median window; the peak device memory of a step with
each pair, and with no statistics kept, beside what was allocated before
it.

Prints the card's name and power limit and one JSON object per result, and
writes all of them to --out.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import importlib
import json
import os
import re
import shutil
import statistics
import subprocess
import threading
import time

import torch
import torch.nn.functional as F

from .ops import kernels
from .ops.kernels import _native
from .utils.cuda_timing import Timer, card_line, trace

fa = importlib.import_module("gpnf_tpu_torch.ops.kernels.fused_attention")

HEADS = 4
PROJ_SHAPES = ((64, 96, 256), (64, 96, 64), (64, 96, 16), (64, 192, 64))
WIDE_SHAPES = ((16, 512, 256), (16, 512, 64), (16, 512, 16))
RATES = (0.0, 0.2)
TARGETS = (132, 264, 528, 1056, 2112)
REF_K_CHUNK = 1024  # the ref wrappers' (b, s) rows per dW partial
# (B, C, S) of each --kernel that times the key-tiled kernels alone; `rows`
# at each width of --head-dims (C = 4 Dh)
ROW_LENGTHS = (256, 64, 16, 512, 100, 1024)
ATTENTION_SHAPES = {
    "rows_bwd": ((64, 96, 256), (64, 96, 64), (64, 96, 16), (64, 96, 1024),
                 (64, 192, 64), (16, 256, 256), (64, 32, 256), (64, 16, 256)),
    "lanes": ((16, 512, 256), (16, 512, 64), (16, 512, 16), (4, 1024, 256))}
ATTENTION_SHAPES["lanes_bwd"] = ATTENTION_SHAPES["lanes"]
# H100 SXM (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s off the tensor
# cores, and dense TF32 FLOP/s over the three products of 3xTF32 (a kernel
# on the tensor cores is read against this one), and dense bf16 FLOP/s
PEAK_BYTES, PEAK_OPS, PEAK_OPS_3XTF32 = 3.35e12, 67e12, 495e12 / 3
PEAK_OPS_BF16 = 989e12
# --kernel train: the flagship's configuration, windows and rounds of turns
TRAIN_CONFIG = dict(L=3, K=4, hidden_channels=96, num_blocks=10,
                    num_components=32, drop_prob=0.2, prior_hidden=32,
                    prior_layers=3, compute_dtype="bfloat16")
TRAIN_BATCH, TRAIN_WINDOW_STEPS, TRAIN_TURNS = 64, 5, 2
# (B, C, S) of --dtype bfloat16
BF16_SHAPES = ((64, 96, 256), (64, 96, 64), (64, 96, 16), (64, 96, 1024),
               (16, 512, 256))
# --kernel gemm --dtype bfloat16: the flagship's 32-px levels, the C 192
# step's level 1, the CLIs' C 512 at the 32-px level 0; the splits swept for
# dseq and dW
BF16_GEMM_SHAPES = ((64, 96, 256), (64, 96, 64), (64, 96, 16), (64, 192, 64),
                    (16, 512, 256))
BF16_SPLIT_SWEEP = (1, 2, 4, 6, 8, 16, 24, 32, 40, 48, 56, 64, 96, 128)
# --kernel rows --dtype bfloat16: BF16_SHAPES and Dh 256 (C 1024, B 4)
BF16_FWD_SHAPES = BF16_SHAPES + ((4, 1024, 256),)
# the H100's special-function unit: ex2 results a second (132 SMs x 16 a
# clock at ~1.8 GHz; the FlashAttention-3 paper's figure), the bf16
# forward's floor at one exponential a score
PEAK_EXP = 3.9e12
OUT_DIR = _native.BUILD_DIR.parent / "bench_attention"
_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
# the refs' C entries; a ref source need not have every entry of its file
# (the proj forward's file lost its backward with the staged backward)
REF_SIGNATURES = {
    "fused_attention_proj": {
        "gpnf_attention_proj_fwd": [_P] * 4 + [_I] * 4 + [_U, _F, _P],
        "gpnf_attention_proj_bwd": [_P] * 8 + [_I] * 4 + [_U, _F, _I, _P]},
    # the bf16 entry of a ref from before the TMA + wgmma kernel (the
    # mma.sync kernel's: a, b, c, the split partials, m, n, k, trans_a,
    # trans_b, splits, out_bf16)
    "attention_gemm": {"gpnf_attention_gemm": [_P] * 4 + [_I] * 6 + [_P],
                       "gpnf_attention_gemm_bf16": [_P] * 4 + [_I] * 7 + [_P]},
    "fused_attention_long": {
        "gpnf_attention_long_fwd": [_P] * 3 + [_I] * 4 + [_F, _U, _F, _P],
        "gpnf_attention_long_bwd": [_P] * 5 + [_I] * 4 + [_F, _U, _F, _P],
        "gpnf_attention_long_fwd_bf16": [_P] * 4 + [_I] * 4 + [_F, _U, _F,
                                                               _P],
        "gpnf_attention_long_bwd_bf16": [_P] * 7 + [_I] * 4 + [_F, _F, _I,
                                                               _U, _F, _P]},
}
# the bf16 entries of a fused_attention_long.cu from before the forward kept
# its statistics for the backward (no `dsum` in the source)
REF_SIGNATURES_BF16_STATELESS = {
    "gpnf_attention_long_fwd_bf16": [_P] * 3 + [_I] * 4 + [_F, _U, _F, _P],
    "gpnf_attention_long_bwd_bf16": [_P] * 5 + [_I] * 4 + [_F, _F, _I, _U, _F,
                                                           _P]}
# the sources each --kernel builds from each ref, and from the package
REF_SOURCES = {"proj": ("fused_attention_proj",),
               "gemm": ("attention_gemm",),
               "rows": ("fused_attention_long",),
               "lanes": ("fused_attention_long",),
               "lanes_bwd": ("fused_attention_long",),
               "rows_bwd": ("fused_attention_long",),
               "train": ("fused_attention_long",)}
CHANGE_SOURCES = {**REF_SOURCES,
                  "proj": ("attention_gemm", "fused_attention_long")}
# the SIMT GEMM's split of K (64 x 64 output tiles, 32-row chunks, aimed
# at 8 blocks for each of the 132 SMs): how its wrapper called it
PARENT_TILE, PARENT_BLOCKS = 64, 8 * 132


def build_refs(refs, sources, signatures=REF_SIGNATURES, out_dir=OUT_DIR):
    """{name: {source: loaded library}} of each ref DIR, all compiled at once
    with the package's flags into out_dir/NAME/, and {name/source: ptxas
    lines}; `signatures` gives each source's C entries."""
    procs = {}
    for name, src_dir in refs.items():
        out = out_dir / name
        out.mkdir(parents=True, exist_ok=True)
        for source in sources:
            lib = out / f"{source}.so"
            cmd = [_native._nvcc(), *_native.NVCC_FLAGS, f"-I{src_dir}", "-o",
                   str(lib), os.path.join(src_dir, f"{source}.cu")]
            procs[(name, source)] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True), lib)
    libs, reports, failed = {}, {}, []
    for (name, source), (proc, lib) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}/{source}: nvcc exit {proc.returncode}\n{err}")
            continue
        reports[f"{name}/{source}"] = _ptxas_lines(out + err)
        loaded = ctypes.CDLL(str(lib))
        table = dict(signatures[source])
        loaded.stateless_bf16 = (source == "fused_attention_long" and "dsum"
                                 not in open(os.path.join(
                                     refs[name], f"{source}.cu")).read())
        if loaded.stateless_bf16:
            table.update(REF_SIGNATURES_BF16_STATELESS)
        for fn, argtypes in table.items():
            if hasattr(loaded, fn):
                getattr(loaded, fn).argtypes = argtypes
                getattr(loaded, fn).restype = ctypes.c_int
        libs.setdefault(name, {})[source] = loaded
    if failed:
        raise RuntimeError("build failed:\n" + "\n".join(failed))
    return libs, reports


def _ptxas_lines(report):
    return [ln.strip() for ln in report.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]


def _check(err, what):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _stream():
    return torch.cuda.current_stream().cuda_stream


def ref_proj_bwd(lib, seq, w, g, rate, seed):
    """A ref's in-kernel backward, called as its wrapper called it."""
    b, s, c = seq.shape
    parts = -(-b * s // REF_K_CHUNK)
    dqkv = torch.empty((b, s, 3 * c), device=seq.device)
    partial = torch.empty((parts, 3 * c, c), device=seq.device)
    dseq, dw = torch.empty_like(seq), torch.empty_like(w)
    _check(lib.gpnf_attention_proj_bwd(
        seed.data_ptr() if rate > 0 else None, seq.data_ptr(), w.data_ptr(),
        g.data_ptr(), dqkv.data_ptr(), partial.data_ptr(), dseq.data_ptr(),
        dw.data_ptr(), b, s, c, HEADS, fa.keep_threshold(rate) if rate else 0,
        1.0 / (1.0 - rate), REF_K_CHUNK, _stream()), "ref proj bwd")
    return dseq, dw


def parent_gemm_splits(m, n, k):
    """`gemm_splits` as the SIMT GEMM's wrapper computed it."""
    tiles = -(-m // PARENT_TILE) * -(-n // PARENT_TILE)
    if tiles >= PARENT_BLOCKS:
        return 1
    chunks = -(-k // fa.GEMM_KC)
    per_split = max(1, chunks // -(-PARENT_BLOCKS // tiles))
    return -(-chunks // per_split)


def ref_split_gemm(lib, a, b, shape, m, n, k, trans_a, trans_b, splits):
    """A ref's GEMM with a split K, called as its wrapper called it."""
    c = torch.empty(shape, device=a.device)
    partial = (torch.empty((splits, m, n), device=a.device) if splits > 1
               else None)
    _check(lib.gpnf_attention_gemm(
        a.data_ptr(), b.data_ptr(), c.data_ptr(),
        None if partial is None else partial.data_ptr(), m, n, k,
        int(trans_a), int(trans_b), splits, _stream()), "ref gemm")
    return c


def bound(bytes_moved, ops, peak_ops=PEAK_OPS):
    """(least ms, "bytes" or "operations") at the card's memory rate and
    `peak_ops`: PEAK_OPS for SIMT fp32, PEAK_OPS_3XTF32 for a kernel whose
    products run on the tensor cores."""
    t_bytes, t_ops = bytes_moved / PEAK_BYTES, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _rel(got, want):
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


def library_bwd(seq, w, g):
    """Autograd of F.linear + SDPA (rate 0), the graph built once: the
    call whose time stands beside the backward's."""
    seq_r, w_r = seq.clone().requires_grad_(), w.clone().requires_grad_()
    b, s, c = seq.shape
    with torch.enable_grad():
        k, v, q = (x.reshape(b, s, HEADS, c // HEADS).transpose(1, 2)
                   for x in F.linear(seq_r, w_r).split(c, dim=-1))
        out = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(
            b, s, c)
    return lambda: torch.autograd.grad(out, (seq_r, w_r), g,
                                       retain_graph=True)


def by_kernel(fn):
    """{kernel name: [launches, device us]} of one call of `fn`."""
    out = {}
    for name, _, us in trace(fn)[0]:
        row = out.setdefault(name.split("<")[0], [0, 0.0])
        row[0] += 1
        row[1] += us
    return out


# opcode classes of `key_loop_counts`: FP32-pipe arithmetic, integer
# arithmetic and logic (by the SASS opcode's first word)
FP32_OPS = ("FFMA", "FADD", "FMUL", "FMNMX", "FSEL", "FSETP", "FSET")
INT_OPS = ("IMAD", "IADD3", "IADD", "LOP3", "LOP", "SHF", "ISETP", "IMNMX",
           "SEL", "LEA", "PRMT", "IABS", "POPC", "FLO", "BMSK", "BREV")


def key_loop_counts(lib_path, pattern, scores_a_tile):
    """{kernel: counts} of each kernel of a built library whose name holds
    `pattern`: the opcodes of its key loop (the longest loop body of its
    SASS, cuobjdump -sass, from a backward branch's target to the branch)
    by class, and per score. A tile's softmax takes one MUFU.EX2 a score
    and 2 for the rows' corrections, so the loop body's scores are its EX2
    count times n / (n + 2), n = scores_a_tile(kernel name), the scores a
    thread holds of one key tile."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    funcs, name = {}, None
    for line in sass.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            name = head.group(1)
            funcs[name] = [] if pattern in name else None
            continue
        ins = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
        if name and funcs.get(name) is not None and ins:
            funcs[name].append((int(ins.group(1), 16), ins.group(2).strip()))
    out = {}
    for fn, code in funcs.items():
        if not code:
            continue
        spans = [(int(t.group(1), 16), addr) for addr, op in code
                 for t in [re.search(r"BRA\s+(?:`\(\S+\)\s*)?0x([0-9a-f]+)",
                                     op)]
                 if t and int(t.group(1), 16) < addr]
        if not spans:
            continue
        lo, hi = max(spans, key=lambda s: s[1] - s[0])
        ops = collections.Counter(
            re.sub(r"^@!?U?P\w+\s+", "", op).split()[0].split(".")[0]
            for addr, op in code if lo <= addr <= hi)
        fp32 = sum(n for op, n in ops.items() if op in FP32_OPS)
        ints = sum(n for op, n in ops.items() if op in INT_OPS)
        ex2 = sum(1 for addr, op in code
                  if lo <= addr <= hi and "MUFU.EX2" in op)
        n = scores_a_tile(fn)
        scores = ex2 * n / (n + 2)
        out[fn] = {"instructions": sum(ops.values()), "ex2": ex2,
                   "scores": scores, "fp32": fp32, "int": ints,
                   "fp32_a_score": fp32 / scores if scores else None,
                   "int_a_score": ints / scores if scores else None,
                   "all_a_score": sum(ops.values()) / scores if scores
                   else None, "opcodes": dict(ops.most_common())}
    return out


def ref_proj_fwd(lib, seq, w, rate, seed):
    """A ref's fused forward, called as its wrapper called it."""
    b, s, c = seq.shape
    out = torch.empty_like(seq)
    _check(lib.gpnf_attention_proj_fwd(
        seed.data_ptr() if rate > 0 else None, seq.data_ptr(), w.data_ptr(),
        out.data_ptr(), b, s, c, HEADS,
        fa.keep_threshold(rate) if rate else 0, 1.0 / (1.0 - rate),
        _stream()), "ref proj fwd")
    return out


def library_fwd(seq, w):
    """F.linear + SDPA (rate 0): the calls whose time stands beside the
    forward's."""
    b, s, c = seq.shape
    k, v, q = (x.reshape(b, s, HEADS, c // HEADS).transpose(1, 2)
               for x in F.linear(seq, w).split(c, dim=-1))
    return F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(
        b, s, c)


def _with(libs, fn):
    """{name: library} of the refs whose fused_attention_proj exports fn."""
    return {name: lib["fused_attention_proj"] for name, lib in libs.items()
            if hasattr(lib["fused_attention_proj"], fn)}


def _turns(timer, runs):
    """{name: [ms, ...]} of each run, timed in turns: refs, change, change,
    refs reversed."""
    refs = [name for name in runs if name != "change"]
    times = {name: [] for name in runs}
    for name in [*refs, "change", "change", *reversed(refs)]:
        times[name].append(timer(runs[name]))
    return {f"{name}_ms": ms for name, ms in times.items()}


def proj_rows(device, libs, timer, card):
    fwd_refs = _with(libs, "gpnf_attention_proj_fwd")
    bwd_refs = _with(libs, "gpnf_attention_proj_bwd")
    for batch, c, s in PROJ_SHAPES:
        gen = torch.Generator(device=device).manual_seed(c + s)
        seq = torch.randn((batch, s, c), generator=gen, device=device) * 0.5
        w = torch.randn((3 * c, c), generator=gen, device=device) * 0.1
        g = torch.randn((batch, s, c), generator=gen, device=device)
        seed = torch.tensor([4321 + s], dtype=torch.int32, device=device)
        dh = c // HEADS
        proj = 2 * batch * s * c * 3 * c
        core = 2 * batch * HEADS * s * s * dh
        scores = batch * HEADS * s * s
        for rate in RATES:
            runs = {name: (lambda lib=lib: ref_proj_fwd(lib, seq, w, rate,
                                                       seed))
                    for name, lib in fwd_refs.items()}
            runs["change"] = lambda: kernels.fused_attention_proj(
                seq, w, HEADS, rate, seed)
            want = kernels.attention_proj_plain(seq, w, HEADS, rate, seed)
            bound_ms, bound_by = bound(4 * (2 * batch * s * c + 3 * c * c),
                                       proj + 2 * core + 5 * scores,
                                       PEAK_OPS_3XTF32)
            row = {"kind": "proj_fwd", "batch": batch, "C": c, "S": s,
                   "rate": rate, "card": card, "bound_ms": bound_ms,
                   "bound_by": bound_by, "bound_peak": "3xTF32 165 TFLOP/s"}
            for name, run in runs.items():
                got = run()
                row[f"{name}_max_abs_err"] = float((got - want).abs().max())
                row[f"{name}_err"] = _rel(got, want)
                row[f"{name}_repeats"] = torch.equal(got, run())
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(device)
                base = torch.cuda.memory_allocated(device)
                run()
                torch.cuda.synchronize()
                row[f"{name}_peak_bytes_over_inputs"] = (
                    torch.cuda.max_memory_allocated(device) - base)
            row.update(_turns(timer, runs))
            qkv = kernels.attention_qkv_gemm(seq, w)
            row["stages_ms"] = {
                "qkv_gemm": timer(lambda: kernels.attention_qkv_gemm(seq, w)),
                "long_fwd": timer(lambda: kernels.attention_long_qkv(
                    qkv, HEADS, rate, seed))}
            row["library_ms"] = (timer(lambda: library_fwd(seq, w))
                                 if rate == 0.0 else None)
            row["profile"] = {name: by_kernel(run)
                              for name, run in runs.items()}
            yield row

            runs = {name: (lambda lib=lib: ref_proj_bwd(lib, seq, w, g, rate,
                                                       seed))
                    for name, lib in bwd_refs.items()}
            runs["change"] = lambda: kernels.fused_attention_proj_bwd(
                seq, w, g, HEADS, rate, seed)
            want = kernels.attention_proj_plain_bwd(seq, w, g, HEADS, rate,
                                                    seed)
            bound_ms, bound_by = bound(4 * (3 * batch * s * c + 2 * 3 * c * c),
                                       3 * proj + 5 * core)
            row = {"kind": "proj_bwd", "batch": batch, "C": c, "S": s,
                   "rate": rate, "card": card, "bound_ms": bound_ms,
                   "bound_by": bound_by}
            for name, run in runs.items():
                got, again = run(), run()
                row[f"{name}_err"] = [_rel(x, y) for x, y in zip(got, want)]
                row[f"{name}_max_abs_err"] = max(
                    float((x - y).abs().max()) for x, y in zip(got, want))
                row[f"{name}_repeats"] = all(torch.equal(x, y)
                                             for x, y in zip(got, again))
            row.update(_turns(timer, runs))
            dqkv = kernels.attention_long_qkv_bwd(qkv, g, HEADS, rate, seed)
            row["stages_ms"] = {
                "qkv_gemm": timer(lambda: kernels.attention_qkv_gemm(seq, w)),
                "long_bwd": timer(lambda: kernels.attention_long_qkv_bwd(
                    qkv, g, HEADS, rate, seed)),
                "dseq_gemm": timer(lambda: kernels.attention_dseq_gemm(dqkv,
                                                                       w)),
                "dw_gemm": timer(lambda: kernels.attention_dw_gemm(dqkv,
                                                                   seq))}
            row["library_ms"] = (timer(library_bwd(seq, w, g)) if rate == 0.0
                                 else None)
            row["profile"] = {name: by_kernel(run)
                              for name, run in runs.items()}
            yield row


def ref_long_fwd(lib, qkv, rate, seed):
    """A ref's forward at the kernel's boundary, called as its
    `attention_long_qkv` called it."""
    b, s, c3 = qkv.shape
    c = c3 // 3
    out = torch.empty((b, s, c), device=qkv.device)
    _check(lib.gpnf_attention_long_fwd(
        seed.data_ptr() if rate > 0 else None, qkv.data_ptr(), out.data_ptr(),
        b, s, c, HEADS, fa.head_scale(c // HEADS),
        fa.keep_threshold(rate) if rate else 0, 1.0 / (1.0 - rate),
        _stream()), "ref long fwd")
    return out


def ref_long_bwd(lib, qkv, g, rate, seed):
    """A ref's backward at the kernels' boundary, called as its
    `attention_long_qkv_bwd` called it."""
    b, s, c3 = qkv.shape
    c = c3 // 3
    dqkv = torch.empty_like(qkv)
    stats = torch.empty((b, HEADS, s, 3), device=qkv.device)
    _check(lib.gpnf_attention_long_bwd(
        seed.data_ptr() if rate > 0 else None, qkv.data_ptr(), g.data_ptr(),
        dqkv.data_ptr(), stats.data_ptr(), b, s, c, HEADS,
        fa.head_scale(c // HEADS), fa.keep_threshold(rate) if rate else 0,
        1.0 / (1.0 - rate), _stream()), "ref long bwd")
    return dqkv


def sdpa_bwd(qkv, g):
    """Autograd backward of SDPA on the heads of qkv (rate 0), the graph
    built once: the call whose time stands beside the backward's."""
    b, s, c3 = qkv.shape
    c = c3 // 3
    heads = lambda x: x.reshape(b, s, HEADS, c // HEADS).transpose(
        1, 2).contiguous()
    k, v, q = (heads(x).requires_grad_() for x in qkv.split(c, dim=-1))
    with torch.enable_grad():
        out = F.scaled_dot_product_attention(q, k, v)
    return lambda: torch.autograd.grad(out, (q, k, v), heads(g),
                                       retain_graph=True)


def sdpa_fwd(qkv):
    """SDPA on the heads of qkv (rate 0), split once: the call whose time
    stands beside the forward's."""
    b, s, c3 = qkv.shape
    c = c3 // 3
    k, v, q = (x.reshape(b, s, HEADS, c // HEADS).transpose(1, 2).contiguous()
               for x in qkv.split(c, dim=-1))
    return lambda: F.scaled_dot_product_attention(q, k, v)


def attention_rows(device, libs, timer, card, kind, head_dims=(4, 8, 24, 64)):
    """The forward (`rows`, `lanes`) or the backward (`rows_bwd`,
    `lanes_bwd`) at the kind's shapes (`rows`: B 64 and ROW_LENGTHS at each
    of `head_dims`): the change and each ref in turns, beside SDPA (its
    autograd for the backward), both bounds."""
    backward = kind.endswith("_bwd")
    products = 5 if backward else 2
    shapes = ATTENTION_SHAPES.get(kind) or [
        (64, 4 * dh, s) for dh in head_dims for s in ROW_LENGTHS]
    for batch, c, s in shapes:
        gen = torch.Generator(device=device).manual_seed(c + s)
        qkv = torch.randn((batch, s, 3 * c), generator=gen,
                          device=device) * 0.5
        g = torch.randn((batch, s, c), generator=gen, device=device)
        seed = torch.tensor([1357 + s + c], dtype=torch.int32, device=device)
        dh = c // HEADS
        scores = batch * HEADS * s * s
        ops = products * 2 * scores * dh + 5 * scores
        bytes_moved = 4 * ((2 if backward else 1) * batch * s * 3 * c
                           + batch * s * c)
        bound_ms, bound_by = bound(bytes_moved, ops, PEAK_OPS_3XTF32)
        fp32_ms, fp32_by = bound(bytes_moved, ops)
        for rate in RATES:
            if backward:
                runs = {name: (lambda lib=lib: ref_long_bwd(
                    lib["fused_attention_long"], qkv, g, rate, seed))
                    for name, lib in libs.items()}
                runs["change"] = lambda: kernels.attention_long_qkv_bwd(
                    qkv, g, HEADS, rate, seed)
                want = kernels.attention_long_plain_bwd(qkv, g, HEADS, rate,
                                                        seed)
            else:
                runs = {name: (lambda lib=lib: ref_long_fwd(
                    lib["fused_attention_long"], qkv, rate, seed))
                    for name, lib in libs.items()}
                runs["change"] = lambda: kernels.attention_long_qkv(
                    qkv, HEADS, rate, seed)
                want = kernels.attention_long_plain(qkv, HEADS, rate, seed)
            row = {"kind": kind, "batch": batch, "C": c, "S": s,
                   "head_dim": dh, "rate": rate, "card": card,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bound_peak": "3xTF32 165 TFLOP/s",
                   "bound_fp32_ms": fp32_ms, "bound_fp32_by": fp32_by}
            for name, run in runs.items():
                got, again = run(), run()
                row[f"{name}_max_abs_err"] = float((got - want).abs().max())
                row[f"{name}_err"] = _rel(got, want)
                row[f"{name}_repeats"] = torch.equal(got, again)
            row.update(_turns(timer, runs))
            library = sdpa_bwd(qkv, g) if backward else sdpa_fwd(qkv)
            row["library_ms"] = timer(library) if rate == 0.0 else None
            row["profile"] = {name: by_kernel(run)
                              for name, run in runs.items()}
            yield row


def _dq_recipe(s, c):
    """The proj entry's dq (scaled in float32) where GatedAttn takes it,
    else the long entry's (rounded, then scaled in bf16)."""
    return kernels.attention_route(s, c, HEADS).entry == "proj"


def ref_long_bwd_bf16(lib, qkv, g, rate, seed, in_fp32, stats):
    """A ref's bf16 pair at the kernels' boundary, called as its
    `attention_long_qkv_bwd` called it: the forward's statistics (and a D
    scratch), or, before the forward kept them, a (B, H, S, 3) scratch."""
    b, s, c3 = qkv.shape
    c = c3 // 3
    scale = fa.bf16_scale((c // HEADS) ** -0.5)
    dqkv = torch.empty_like(qkv)
    args = (b, s, c, HEADS, scale, (c // HEADS) ** -0.5 if in_fp32 else scale,
            int(not in_fp32), fa.keep_threshold(rate) if rate else 0,
            1.0 / (1.0 - rate), _stream())
    seed_ptr = seed.data_ptr() if rate > 0 else None
    if lib.stateless_bf16:
        scratch = torch.empty((b, HEADS, s, 3), device=qkv.device)
        err = lib.gpnf_attention_long_bwd_bf16(
            seed_ptr, qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(),
            scratch.data_ptr(), *args)
    else:
        dsum = torch.empty((b, HEADS, s), device=qkv.device)
        keep = fa.keep_bits_scratch(b, HEADS, s, rate, qkv.device)
        err = lib.gpnf_attention_long_bwd_bf16(
            seed_ptr, qkv.data_ptr(), g.data_ptr(), stats.data_ptr(),
            dsum.data_ptr(), None if keep is None else keep.data_ptr(),
            dqkv.data_ptr(), *args)
    _check(err, "ref long bwd bf16")
    return dqkv


def bf16_rows_bwd(device, libs, timer, card):
    """`--kernel rows_bwd --dtype bfloat16`: the bf16 pair and each ref's in
    turns at BF16_SHAPES, beside SDPA's autograd on bf16; the forward with
    and without its statistics."""
    for batch, c, s in BF16_SHAPES:
        gen = torch.Generator(device=device).manual_seed(c + s)
        qkv = torch.randn((batch, s, 3 * c), generator=gen,
                          device=device).to(torch.bfloat16)
        g = (torch.randn((batch, s, c), generator=gen, device=device)
             * 0.5).to(torch.bfloat16)
        seed = torch.tensor([1357 + s + c], dtype=torch.int32, device=device)
        dh = c // HEADS
        in_fp32 = _dq_recipe(s, c)
        scores = batch * HEADS * s * s
        for rate in RATES:
            _, stats = kernels.attention_long_qkv(qkv, HEADS, rate, seed,
                                                  with_stats=True)
            runs = {name: (lambda lib=lib: ref_long_bwd_bf16(
                lib["fused_attention_long"], qkv, g, rate, seed, in_fp32,
                stats)) for name, lib in libs.items()}
            runs["change"] = lambda: kernels.attention_long_qkv_bwd(
                qkv, g, HEADS, rate, seed, scale_dq_in_fp32=in_fp32,
                stats=stats)
            want = kernels.attention_long_plain_bwd(qkv, g, HEADS, rate, seed,
                                                    None, in_fp32)
            bound_ms, bound_by = bound(
                2 * batch * s * 7 * c + 8 * batch * HEADS * s,
                5 * 2 * scores * dh, PEAK_OPS_BF16)
            row = {"kind": "rows_bwd_bf16", "batch": batch, "C": c, "S": s,
                   "head_dim": dh, "rate": rate, "card": card,
                   "dq_recipe": "fp32" if in_fp32 else "bf16",
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bound_peak": "bf16 989 TFLOP/s"}
            for name, run in runs.items():
                got, again = run(), run()
                row[f"{name}_err"] = [_rel(got[..., i * c:(i + 1) * c],
                                           want[..., i * c:(i + 1) * c])
                                      for i in range(3)]
                row[f"{name}_repeats"] = torch.equal(got, again)
            row.update(_turns(timer, runs))
            row["library_ms"] = (timer(sdpa_bwd(qkv, g)) if rate == 0.0
                                 else None)
            # the forward with its statistics' store ("change") and without
            fwd = {"no_stats": lambda: kernels.attention_long_qkv(
                       qkv, HEADS, rate, seed),
                   "change": lambda: kernels.attention_long_qkv(
                       qkv, HEADS, rate, seed, with_stats=True)}
            row["fwd_same_bits"] = torch.equal(fwd["change"]()[0],
                                               fwd["no_stats"]())
            row["fwd_ms"] = _turns(timer, fwd)
            row["profile"] = {name: by_kernel(run)
                              for name, run in runs.items()}
            yield row


def ref_proj_bwd_bf16(lib, seq, w, g, rate, seed, stats):
    """The bf16 proj backward with a ref's pair between the package's
    GEMMs."""
    dqkv = ref_long_bwd_bf16(lib, kernels.attention_qkv_gemm(seq, w), g,
                             rate, seed, True, stats)
    return (kernels.attention_dseq_gemm(dqkv, w),
            kernels.attention_dw_gemm(dqkv, seq).to(w.dtype))


def bf16_proj_rows(device, libs, timer, card):
    """`--kernel proj --dtype bfloat16`: the bf16 proj backward with the
    change's pair and with each ref's, in turns, beside autograd of
    F.linear + SDPA on bf16."""
    for batch, c, s in BF16_SHAPES:
        if not _dq_recipe(s, c):
            continue
        gen = torch.Generator(device=device).manual_seed(c + s)
        bf = lambda *shape, x=1.0: (torch.randn(
            shape, generator=gen, device=device) * x).to(torch.bfloat16)
        seq, w, g = bf(batch, s, c, x=0.5), bf(3 * c, c, x=0.1), bf(
            batch, s, c)
        seed = torch.tensor([4321 + s], dtype=torch.int32, device=device)
        for rate in RATES:
            _, stats = kernels.attention_long_qkv(
                kernels.attention_qkv_gemm(seq, w), HEADS, rate, seed,
                with_stats=True)
            runs = {name: (lambda lib=lib: ref_proj_bwd_bf16(
                lib["fused_attention_long"], seq, w, g, rate, seed, stats))
                for name, lib in libs.items()}
            runs["change"] = lambda: kernels.fused_attention_proj_bwd(
                seq, w, g, HEADS, rate, seed, stats)
            want = kernels.attention_proj_plain_bwd(seq, w, g, HEADS, rate,
                                                    seed)
            row = {"kind": "proj_bwd_bf16", "batch": batch, "C": c, "S": s,
                   "rate": rate, "card": card}
            for name, run in runs.items():
                got, again = run(), run()
                row[f"{name}_err"] = [_rel(x, y) for x, y in zip(got, want)]
                row[f"{name}_repeats"] = all(torch.equal(x, y)
                                             for x, y in zip(got, again))
            row.update(_turns(timer, runs))
            row["library_ms"] = (timer(library_bwd(seq, w, g)) if rate == 0.0
                                 else None)
            row["profile"] = {name: by_kernel(run)
                              for name, run in runs.items()}
            yield row


class _RefPair:
    """Within it, the bf16 proj and long entries' backward runs a ref's
    pair (`ref_long_bwd_bf16`, unpadded heads) in place of the package's;
    any other call goes to the package's."""

    def __init__(self, lib):
        self.lib, self.orig = lib, fa.attention_long_qkv_bwd

    def __call__(self, qkv, g, num_heads, rate=0.0, seed=None, q_scale=None,
                 scale_dq_in_fp32=False, stats=None):
        if (qkv.dtype != torch.bfloat16 or q_scale is not None
                or qkv.shape[2] // 3 // num_heads not in fa.BF16_HEAD_DIMS):
            return self.orig(qkv, g, num_heads, rate, seed, q_scale,
                             scale_dq_in_fp32, stats)
        return ref_long_bwd_bf16(self.lib, qkv.contiguous(), g.contiguous(),
                                 rate, seed, scale_dq_in_fp32, stats)

    def __enter__(self):
        fa.attention_long_qkv_bwd = self

    def __exit__(self, *exc):
        fa.attention_long_qkv_bwd = self.orig


class _NoStats:
    """Within it, no bf16 forward keeps its statistics for the backward."""

    def __enter__(self):
        self.orig = fa._keeps_stats
        fa._keeps_stats = lambda seq, w: False

    def __exit__(self, *exc):
        fa._keeps_stats = self.orig


def bf16_train_rows(device, libs, card):
    """`--kernel train --dtype bfloat16`: the bf16 flagship's train step at
    32 and 64 px with the change's pair and each ref's, in turns."""
    import contextlib

    from .data.datasets import get_dataset
    from .models.marscf import MarScfConfig, MarScfFlow
    from .training.loop import train_step
    from .training.optim import AdamaxWarmup

    for dataset, size in (("synthetic", 32), ("imagenet_64", 64)):
        cfg = MarScfConfig(image_shape=(size, size, 3), **TRAIN_CONFIG)
        loader = get_dataset(dataset, TRAIN_BATCH, seed=0)[0]
        batches = [torch.from_numpy(b).to(device)
                   for b, _ in zip(loader, range(4))]
        model = MarScfFlow(cfg, device=device,
                           generator=torch.Generator().manual_seed(10))
        gen = torch.Generator(device=device).manual_seed(11)
        model.ddi(batches[0], generator=gen)
        model.train()
        opt = AdamaxWarmup(model.parameters(), lr=1e-4, warm_up=64,
                           batch_size=TRAIN_BATCH)
        step = [0]

        def window(n):
            for _ in range(n):
                loss = train_step(model, opt, batches[step[0] % 4], gen)
                step[0] += 1
            return float(loss)  # the window ends in a loss read

        contexts = {name: (lambda lib=lib: _RefPair(
            lib["fused_attention_long"])) for name, lib in libs.items()}
        contexts["change"] = contextlib.nullcontext
        # a step's peak and what was allocated before it, with each pair,
        # and with the change's pair but no statistics kept (the forward's
        # store off, the backward running the forward for them)
        peak = {}
        for name, ctx in [*contexts.items(), ("change_no_stats", _NoStats)]:
            with ctx():
                window(2)  # builds, first calls
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(device)
                base = torch.cuda.memory_allocated(device)
                window(1)
                torch.cuda.synchronize()
                peak[name] = [torch.cuda.max_memory_allocated(device), base]
        refs = [name for name in contexts if name != "change"]
        times = {name: [] for name in contexts}
        for _ in range(TRAIN_TURNS):
            for name in [*refs, "change", "change", *reversed(refs)]:
                with contexts[name]():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    window(TRAIN_WINDOW_STEPS)
                    times[name].append(time.perf_counter() - t0)
        yield {"kind": "train_bf16", "image_size": size,
               "batch": TRAIN_BATCH, "window_steps": TRAIN_WINDOW_STEPS,
               "card": card, "peak_and_base_bytes": peak,
               "window_s": times, "images_per_s": {
                   name: TRAIN_WINDOW_STEPS * TRAIN_BATCH
                   / statistics.median(v) for name, v in times.items()}}
        del model, opt, batches
        torch.cuda.empty_cache()


def gemm_cases(device):
    """(tag, a, b, shape, m, n, k, trans_a, trans_b, torch.matmul of the
    same product) of each GEMM of the proj backward and the wide route."""
    for batch, c, s in PROJ_SHAPES + WIDE_SHAPES:
        gen = torch.Generator(device=device).manual_seed(7 * c + s)
        seq = torch.randn((batch, s, c), generator=gen, device=device)
        w = torch.randn((3 * c, c), generator=gen, device=device) * 0.1
        dqkv = torch.randn((batch, s, 3 * c), generator=gen, device=device)
        rows = batch * s
        yield (f"qkv C={c} S={s} B={batch}", seq, w, (batch, s, 3 * c), rows,
               3 * c, c, False, True, lambda: torch.mm(
                   seq.reshape(rows, c), w.t()))
        yield (f"dseq C={c} S={s} B={batch}", dqkv, w, (batch, s, c), rows, c,
               3 * c, False, False, lambda: torch.mm(
                   dqkv.reshape(rows, 3 * c), w))
        yield (f"dW C={c} S={s} B={batch}", dqkv, seq, (3 * c, c), 3 * c, c,
               rows, True, False, lambda: torch.mm(
                   dqkv.reshape(rows, 3 * c).t(), seq.reshape(rows, c)))


def gemm_rows(device, libs, timer, card, targets, split_refs):
    """The GEMMs of `gemm_cases`: the change and each ref in turns, beside
    torch.mm; `split_refs` (m, n, k) -> the splits of the refs' split-K
    entry; both bounds and a trace of each call."""
    for tag, a, b, shape, m, n, k, trans_a, trans_b, mm in gemm_cases(device):
        splits = fa.gemm_splits(m, n, k)
        ref_splits = split_refs(m, n, k)
        runs = {name: (lambda lib=lib: ref_split_gemm(
            lib["attention_gemm"], a, b, shape, m, n, k, trans_a, trans_b,
            ref_splits)) for name, lib in libs.items()}
        runs["change"] = lambda sp=splits: fa._gemm(
            "bench", a, b, shape, m, n, k, trans_a, trans_b, sp)
        want = mm()
        bytes_moved, ops = 4 * (m * k + k * n + m * n), 2 * m * n * k
        fp32_ms, fp32_by = bound(bytes_moved, ops)
        bound_ms, bound_by = bound(bytes_moved, ops, PEAK_OPS_3XTF32)
        row = {"kind": "gemm", "gemm": tag, "m": m, "n": n, "k": k,
               "splits": splits, "ref_splits": ref_splits,
               "tile": fa.gemm_tile(m, n), "card": card,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_peak": "3xTF32 165 TFLOP/s", "bound_fp32_ms": fp32_ms,
               "bound_fp32_by": fp32_by,
               "bound_bytes_ms": bytes_moved / PEAK_BYTES * 1e3}
        for name, run in runs.items():
            got = run().reshape(want.shape)
            row[f"{name}_err"] = _rel(got, want)
            row[f"{name}_max_abs_err"] = float((got - want).abs().max())
            row[f"{name}_repeats"] = torch.equal(got, run().reshape(
                want.shape))
        row.update(_turns(timer, runs))
        row["library_ms"] = timer(mm)
        sweep = {}
        for target in targets:
            sp = fa.gemm_splits(m, n, k, target)
            if sp not in sweep:
                sweep[sp] = {"targets": [], "ms": timer(
                    lambda sp=sp: fa._gemm("bench", a, b, shape, m, n, k,
                                           trans_a, trans_b, sp))}
            sweep[sp]["targets"].append(target)
        row["sweep"] = {str(sp): v for sp, v in sweep.items()}
        row["profile"] = {name: by_kernel(run) for name, run in runs.items()}
        yield row


def ref_gemm_bf16(lib, a, b, shape, m, n, k, trans_a, trans_b, out_dtype):
    """A ref's bf16 GEMM from before the TMA + wgmma kernel, K split as its
    wrapper split it (`gemm_splits`), the partials added by its second
    launch."""
    splits = fa.gemm_splits(m, n, k)
    c = torch.empty(shape, dtype=out_dtype, device=a.device)
    partial = (torch.empty((splits, m, n), device=a.device) if splits > 1
               else None)
    _check(lib.gpnf_attention_gemm_bf16(
        a.data_ptr(), b.data_ptr(), c.data_ptr(),
        None if partial is None else partial.data_ptr(), m, n, k,
        int(trans_a), int(trans_b), splits,
        int(out_dtype == torch.bfloat16), _stream()), "ref gemm bf16")
    return c


def lean_gemm_bf16(a, b, shape, m, n, k, trans_a, trans_b, out_dtype):
    """The change's bf16 GEMM called as `ref_gemm_bf16` calls a ref's (no
    wrapper checks): its plan, the output and scratch, its C entry."""
    c = torch.empty(shape, dtype=out_dtype, device=a.device)
    plan = fa.gemm_bf16_plan(m, n, k, a.data_ptr(), b.data_ptr(),
                             c.data_ptr(), trans_a, trans_b,
                             1 if trans_b else None)
    partial = counters = None
    cluster = fa.wgmma_cluster(plan.splits)
    if plan.splits > cluster:
        tiles = -(-m // fa.WGMMA_BM) * -(-n // plan.tile)
        partial = torch.empty((plan.splits // cluster, tiles,
                               fa.WGMMA_BM * plan.tile), device=a.device)
        counters = fa.wgmma_counters(a.device, tiles * cluster)
    _check(_native.load("attention_gemm").gpnf_attention_gemm_bf16(
        a.data_ptr(), b.data_ptr(), c.data_ptr(),
        None if partial is None else partial.data_ptr(),
        None if counters is None else counters.data_ptr(), m, n, k,
        int(trans_a), int(trans_b), plan.splits,
        int(out_dtype == torch.bfloat16), _stream()), "change gemm bf16")
    return c


def host_us(fn, calls=200, windows=5):
    """Host microseconds of one call of `fn`, no synchronize between calls
    (the enqueue: the wrapper's checks, allocations, the C entry's tensor
    maps and launch): the median of `windows` windows of `calls` calls."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per_call.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(per_call)


def c_entry(lib, version, a, b, shape, m, n, k, ta, tb, out_dtype):
    """One call of a version's bf16 C entry alone, its output and scratch
    made beforehand: the change's (its plan's splits, partial slabs and
    counters) or a ref's (`gemm_splits`, the (splits, m, n) partials)."""
    device = a.device
    c = torch.empty(shape, dtype=out_dtype, device=device)
    out_bf16 = int(out_dtype == torch.bfloat16)
    stream = _stream()
    if version == "change":
        plan = fa.gemm_bf16_plan(m, n, k, a.data_ptr(), b.data_ptr(),
                                 c.data_ptr(), ta, tb, 1 if tb else None)
        tiles = -(-m // fa.WGMMA_BM) * -(-n // plan.tile)
        cluster = fa.wgmma_cluster(plan.splits)
        partial = torch.empty((plan.splits // cluster, tiles,
                               fa.WGMMA_BM * plan.tile), device=device)
        counters = fa.wgmma_counters(device, tiles * cluster)
        args = (a.data_ptr(), b.data_ptr(), c.data_ptr(), partial.data_ptr(),
                counters.data_ptr(), m, n, k, int(ta), int(tb), plan.splits,
                out_bf16, stream)
    else:
        splits = fa.gemm_splits(m, n, k)
        partial = torch.empty((splits, m, n), device=device)
        args = (a.data_ptr(), b.data_ptr(), c.data_ptr(), partial.data_ptr(),
                m, n, k, int(ta), int(tb), splits, out_bf16, stream)
    fn = lib.gpnf_attention_gemm_bf16
    return lambda: _check(fn(*args), f"{version} gemm bf16 entry")


def sweep_splits(m, n, k):
    """The split counts of BF16_SPLIT_SWEEP the kernel takes for this K
    (`wgmma_cluster`, no range empty)."""
    kb = -(-k // fa.WGMMA_BK)
    return [s for s in BF16_SPLIT_SWEEP
            if s == 1 or (s <= kb and (s - 1) * -(-kb // s) < kb
                          and fa.wgmma_cluster(s))]


def bf16_gemm_rows(device, libs, timer, card):
    """`--kernel gemm --dtype bfloat16`: qkv, dseq and dW of the bf16 GEMM
    at BF16_GEMM_SHAPES, the change (its wrappers) and each ref in turns,
    beside torch.matmul on bf16: the error against the plain version (dW
    also against float64), two calls bit for bit, the bound at the dense
    bf16 rate, each call's device launches (a CUDA graph) and host time
    (the wrapper, and its C entry alone), a trace of one call, and for dseq
    and dW the change at every split count of BF16_SPLIT_SWEEP."""
    from .utils.cuda_timing import graph_launches

    for batch, c, s in BF16_GEMM_SHAPES:
        gen = torch.Generator(device=device).manual_seed(11 * c + s)
        bf = lambda *shape, x=1.0: (torch.randn(
            shape, generator=gen, device=device) * x).to(torch.bfloat16)
        seq, w, dqkv = bf(batch, s, c, x=0.5), bf(3 * c, c, x=0.1), bf(
            batch, s, 3 * c, x=0.1)
        d2, s2 = dqkv.reshape(-1, 3 * c), seq.reshape(-1, c)
        rows = batch * s
        for name, a, b, shape, m, n, k, ta, tb, out, entry, plain, lib in (
                ("qkv", seq, w, (batch, s, 3 * c), rows, 3 * c, c, False,
                 True, torch.bfloat16, kernels.attention_qkv_gemm,
                 lambda: fa.bf16_matmul(seq, w.t()),
                 lambda: torch.matmul(seq, w.t())),
                ("dseq", dqkv, w, (batch, s, c), rows, c, 3 * c, False, False,
                 torch.bfloat16, kernels.attention_dseq_gemm,
                 lambda: fa.bf16_matmul(dqkv, w),
                 lambda: torch.matmul(dqkv, w)),
                ("dW", dqkv, seq, (3 * c, c), 3 * c, c, rows, True, False,
                 torch.float32, kernels.attention_dw_gemm,
                 lambda: fa.dw_plain(dqkv, seq),
                 lambda: torch.matmul(d2.t(), s2))):
            runs = {ref: (lambda lib=lib_, a=a, b=b, shape=shape, m=m, n=n,
                          k=k, ta=ta, tb=tb, out=out: ref_gemm_bf16(
                              lib["attention_gemm"], a, b, shape, m, n, k, ta,
                              tb, out))
                    for ref, lib_ in libs.items()}
            runs["change"] = lambda entry=entry, a=a, b=b: entry(a, b)
            plan = fa.gemm_bf16_plan(m, n, k, a.data_ptr(), b.data_ptr(), 0,
                                     ta, tb, 1 if name == "qkv" else None)
            out_bytes = 2 if out == torch.bfloat16 else 4
            bound_ms, bound_by = bound(2 * (m * k + k * n) + out_bytes * m * n,
                                       2 * m * n * k, PEAK_OPS_BF16)
            row = {"kind": "gemm_bf16", "gemm": name, "batch": batch, "C": c,
                   "S": s, "m": m, "n": n, "k": k, "card": card,
                   "plan": plan._asdict(),
                   "ref_splits": fa.gemm_splits(m, n, k),
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bound_peak": "bf16 989 TFLOP/s"}
            want = plain()
            a2, b2 = ((seq.reshape(rows, c), w) if name == "qkv" else
                      (d2, w.t()) if name == "dseq" else (d2.t(), s2.t()))
            for ver, run in runs.items():
                got = run()
                row[f"{ver}_max_abs_err"] = float(
                    (got.float() - want.float()).abs().max())
                if name == "dW":
                    spread = k * 2.0 ** -24 * (a2.float().abs()
                                               @ b2.float().abs().t())
                    row[f"{ver}_within_bar"] = bool(
                        ((got - want).abs() <= spread).all())
                    exact = a2.double() @ b2.double().t()
                    row[f"{ver}_err_over_sum_abs"] = float(
                        ((got.double() - exact).abs()
                         / (a2.double().abs() @ b2.double().abs().t())
                         .clamp_min(1e-30)).max())
                else:
                    row[f"{ver}_within_bar"] = fa.bf16_product_close(
                        got, want, a2, b2)
                row[f"{ver}_repeats"] = torch.equal(got, run())
                row[f"{ver}_device_launches"] = graph_launches(run)
                row[f"{ver}_host_us"] = host_us(run)
                lib_c = (_native.load("attention_gemm") if ver == "change"
                         else libs[ver]["attention_gemm"])
                row[f"{ver}_c_entry_host_us"] = host_us(c_entry(
                    lib_c, ver, a, b, shape, m, n, k, ta, tb, out))
            # the change called as the refs are, beside its wrapper's time
            row["change_lean_host_us"] = host_us(
                lambda a=a, b=b, shape=shape, m=m, n=n, k=k, ta=ta, tb=tb,
                out=out: lean_gemm_bf16(a, b, shape, m, n, k, ta, tb, out))
            if name == "dW":
                exact = a2.double() @ b2.double().t()
                row["plain_err_over_sum_abs"] = float(
                    ((want.double() - exact).abs()
                     / (a2.double().abs() @ b2.double().abs().t())
                     .clamp_min(1e-30)).max())
            row.update(_turns(timer, runs))
            row["library_ms"] = timer(lib)
            row["library_host_us"] = host_us(lib)
            row["unaligned_launches"] = \
                kernels.attention_gemm_bf16_unaligned.launches
            if name != "qkv":
                row["sweep"] = {str(sp): timer(
                    lambda sp=sp, a=a, b=b, shape=shape, m=m, n=n, k=k, ta=ta,
                    tb=tb, out=out: fa._gemm_bf16(
                        "bench", a, b, shape, m, n, k, ta, tb, out, sp))
                    for sp in sweep_splits(m, n, k)}
            row["profile"] = {ver: by_kernel(run) for ver, run in runs.items()}
            yield row


# the bf16 forward's kernels: the change's, and the mma.sync one before it
FWD_KERNELS = ("attention_wgmma_fwd_kernel", "attention_bf16_fwd_kernel")


def fwd_scores_a_tile(fn):
    """The scores a thread holds of one key tile in a bf16 forward kernel,
    by its mangled name: `attention_wgmma_fwd_kernel` kKeys / 2 (64 keys at
    W 32 and 128 without dropout, else 32: attention_wgmma.cuh's WgFwd);
    `attention_bf16_fwd_kernel` (the mma.sync kernel before it) a warp's 16
    rows by 64 keys (16 at W 256) over its 32 lanes."""
    dh, drop = re.search(r"PackedQkvILi(\d+)EEELb(\d)", fn).groups()
    width = 32 if int(dh) <= 32 else 128 if int(dh) <= 128 else 256
    if "wgmma" in fn:
        return (64 if width <= 128 and drop == "0" else 32) // 2
    return 16 * (64 if width <= 128 else 16) // 32


def fwd_sass(libs):
    """{version: {kernel: {"hgmma", "tma", "mufu", "key_loop"}}} of the bf16
    forward's instantiations in the change's library and each ref's: the
    warpgroup products, TMA loads and MUFU operations of the whole SASS,
    and the opcodes of the key loop (`key_loop_counts`) per score."""
    from .bench_mixture import sass_counts

    paths = {"change": _native.library_path("fused_attention_long"),
             **{name: OUT_DIR / name / "fused_attention_long.so"
                for name in libs}}
    out = {}
    for version, path in paths.items():
        loops = {}
        for pattern in FWD_KERNELS:
            loops.update(key_loop_counts(path, pattern, fwd_scores_a_tile))
        out[version] = {
            fn: {"hgmma": row["hgmma_ops"], "tma": row["tma_ops"],
                 "mufu": row["mufu"], "hmma": row["hmma_ops"],
                 "key_loop": loops.get(fn)}
            for fn, row in sass_counts(path).items()
            if any(p in fn for p in FWD_KERNELS)}
    return out


def ref_long_fwd_bf16(lib, qkv, rate, seed, with_stats=False):
    """A ref's bf16 forward at the kernel's boundary, called as its
    `attention_long_qkv` called it: with its (B, H, S, 2) statistics where
    asked (a ref from before the forward kept them has no such argument)."""
    b, s, c3 = qkv.shape
    c = c3 // 3
    out = torch.empty((b, s, c), dtype=qkv.dtype, device=qkv.device)
    stats = (torch.empty((b, HEADS, s, 2), device=qkv.device)
             if with_stats else None)
    args = (b, s, c, HEADS, fa.bf16_scale((c // HEADS) ** -0.5),
            fa.keep_threshold(rate) if rate else 0, 1.0 / (1.0 - rate),
            _stream())
    seed_ptr = seed.data_ptr() if rate > 0 else None
    if lib.stateless_bf16:
        err = lib.gpnf_attention_long_fwd_bf16(seed_ptr, qkv.data_ptr(),
                                               out.data_ptr(), *args)
    else:
        err = lib.gpnf_attention_long_fwd_bf16(
            seed_ptr, qkv.data_ptr(), out.data_ptr(),
            None if stats is None else stats.data_ptr(), *args)
    _check(err, "ref long fwd bf16")
    return (out, stats) if with_stats else out


def fwd_c_entry(lib, qkv, rate, seed):
    """One call of a version's bf16 forward C entry alone, its output made
    beforehand (no statistics)."""
    b, s, c3 = qkv.shape
    c = c3 // 3
    out = torch.empty((b, s, c), dtype=qkv.dtype, device=qkv.device)
    args = [seed.data_ptr() if rate > 0 else None, qkv.data_ptr(),
            out.data_ptr(), b, s, c, HEADS,
            fa.bf16_scale((c // HEADS) ** -0.5),
            fa.keep_threshold(rate) if rate else 0, 1.0 / (1.0 - rate),
            _stream()]
    if not lib.stateless_bf16:
        args.insert(3, None)
    fn = lib.gpnf_attention_long_fwd_bf16
    return lambda: _check(fn(*args), "bf16 forward entry")


def bf16_rows_fwd(device, libs, timer, card):
    """`--kernel rows --dtype bfloat16`: the bf16 forward
    (`attention_long_qkv`, `attention_fwd_bf16`) and each ref's
    `gpnf_attention_long_fwd_bf16` in turns at BF16_FWD_SHAPES, rates 0
    and 0.2, without and with the statistics' store, beside SDPA on bf16:
    out against the plain version (max abs error over 2^-7 max |v|), the
    statistics against `attention_stats_plain`, two calls bit for bit, out
    the same with and without the statistics, device launches a call (a
    CUDA graph), host microseconds a call (the wrapper; the C entry called
    as a ref is; each C entry alone, in turns), the bounds (bytes, the two products at the dense bf16
    rate, one exponential a score at PEAK_EXP), device time by kernel; and
    once, the SASS of every version's forward (`fwd_sass`)."""
    from .utils.cuda_timing import graph_launches

    change_lib = _native.load("fused_attention_long")
    change_lib.stateless_bf16 = False
    yield {"kind": "rows_fwd_bf16_sass", "card": card,
           "sass": fwd_sass(libs)}
    for batch, c, s in BF16_FWD_SHAPES:
        gen = torch.Generator(device=device).manual_seed(c + s)
        qkv = torch.randn((batch, s, 3 * c), generator=gen,
                          device=device).to(torch.bfloat16)
        seed = torch.tensor([1357 + s + c], dtype=torch.int32, device=device)
        dh = c // HEADS
        scores = batch * HEADS * s * s
        bytes_moved = 2 * (batch * s * 3 * c + batch * s * c)
        bytes_ms = bytes_moved / PEAK_BYTES * 1e3
        ops_ms = 2 * 2 * scores * dh / PEAK_OPS_BF16 * 1e3
        exp_ms = scores / PEAK_EXP * 1e3
        bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"),
                                 (exp_ms, "exponentials"))
        bar = 2.0 ** -7 * float(qkv[..., c:2 * c].float().abs().max())
        stats_want = fa.attention_stats_plain(qkv, HEADS)
        for rate in RATES:
            want = kernels.attention_long_plain(qkv, HEADS, rate, seed)
            row = {"kind": "rows_fwd_bf16", "batch": batch, "C": c, "S": s,
                   "head_dim": dh, "rate": rate, "card": card, "bar": bar,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bound_bytes_ms": bytes_ms, "bound_ops_ms": ops_ms,
                   "bound_exp_ms": exp_ms,
                   "bound_peak": "bf16 989 TFLOP/s, 3.35 TB/s, ex2 3.9e12/s"}
            for with_stats in (False, True):
                tag = "stats_" if with_stats else ""
                runs = {name: (lambda lib=lib: ref_long_fwd_bf16(
                    lib["fused_attention_long"], qkv, rate, seed, with_stats))
                    for name, lib in libs.items()
                    if not (with_stats and
                            lib["fused_attention_long"].stateless_bf16)}
                runs["change"] = lambda: kernels.attention_long_qkv(
                    qkv, HEADS, rate, seed, with_stats=with_stats)
                for name, run in runs.items():
                    got = run()
                    out = got[0] if with_stats else got
                    row[f"{tag}{name}_err_over_bar"] = float(
                        (out.float() - want.float()).abs().max()) / bar
                    again = run()
                    row[f"{tag}{name}_repeats"] = torch.equal(
                        out, again[0] if with_stats else again)
                    if with_stats:
                        st = got[1]
                        row[f"{name}_stats_err"] = [
                            float((st[..., 0] - stats_want[..., 0]).abs()
                                  .max()),
                            float(((st[..., 1] - stats_want[..., 1])
                                   / stats_want[..., 1]).abs().max())]
                        plain_run = (libs[name]["fused_attention_long"]
                                     if name != "change" else change_lib)
                        row[f"{name}_same_bits_with_stats"] = torch.equal(
                            out, ref_long_fwd_bf16(plain_run, qkv, rate,
                                                   seed))
                    else:
                        row[f"{name}_device_launches"] = graph_launches(run)
                        row[f"{name}_host_us"] = host_us(run)
                row.update({f"{tag}{k}": v
                            for k, v in _turns(timer, runs).items()})
            row["change_lean_host_us"] = host_us(
                lambda: ref_long_fwd_bf16(change_lib, qkv, rate, seed))
            # each C entry alone (its tensor map, its launch), in turns
            entries = {name: fwd_c_entry(lib["fused_attention_long"], qkv,
                                         rate, seed)
                       for name, lib in libs.items()}
            entries["change"] = fwd_c_entry(change_lib, qkv, rate, seed)
            order = [n for n in entries if n != "change"]
            for name in [*order, "change", "change", *reversed(order)]:
                row.setdefault(f"{name}_c_entry_host_us", []).append(
                    host_us(entries[name]))
            row["library_ms"] = (timer(sdpa_fwd(qkv)) if rate == 0.0
                                 else None)
            row["profile"] = {name: by_kernel(run)
                              for name, run in runs.items()}
            yield row


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--kernel", choices=sorted(REF_SOURCES), default="proj",
                   help="the proj forward and backward, the GEMMs, the "
                        "Dh <= 64 or the Dh = 128 / 256 forward or "
                        "backward")
    p.add_argument("--ref", action="append", default=[],
                   help="NAME=DIR of another version's csrc/")
    p.add_argument("--ref-splits", choices=("parent", "change"),
                   default="parent",
                   help="--kernel gemm: split the refs' K as the SIMT "
                        "GEMM's wrapper did, or as the change's does")
    p.add_argument("--targets", default=",".join(map(str, TARGETS)),
                   help="block targets of the GEMM split sweep")
    p.add_argument("--dtype", choices=("float32", "bfloat16"),
                   default="float32",
                   help="bfloat16: the bf16 kernels (--kernel rows, "
                        "rows_bwd, proj or gemm)")
    p.add_argument("--head-dims", default="4,8,24,64",
                   help="--kernel rows: the head widths")
    p.add_argument("--out", default=None,
                   help="JSON output (default: build/bench_attention/"
                        "bench.json)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_attention: no CUDA device")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    bf16 = args.dtype == "bfloat16"
    if bf16 != (args.kernel == "train") and not (
            bf16 and args.kernel in ("rows", "rows_bwd", "proj", "gemm")):
        raise SystemExit("bench_attention: --dtype bfloat16 times --kernel "
                         "rows, rows_bwd, proj, gemm or train, and --kernel "
                         "train takes --dtype bfloat16")
    card = card_line()
    print(card, flush=True)
    refs = dict(spec.split("=", 1) for spec in args.ref)
    if "change" in refs:
        raise SystemExit("bench_attention: 'change' names the package's source")
    t0 = time.perf_counter()
    sources = (REF_SOURCES[args.kernel] if not bf16 or args.kernel == "gemm"
               else ("fused_attention_long",))
    change_sources = (
        _native.SOURCES if args.kernel == "train"
        else ("attention_gemm",) if args.kernel == "gemm"
        else ("fused_attention_long",) if bf16 and args.kernel == "rows"
        else ("attention_gemm", "fused_attention_long") if bf16
        else CHANGE_SOURCES[args.kernel])
    # the change's build beside the refs' (nvcc processes all at once)
    built = {}
    change_build = threading.Thread(target=lambda: built.update(
        reports=_native.build(change_sources)))
    change_build.start()
    try:
        libs, reports = build_refs(refs, sources)
    finally:
        change_build.join()
    if "reports" not in built:
        raise RuntimeError("bench_attention: the change's build failed")
    change_reports = built["reports"]
    results = [{"card": card, "build_s": time.perf_counter() - t0,
                "ptxas": {**reports, **{f"change/{k}": _ptxas_lines(v)
                                        for k, v in change_reports.items()}}}]
    print(json.dumps(results[0]), flush=True)
    timer = Timer(device)
    targets = [int(x) for x in args.targets.split(",")]
    if args.kernel == "gemm" and bf16:
        rows = bf16_gemm_rows(device, libs, timer, card)
    elif args.kernel == "gemm":
        rows = gemm_rows(device, libs, timer, card, targets,
                         parent_gemm_splits if args.ref_splits == "parent"
                         else fa.gemm_splits)
    elif args.kernel == "train":
        rows = bf16_train_rows(device, libs, card)
    elif bf16:
        rows = {"rows": bf16_rows_fwd, "rows_bwd": bf16_rows_bwd,
                "proj": bf16_proj_rows}[args.kernel](device, libs, timer,
                                                      card)
    elif args.kernel == "proj":
        rows = proj_rows(device, libs, timer, card)
    else:
        rows = attention_rows(device, libs, timer, card, args.kernel,
                              [int(x) for x in args.head_dims.split(",")])
    for row in rows:
        results.append(row)
        print(json.dumps(row), flush=True)
    out = args.out or str(OUT_DIR / "bench.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
