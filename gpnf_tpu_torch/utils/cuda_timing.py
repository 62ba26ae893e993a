"""Device timing on the card: the card's name and power limit, a cold-L2
CUDA-event timer and a torch.profiler trace of kernel launches. Shared by
chip_smoke.py and the benches."""
from __future__ import annotations

import statistics
import subprocess
import time

import torch


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


class Timer:
    """Median device time of one call of `fn`, from CUDA events.

    Before each call the 50 MB L2 is flushed (the serving path finds a
    kernel's inputs mostly cold) and the card is held busy with a spin
    kernel long enough for the host to enqueue the whole call, so the
    events bracket device work only, not Python's launch overhead. The
    flush writes a 64 MB buffer, which leaves L2 full of dirty lines (as a
    preceding kernel's outputs do); `dirty=False` reads it instead, which
    leaves clean ones."""

    def __init__(self, device, iters=20, warmup=3, dirty=True):
        self.flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=device)
        self.iters, self.warmup, self.dirty = iters, warmup, dirty

    def __call__(self, fn):
        for _ in range(self.warmup):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t0  # enqueue time, an upper bound
        torch.cuda.synchronize()
        spin_cycles = int(max(host_s, 1e-4) * 2 * 2e9)  # 2x at <= 2 GHz
        events = []
        for _ in range(self.iters):
            if self.dirty:
                self.flush.zero_()
            else:
                self.flush.max()
            torch.cuda._sleep(spin_cycles)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)


def trace(fn):
    """([(kernel name, start us, device us)], host-clock us) of one call of
    `fn` after one warm-up call (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = []
    for e in prof.events():
        # kernels only: annotations such as Optimizer.step#Adamax.step
        # are ranges over other kernels
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("(")[0][:70]
            events.append((name, e.time_range.start,
                           e.time_range.elapsed_us()))
    return events, wall_us


def device_launches(fn):
    """{kernel name without template arguments: launches} of one call of
    `fn`: the last of four in one trace, counted after two spin kernels
    before it. After earlier traces in the process, a trace can miss the
    first launch of each kernel and the first kernels of its window (seen
    with --profile), or, rarely, the whole last call (seen after many
    traces, chip_smoke.py phase 16); the first three calls and the spin
    kernels take the first losses, and a trace that lost the spin kernels
    or every kernel after them is taken again (at most three times)."""
    def run():
        for _ in range(3):
            fn()
        torch.cuda._sleep(1_000_000)
        torch.cuda._sleep(1_000_000)
        fn()

    for _ in range(3):
        events = trace(run)[0]
        marks = [start for name, start, _ in events if "spin" in name]
        if marks and any(start > max(marks) for _, start, _ in events):
            break
    else:
        raise AssertionError("the trace holds no spin kernel, or no kernel "
                             "after them, to count from")
    out = {}
    for name, start, _ in events:
        if start > max(marks):
            out[name.split("<")[0]] = out.get(name.split("<")[0], 0) + 1
    return out


def graph_launches(fn) -> int:
    """Kernel launches of one call of `fn`: the kernel nodes of a CUDA graph
    that captures the call (libcuda's cuGraphGetNodes and
    cuGraphNodeGetType), every launch it enqueues on the current stream.
    No profiler: a trace can lose launches (`device_launches`), a capture
    cannot. `fn` runs once before the capture (builds, allocations), on
    the stream the capture runs on (state a wrapper keeps for each stream,
    such as the split GEMM's counters, is then made outside the graph)."""
    import ctypes

    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="relaxed"):
        fn()
    libcuda = ctypes.CDLL("libcuda.so.1")
    libcuda.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_size_t)]
    libcuda.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                           ctypes.POINTER(ctypes.c_int)]
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    if libcuda.cuGraphGetNodes(handle, None, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    if libcuda.cuGraphGetNodes(handle, nodes, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    kernels, kind = 0, ctypes.c_int()
    for node in nodes:
        if libcuda.cuGraphNodeGetType(node, ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    del graph
    return kernels
