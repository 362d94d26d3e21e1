"""The device trace of the profiled replays, read in memory from
torch.profiler's Kineto events: each device operation's name and interval,
the host operations beside them, and the reductions the per-layer readers
take (sums by kernel class, the busy union, idle gaps)."""

from __future__ import annotations

import re

import torch

# a matmul kernel of cuBLAS / cuBLASLt / CUTLASS, by name
MATMUL = re.compile(r"gemm|cutlass|xmma|nvjet|cublas|matmul|splitk|dot_kernel", re.IGNORECASE)
# the program's hand-written kernels (csrc/*.cu): every symbol starts hgt_
HAND_WRITTEN = re.compile(r"\bhgt_")
MEGA = re.compile(r"hgt_mega_kernel")


def _kind(name: str) -> str:
    """"memcpy", "memset" or "kernel": a device operation's kind, by the
    names CUPTI gives copies and fills."""
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def kernel_class(name: str) -> str:
    """"hand_written", "matmul" or "small": what a kernel's name says it is."""
    if HAND_WRITTEN.search(name):
        return "hand_written"
    if MATMUL.search(name):
        return "matmul"
    return "small"


class DeviceTrace:
    """Device operations (name, start ns, end ns, kind) and host
    operations (name, start ns, end ns) of one profiled window of `iters`
    iterations."""

    def __init__(self, prof, iters: int):
        self.iters = iters
        self.ops, self.host = [], []
        for ev in prof.profiler.kineto_results.events():
            start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
            if ev.device_type() == torch.autograd.DeviceType.CUDA:
                self.ops.append((ev.name(), start, end, _kind(ev.name())))
            else:
                self.host.append((ev.name(), start, end))
        self.ops.sort(key=lambda o: o[1])
        self.kernels = [o for o in self.ops if o[3] == "kernel"]

    def union(self):
        """The busy intervals: the union of every device operation's."""
        out = []
        for _, s, e, _ in self.ops:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.union()) * 1e-9

    def span_s(self) -> float:
        """From the first device operation's start to the last one's end."""
        return (max(o[2] for o in self.ops) - self.ops[0][1]) * 1e-9

    def class_s(self, cls: str) -> float:
        """Device seconds of the kernels of one class."""
        return sum(e - s for n, s, e, _ in self.kernels if kernel_class(n) == cls) * 1e-9

    def matching(self, pattern):
        """(count, device seconds) of the kernels whose name matches."""
        hits = [(s, e) for n, s, e, _ in self.kernels if pattern.search(n)]
        return len(hits), sum(e - s for s, e in hits) * 1e-9

    def top_ops(self, k: int = 10):
        """[name, seconds] of the device operations that took most time,
        summed by name."""
        tot = {}
        for n, s, e, _ in self.ops:
            tot[n] = tot.get(n, 0) + (e - s)
        return [[n, t * 1e-9] for n, t in sorted(tot.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10):
        """[what the host was doing, seconds] of the longest gaps between
        busy intervals: the innermost host operation open at the gap's
        start (the one that started last), or "host idle"."""
        u = self.union()
        gaps = sorted(((u[i + 1][0] - u[i][1], u[i][1]) for i in range(len(u) - 1)),
                      reverse=True)[:k]
        out = []
        for length, at in gaps:
            open_ops = [(s, n) for n, s, e in self.host if s <= at < e]
            label = max(open_ops)[1] if open_ops else "host idle"
            out.append([label, length * 1e-9])
        return out
