"""Stage spans of the training iteration, and host spans on the card's clock.

The training iteration runs on the card as one CUDA graph (algo/capture.py):
a replay runs no Python, so neither `record_function` nor an NVTX range
reaches its kernels. Its stages are marked where their code runs instead:

    with stage("env.physics"):
        ...

Tracing off (no tracer active, the default), `stage` and `robot` return one
shared null context and do nothing else. They run only in the Python that
builds the iteration (the eager CPU path, the warm-up and the capture), so
the off path adds no kernel, allocation or synchronisation to the graph or
to the runner's loop.

Tracing on, a `StageTracer` is active (`with tracer.activate():`, which the
runner does around its training iteration, `OnPolicyRunner.set_tracing`).
Entering and leaving a stage then writes a stamp into the next slot of the
iteration: on the card a one-thread kernel (`csrc/stamp.cu` `hgt_stamp`)
launched on the current stream writes `%globaltimer` into a device buffer
allocated once before the capture, so a captured stamp is a node of the
graph and every replay rewrites it; on the CPU `time.perf_counter_ns()`.
Where a torch.profiler runs, each stage also opens a `record_function`
range. Entering the root stage `ROOT` starts a new record: the slot ->
stage map (`StageTracer.stages`) is that of the newest build of the
iteration, on the card the capture's (the warm-up's stamps are
overwritten). Stages opened after the root closed (the captured
iteration's copy into its static inputs) belong to the same record.

The stamps travel with the iteration's metrics in the runner's
double-buffered fetch; `add_iteration` turns each fetched set into the
host clock (the card's clock offset is read once a capture, `prepare`) and
keeps per-stage totals in memory, with the runner's host spans
(`span(name)`). Nothing is written to disk during a run.

Every capture's host spans (`capture.warm_up`, `capture.record`) are kept
whether or not tracing is on, a pair a capture, in `CAPTURE_SPANS`.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import time
from typing import Optional

import numpy as np
import torch

ROOT = "iter"
# stamps an iteration may take: about 1,000 a flat iteration at T = 60, twice
# that on the joint task
STAMP_CAPACITY = 8192
NULL = contextlib.nullcontext()
# the host spans (name -> (start ns, end ns), host clock) of every capture in
# this process, in order; a capture appends one dict
CAPTURE_SPANS: list = []

_active: Optional["StageTracer"] = None


def stage(name: str):
    """A context marking stage `name` of the iteration: stamped where a
    tracer is active, else the shared null context."""
    tracer = _active
    return NULL if tracer is None else _Stage(tracer, name)


def robot(index: int):
    """A context under which the stages belong to robot `index` (a sub-env
    of a joint env): recorded where a tracer is active, else the shared
    null context."""
    tracer = _active
    return NULL if tracer is None else _Robot(tracer, index)


def active() -> Optional["StageTracer"]:
    """The active tracer, or None."""
    return _active


def host_span(tracer: Optional["StageTracer"], name: str):
    """`tracer.span(name)`, or the null context without a tracer."""
    return NULL if tracer is None else tracer.span(name)


def activated(tracer: Optional["StageTracer"]):
    """`tracer.activate()`, or the null context without a tracer."""
    return NULL if tracer is None else tracer.activate()


def record_capture(spans: dict) -> None:
    """Keep a capture's host spans in CAPTURE_SPANS and, where a tracer is
    active, among its host spans."""
    CAPTURE_SPANS.append(spans)
    if _active is not None:
        _active.host_spans.extend((name, a, b) for name, (a, b) in spans.items())


@dataclasses.dataclass
class StageRecord:
    """One stage instance: its name, robot (None outside a sub-env), depth
    (0 for the root and the stages after it, 1 directly under the root),
    and the slots of its entry and exit stamps."""

    name: str
    robot: Optional[int]
    depth: int
    enter: int
    exit: int = -1


@dataclasses.dataclass
class IterationStamps:
    """One fetched iteration, on the host clock (ns): its first and last
    stamps, the time its top stages cover (`top_level`), and per (stage,
    robot) the summed time of its instances (a stage's time includes its
    child stages')."""

    start: int
    end: int
    covered_ns: int
    totals: dict


def top_level(rec: "StageRecord") -> bool:
    """Whether a stage is one of those that partition the iteration: those
    directly under the root and those after it. What they leave of the
    iteration's span is unattributed."""
    return rec.depth == 1 or (rec.depth == 0 and rec.name != ROOT)


class _Stage:
    __slots__ = ("tracer", "name", "record", "range")

    def __init__(self, tracer, name):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.record = self.tracer._enter(self.name)
        return self

    def __exit__(self, *exc):
        self.tracer._exit(self.record, exc[0] is not None)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


class _Robot:
    __slots__ = ("tracer", "index", "saved")

    def __init__(self, tracer, index):
        self.tracer, self.index = tracer, index

    def __enter__(self):
        self.saved, self.tracer.robot = self.tracer.robot, self.index
        return self

    def __exit__(self, *exc):
        self.tracer.robot = self.saved
        return False


class StageTracer:
    """Stamps of the iteration's stages on `device` and host spans, kept in
    memory (see the module docstring).

    `stages` is the slot map of the newest record, `slots` its stamp count;
    `clock` is (offset, bracket) in ns, the card's clock minus the host's
    (`time.perf_counter_ns`) and the width of the host bracket it was read
    in ((0, 0) on the CPU), read at host time `clock_at`; `host_spans` holds (name, start ns, end ns) on
    the host clock; `iterations` one `IterationStamps` a fetched
    iteration."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.capacity = STAMP_CAPACITY
        self.stages: list = []
        self.slots = 0
        self.robot: Optional[int] = None
        self.clock = (0, 0) if self.device.type != "cuda" else None
        self.clock_at = 0
        self.buffer: Optional[torch.Tensor] = None
        self.host_spans: list = []
        self.iterations: list = []
        self._open: list = []
        self._host: list = []
        self._groups = None
        self._lib = None

    # -- building the iteration ----------------------------------------- #

    @contextlib.contextmanager
    def activate(self):
        """Make this the tracer that `stage` and `robot` record into."""
        global _active
        saved, _active = _active, self
        try:
            yield self
        finally:
            _active = saved

    def prepare(self) -> None:
        """On the card: allocate the stamp buffer (once) and read the clock
        offset. Called before a capture, which can neither allocate the
        tracer's buffer nor synchronise."""
        if self.device.type != "cuda":
            return
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("StageTracer.prepare() runs before the capture, not inside it")
        if self.buffer is None:
            from ..physics.cuda_build import kernel_library

            self._lib = kernel_library().stamp
            self.buffer = torch.zeros(self.capacity, dtype=torch.int64, device=self.device)
            self._clock_buf = torch.zeros(1, dtype=torch.int64, device=self.device)
        *self.clock, self.clock_at = self.read_clock()

    def _launch(self, buf: torch.Tensor, slot: int) -> None:
        from ..physics.cuda_build import check

        stream = torch.cuda.current_stream(self.device).cuda_stream
        check(self._lib.hgt_stamp_launch(buf.data_ptr(), slot, stream), "hgt_stamp launch")

    def read_clock(self):
        """(card ns - host ns, bracket ns, host ns at the bracket's middle):
        a stamp launched after a synchronisation, between two host reads;
        the narrowest bracket of 5. Needs `prepare` first."""
        best = None
        for _ in range(5):
            torch.cuda.synchronize(self.device)
            h0 = time.perf_counter_ns()
            self._launch(self._clock_buf, 0)
            torch.cuda.synchronize(self.device)
            h1 = time.perf_counter_ns()
            card = int(self._clock_buf.item())
            if best is None or h1 - h0 < best[1]:
                best = (card - (h0 + h1) // 2, h1 - h0, (h0 + h1) // 2)
        return best

    def _stamp(self) -> int:
        slot = self.slots
        if slot >= self.capacity:
            raise RuntimeError(f"the iteration's stages take more than {self.capacity} stamps")
        self.slots = slot + 1
        if self.device.type == "cuda":
            self._launch(self.buffer, slot)
        else:
            self._host.append(time.perf_counter_ns())
        return slot

    def _enter(self, name: str) -> StageRecord:
        if name == ROOT:
            if self._open:
                raise RuntimeError(f"stage {ROOT!r} opened inside stage {self._open[-1].name!r}")
            if self.device.type == "cuda" and self.buffer is None:
                self.prepare()
            self.stages, self.slots, self._host, self._groups = [], 0, [], None
        elif not self.stages:
            raise RuntimeError(f"stage {name!r} outside an iteration (stage {ROOT!r})")
        rec = StageRecord(name, self.robot, len(self._open), self._stamp())
        self.stages.append(rec)
        self._open.append(rec)
        return rec

    def _exit(self, rec: StageRecord, failed: bool = False) -> None:
        if failed:  # an exception unwinds: close the stage unstamped
            while self._open and self._open.pop() is not rec:
                pass
            return
        if not self._open or self._open[-1] is not rec:
            raise RuntimeError(f"stage {rec.name!r} closed out of order")
        self._open.pop()
        rec.exit = self._stamp()

    # -- reading -------------------------------------------------------- #

    def stamps(self) -> torch.Tensor:
        """The newest iteration's stamps (int64, one a slot): on the card a
        view of the device buffer, which the next replay overwrites, so a
        caller copies it on the stream; on the CPU a new tensor."""
        if self.device.type == "cuda":
            return self.buffer[:self.slots]
        return torch.tensor(self._host, dtype=torch.int64)

    def span(self, name: str):
        """A host span: (name, start ns, end ns) kept in `host_spans`."""
        return _HostSpan(self, name)

    def _grouping(self):
        if self._groups is None:
            keys = sorted({(r.name, r.robot) for r in self.stages},
                          key=lambda k: (k[0], -1 if k[1] is None else k[1]))
            groups = {k: ([], []) for k in keys}
            for r in self.stages:
                groups[(r.name, r.robot)][0].append(r.enter)
                groups[(r.name, r.robot)][1].append(r.exit)
            top = [r for r in self.stages if top_level(r)]
            self._groups = ({k: (np.array(a), np.array(b)) for k, (a, b) in groups.items()},
                            np.array([r.enter for r in top]), np.array([r.exit for r in top]))
        return self._groups

    def add_iteration(self, stamps) -> IterationStamps:
        """Keep one fetched iteration's per-stage totals, on the host clock
        (its stamps, a tensor or array in the slots of the current map)."""
        if len(stamps) != self.slots:
            raise ValueError(f"{len(stamps)} stamps for a map of {self.slots} slots")
        s = np.asarray(stamps, dtype=np.int64) - self.clock[0]
        groups, top_in, top_out = self._grouping()
        totals = {k: int((s[b] - s[a]).sum()) for k, (a, b) in groups.items()}
        it = IterationStamps(int(s[0]), int(s[-1]), int((s[top_out] - s[top_in]).sum()), totals)
        self.iterations.append(it)
        return it

    def stage_ms(self, first: int = 0) -> dict:
        """Mean ms an iteration of each (stage, robot), over the fetched
        iterations from index `first` on."""
        its = self.iterations[first:]
        if not its:
            return {}
        return {k: sum(i.totals.get(k, 0) for i in its) / len(its) / 1e6 for k in its[0].totals}

    def gaps(self, first: int = 1) -> list:
        """(gap ns, host span at its start) from the last stamp of each
        fetched iteration to the first of the next, for the gaps into
        iterations `first` on. The span is the one open at the gap's start
        that started last (the innermost), or "none"."""
        its = self.iterations
        spans = sorted(self.host_spans, key=lambda s: s[1])
        starts = [s[1] for s in spans]
        out = []
        for a, b in zip(its[max(first, 1) - 1:], its[max(first, 1):]):
            i = bisect.bisect_right(starts, a.end)
            name = next((n for n, s, e in reversed(spans[max(0, i - 16):i]) if s <= a.end < e),
                        "none")
            out.append((b.start - a.end, name))
        return out


class _HostSpan:
    __slots__ = ("tracer", "name", "start")

    def __init__(self, tracer, name):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.tracer.host_spans.append((self.name, self.start, time.perf_counter_ns()))
        return False


def add_stage_track(path: str, tracer: StageTracer) -> bool:
    """Add a `stages` track to the Chrome trace at `path`: one complete event
    per stage instance of the tracer's map, placed on the card by the
    `hgt_stamp` kernels' own times in the trace (the k-th stamp kernel is
    slot k), on the CPU by the stages' own `record_function` ranges (in
    order of entry). Returns False, and leaves the file alone, where the
    trace does not hold one iteration's stamps or ranges."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    kernels = sorted((e for e in events if e.get("cat") == "kernel"
                      and str(e.get("name", "")).startswith("hgt_stamp")), key=lambda e: e["ts"])
    if kernels:
        if len(kernels) != tracer.slots:
            return False
        at = [float(e["ts"]) for e in kernels]
        placed = [(at[r.enter], at[r.exit] - at[r.enter]) for r in tracer.stages]
        pid = kernels[0]["pid"]
    else:
        names = {r.name for r in tracer.stages}
        ranges = sorted((e for e in events if e.get("cat") == "user_annotation"
                         and e.get("name") in names), key=lambda e: e["ts"])
        if [e["name"] for e in ranges] != [r.name for r in tracer.stages]:
            return False
        placed = [(float(e["ts"]), float(e["dur"])) for e in ranges]
        pid = ranges[0]["pid"] if ranges else 0
    tids = [e["tid"] for e in events if e.get("pid") == pid and isinstance(e.get("tid"), int)]
    tid = max(tids, default=0) + 1
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                   "args": {"name": "stages"}})
    for r, (ts, dur) in zip(tracer.stages, placed):
        events.append({"ph": "X", "cat": "stage", "name": r.name, "pid": pid, "tid": tid,
                       "ts": ts, "dur": dur, "args": {"robot": r.robot, "depth": r.depth}})
    with open(path, "w") as f:
        json.dump(trace, f)
    return True
