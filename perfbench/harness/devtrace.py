"""What a ``torch.profiler`` trace of the measured window says.

The profiler records the device's activity alone (``ProfilerActivity.CUDA``):
every operation that ran on the device, and each CUDA launch call on the
host with its correlation id.  Recording every host op as well slowed a
training step 2.6× on the card and so changed the window it measured.  The
host's ranges come from the benchmark's own log instead
(:mod:`harness.ranges`: the window, one range per dispatched kernel op, the
layer ranges, the program's spans), on the host clock.  A marker kernel
launched at the window's start ties the two clocks: its launch call's
timestamp in the trace against the host times taken around it.

A device operation is attributed to the host range in which the call that
launched it was made (the launch call shares its correlation id), so work is
credited to the op that asked for it, whatever kernel implements it.  The
trace is read from the raw Kineto events; ``key_averages()`` would first
parse every event into a tree on the host, which is slow over a long window.
"""

from __future__ import annotations

import dataclasses

OP_PREFIX = "perfbench.op."
MARKER = "spin_kernel"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class DeviceOp:
    name: str
    kind: str
    start: int  # ns
    end: int
    launch: int | None  # host ns of the call that launched it


@dataclasses.dataclass
class HostRange:
    name: str
    start: int
    end: int


def activity(e) -> str:
    """The Kineto activity of an event: ``kernel``, ``gpu_memcpy``,
    ``gpu_memset``, ``cuda_runtime`` (a CUDA API call on the host),
    ``user_annotation`` (a ``record_function`` range) or ``other``.  Some
    PyTorch builds (the card's 2.11 among them) have no ``activity_type()``:
    the kind then follows from the device, the annotation flag and the
    name."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    name = e.name()
    if str(e.device_type()).endswith("CUDA"):
        if e.is_user_annotation():
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if e.is_user_annotation():
        return "user_annotation"
    if name.startswith(("cuda", "cu")) and not name.startswith("cudnn"):
        return "cuda_runtime"
    return "other"


def union(intervals) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class DeviceTrace:
    """The device's operations and the host's ranges of one traced window.

    ``events``: the profiler's raw events; ``window``: the window's (start,
    end) on the host clock (ns); ``ranges``: ``(name, start, end)`` host
    ranges on the same clock; ``marker``: the host times taken just before
    and after the marker kernel's launch (``None`` where the host clock is
    the trace's already)."""

    def __init__(self, events, window, ranges, marker=None):
        launches: dict[int, int] = {}
        pending = []
        for e in events:
            kind = activity(e)
            if kind in DEVICE_KINDS:
                pending.append((e, kind))
            elif kind in LAUNCH_KINDS:
                launches[e.correlation_id()] = e.start_ns()
        shift = 0
        self.marker_launched = None
        if marker is not None:
            spin = [e for e, k in pending if k == "kernel" and MARKER in e.name()]
            if not spin:
                kernels = [e.start_ns() for e, k in pending if k == "kernel"]
                span = f"from {min(kernels)} to {max(kernels)} ns" if kernels else "none"
                raise RuntimeError(f"the trace holds no marker kernel {MARKER!r}: {len(kernels)} kernels ({span}), "
                                   f"{len(launches)} launch records; the host window {window[0]}..{window[1]} ns")
            # Where its launch call went unrecorded, the marker's start stands
            # for it: the device is idle then, so it starts within microseconds.
            launch = launches.get(spin[0].correlation_id())
            self.marker_launched = launch is not None
            at = launch if launch is not None else spin[0].start_ns()
            # The clocks agree where the launch lies between the host times
            # taken around it; otherwise its middle is the best guess.
            shift = 0 if marker[0] <= at <= marker[1] else at - (marker[0] + marker[1]) // 2
        self.window = (window[0] + shift, window[1] + shift)
        self.ranges = sorted((HostRange(n, a + shift, b + shift) for n, a, b in ranges),
                             key=lambda r: (r.start, -r.end))
        self.ops: list[DeviceOp] = []
        self.unlaunched = 0
        for e, kind in pending:
            s = e.start_ns()
            op = DeviceOp(e.name(), kind, s, s + e.duration_ns(),
                          launches.get(e.correlation_id(), launches.get(e.linked_correlation_id())))
            if op.kind == "kernel" and op.launch is None:
                self.unlaunched += 1
            if op.end > self.window[0] and op.start < self.window[1]:
                op.start, op.end = max(op.start, self.window[0]), min(op.end, self.window[1])
                self.ops.append(op)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy(self) -> list[tuple[int, int]]:
        return union((o.start, o.end) for o in self.ops)

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e9

    def kernels(self):
        return [o for o in self.ops if o.kind == "kernel"]

    def innermost_many(self, times, prefix: str = "") -> list:
        """For each host time, the innermost range named ``prefix…`` that
        holds it, or None.  The ranges of one thread nest, so the innermost
        is the open one that started last: one sweep over the sorted times."""
        order = sorted(range(len(times)), key=lambda i: times[i])
        ranges = [r for r in self.ranges if r.name.startswith(prefix)]
        out: list = [None] * len(times)
        stack: list[HostRange] = []
        j = 0
        for i in order:
            t = times[i]
            while j < len(ranges) and ranges[j].start <= t:
                while stack and stack[-1].end < ranges[j].start:
                    stack.pop()
                stack.append(ranges[j])
                j += 1
            while stack and stack[-1].end < t:
                stack.pop()
            out[i] = stack[-1] if stack else None
        return out

    def _kernel_ops(self):
        """[(kernel, its dispatch-op range or None)]."""
        ks = self.kernels()
        launched = [k for k in ks if k.launch is not None]
        found = dict(zip(map(id, launched), self.innermost_many([k.launch for k in launched], OP_PREFIX)))
        return [(k, found.get(id(k))) for k in ks]

    def by_op_call(self) -> dict[str, float]:
        """Device seconds of the kernels launched in each op range, by the
        range's name (``perfbench.op.<op>#<call>``)."""
        out: dict[str, float] = {}
        for k, r in self._kernel_ops():
            if r is not None:
                out[r.name] = out.get(r.name, 0.0) + (k.end - k.start) / 1e9
        return out

    def outside_ops_s(self) -> float:
        """Device seconds of kernels launched outside every op range."""
        return sum((k.end - k.start) / 1e9 for k, r in self._kernel_ops() if r is None)

    def top_ops(self, n: int = 10) -> list[list]:
        by: dict[str, float] = {}
        for o in self.ops:
            by[o.name] = by.get(o.name, 0.0) + (o.end - o.start) / 1e9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """Idle device time summed by what the host was in at each gap's
        middle: the innermost layer or program range, else ``window``."""
        lo, hi = self.window
        gaps, t = [], lo
        for s, e in self.busy():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
        by: dict[str, float] = {}
        for (s, e), r in zip(gaps, self.innermost_many([(s + e) // 2 for s, e in gaps])):
            name = "window" if r is None else r.name.split("#")[0]
            by[name] = by.get(name, 0.0) + (e - s) / 1e9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def op_calls(trace: DeviceTrace, calls: list, op: str):
    """``[(args, kwargs, device seconds)]`` of the recorded calls of ``op``
    whose kernels ran in the window; ``calls`` is the observer's record,
    indexed by the call number in the range's name."""
    out = []
    for name, secs in trace.by_op_call().items():
        head, _, idx = name[len(OP_PREFIX):].partition("#")
        if head == op:
            _, args, kwargs = calls[int(idx)]
            out.append((args, kwargs, secs))
    return out


def roofline(run, op: str):
    """Percent of its roofline that ``op`` reached in the window: the sum of
    its calls' least times (``kernels/<op>.py``) over the device time of the
    kernels launched in its ranges; None where no call ran."""
    calls = op_calls(run.trace, run.calls, op)
    spent = sum(secs for _, _, secs in calls)
    if not calls or spent <= 0.0:
        return None
    cost = run.files.kernel(op).cost
    return 100.0 * sum(cost(args, kwargs, run.peaks)["seconds"] for args, kwargs, _ in calls) / spent
