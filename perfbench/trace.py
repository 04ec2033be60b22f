"""A traced slice of a run and what the per-layer metrics read from it.

`profile_slice` runs a few more steps (or sweep calls) of the window's own
loop under `torch.profiler` (CPU and CUDA activities, no shapes, no
stacks), each inside a `record_function` span of the benchmark's own,
exports the trace into a temporary file under `TMPDIR`, reads it and
deletes it. `Trace` holds the spans, the device's operations (kernels,
copies, memsets) and the host's operations, in seconds on one clock.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")


@dataclass
class Trace:
    spans: list = field(default_factory=list)    # [(start, end)] the slice's
    device: list = field(default_factory=list)   # [(start, end, name, cat)]
    host: list = field(default_factory=list)     # [(start, end, name)]

    @property
    def window(self):
        """(start, end) of the traced slice: its first span's start to its
        last span's end."""
        return (min(s for s, _ in self.spans), max(e for _, e in self.spans))

    def device_in(self, start, end):
        return [d for d in self.device if d[0] >= start and d[0] < end]

    def busy_intervals(self):
        """The union of the device's activity inside the window, as sorted
        disjoint (start, end) intervals."""
        w0, w1 = self.window
        merged = []
        for s, e, _, _ in sorted(self.device):
            s, e = max(s, w0), min(e, w1)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def window_s(self):
        w0, w1 = self.window
        return w1 - w0

    @property
    def busy_s(self):
        return sum(e - s for s, e in self.busy_intervals())

    def idle_pct(self):
        """100 x (1 - busy / window), or None when the trace holds no device
        operation (a profiler that saw no card)."""
        if not self.device_in(*self.window):
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def kernel_s_per_span(self):
        """The device time of the kernels inside each span, per span."""
        out = []
        for s, e in self.spans:
            out.append(sum(d[1] - d[0] for d in self.device_in(s, e)
                           if d[3] == "kernel"))
        return out

    def top_device_ops(self, k=10):
        """[[name, seconds]]: the device operations that took the most time
        in the window, summed by name."""
        total = {}
        for s, e, name, _ in self.device_in(*self.window):
            total[name] = total.get(name, 0.0) + (e - s)
        top = sorted(total.items(), key=lambda kv: -kv[1])[:k]
        return [[name[:160], sec] for name, sec in top]

    def idle_gaps(self, k=10):
        """[[host operation, seconds]]: the device's idle time inside the
        window, summed by what the host was doing at each gap's middle
        (the innermost host operation spanning it; none: the interpreter
        between two operations), the largest first."""
        busy = self.busy_intervals()
        w0, w1 = self.window
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        # host operations nest: walk the gaps' middles in order with a
        # stack of the operations open there, innermost on top
        host = sorted(self.host, key=lambda h: (h[0], -h[1]))
        stack, i, total = [], 0, {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            while i < len(host) and host[i][0] <= mid:
                while stack and stack[-1][1] < host[i][0]:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            label = stack[-1][2] if stack else "python between operations"
            total[label] = total.get(label, 0.0) + (b - a)
        top = sorted(total.items(), key=lambda kv: -kv[1])[:k]
        return [[name[:160], sec] for name, sec in top]


def read_chrome_trace(path, span_name):
    """A `Trace` from a chrome trace that `torch.profiler` exported: the
    spans named `span_name`, the device's and the host's operations."""
    with open(path) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    tr = Trace()
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = float(ev["ts"]) * 1e-6
        e = s + float(ev["dur"]) * 1e-6
        cat = ev.get("cat", "")
        name = ev.get("name", "")
        if cat in DEVICE_CATS:
            tr.device.append((s, e, name, cat))
        elif cat in HOST_CATS:
            if cat == "user_annotation" and name == span_name:
                tr.spans.append((s, e))
            elif not name.startswith("ProfilerStep#"):
                tr.host.append((s, e, name))
    tr.spans.sort()
    return tr


def profile_slice(step, warmup, active, span_name="perfbench.step"):
    """Run `step()` warmup + active times under the profiler, each call in
    a span named `span_name`; only the `active` calls are recorded.
    Returns the `Trace`."""
    import torch
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    fd, path = tempfile.mkstemp(prefix="perfbench-trace-", suffix=".json")
    os.close(fd)
    try:
        with profile(activities=activities,
                     schedule=schedule(wait=0, warmup=warmup, active=active,
                                       repeat=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)
                     ) as prof:
            for _ in range(warmup + active):
                with record_function(span_name):
                    step()
                prof.step()
        return read_chrome_trace(path, span_name)
    finally:
        os.unlink(path)
