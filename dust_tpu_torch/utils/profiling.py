"""Tracing, timing and debug-mode utilities (counterpart of
`dust_tpu/utils/profiling.py`).

* `trace(logdir)`: a `torch.profiler` trace of any region (one episode,
  one solve, one sweep), written to `logdir` as a Chrome trace.
* `span(name)`: a named range of the program (a sweep call's phases, an
  MPC step's phases) in such a trace; nothing while no profiler records.
* `Stopwatch`: per-phase wall timings that wait for the device
  (`torch.cuda.synchronize` where the timed result holds a CUDA tensor,
  JAX's `block_until_ready`), feeding per-second rates.
* `debug_mode(nans=...)`: the correctness-over-speed switches, off by
  default and scoped, never ambient.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from pathlib import Path

import torch
from torch.profiler import record_function

from ..device import resolve_device

_NO_SPAN = contextlib.nullcontext()


def span(name):
    """`with span("sweep.run"): ...`: a `record_function` range named
    `name` while a profiler records (written on the profiler's clock,
    beside the device's activity; spans nest, the enclosing one is the
    cause), else a shared no-op context: no range, no device work, no
    host sync."""
    if torch._C._autograd._profiler_enabled():
        return record_function(name)
    return _NO_SPAN


@dataclasses.dataclass
class Trace:
    """What `trace` yields: the running profiler, and after the region
    the path of the Chrome trace it wrote."""

    logdir: Path
    profiler: object
    path: Path | None = None


@contextlib.contextmanager
def trace(logdir, device="cuda"):
    """Profile a region: `with trace("runs/t") as t: run_episode(...)`;
    then `t.path` is the Chrome trace and `t.profiler.key_averages()` the
    per-operation sums. CPU activity always, CUDA activity on a "cuda"
    device."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        holder = Trace(logdir=logdir, profiler=prof)
        yield holder
    holder.path = logdir / f"trace_{os.getpid()}_{time.time_ns()}.json"
    prof.export_chrome_trace(str(holder.path))


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


def block_until_ready(result):
    """Wait for the device work behind `result`: synchronize every CUDA
    device one of its tensors lies on."""
    for dev in {t.device for t in _tensors(result) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return result


class Stopwatch:
    """Accumulates named phase timings; `.rates(n)` converts them to
    per-second throughput (e.g. solves/s)."""

    def __init__(self):
        self.totals = {}
        self.counts = {}

    def _add(self, name, dt):
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    @contextlib.contextmanager
    def phase(self, name):
        """Time a block. Assign the block's output to the yielded holder's
        `.result` to make the timing wait for its device work:

            with sw.phase("solve") as h:
                h.result = solve(...)
        """

        class _Holder:
            result = None

        holder = _Holder()
        t0 = time.perf_counter()
        try:
            yield holder
        finally:
            if holder.result is not None:
                block_until_ready(holder.result)
            self._add(name, time.perf_counter() - t0)

    def timed(self, name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = block_until_ready(fn(*args, **kwargs))
        self._add(name, time.perf_counter() - t0)
        return out

    def rates(self, units_per_call=1):
        return {
            name: self.counts[name] * units_per_call / total
            for name, total in self.totals.items()
            if total > 0
        }

    def summary(self):
        return {
            name: {
                "total_s": round(total, 4),
                "calls": self.counts[name],
                "mean_ms": round(1e3 * total / self.counts[name], 3),
            }
            for name, total in self.totals.items()
        }


class _NanCheck(torch.overrides.TorchFunctionMode):
    """Raises FloatingPointError where a torch operation returns a NaN
    (jax.debug_nans). Each check reads the result on the host."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            if t.is_floating_point() and bool(torch.isnan(t).any()):
                raise FloatingPointError(
                    f"NaN in the output of {getattr(func, '__name__', func)}")
        return out


@contextlib.contextmanager
def debug_mode(nans=True, disable_jit=False):
    """Scoped debug switches: with `nans`, a NaN in the output of any torch
    operation raises FloatingPointError, and autograd's anomaly detection
    (`torch.autograd.set_detect_anomaly`) checks the backward passes.
    `disable_jit` is accepted for JAX's signature and changes nothing:
    PyTorch runs eagerly."""
    with contextlib.ExitStack() as stack:
        if nans:
            stack.enter_context(torch.autograd.set_detect_anomaly(True))
            stack.enter_context(_NanCheck())
        yield
