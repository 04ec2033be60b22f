"""Run one cell of the port's benchmark once and print its result.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout that holds `BENCHMARK.json`, `perfbench/` and
the program (`dust_tpu_torch/`), on a machine with the CUDA cards the cell
asks for. Set-up (the CUDA context, the program's import, its kernel
library, built on a checkout's first run into `dust_tpu_torch/_build/`
and timed on a line of its own, the stack, the warm-up of the cell's own
shapes) is timed from the process's start to the first timed unit; then the window runs for
`--seconds`; with `--trace 1` a traced slice follows it. After the window
the answers are compared with the configuration's plain reference. The
last line of standard output is one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with `--trace 1` its
per-layer ones), device, with `--trace 1` breakdown, and last the
numbers the check compared, each with its limit (also the last lines of
standard error). Exits non-zero, printing no result, without enough CUDA
cards or if JAX or the JAX package was imported.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# modules that a run may not load: JAX and the JAX package, compared by
# their whole top-level names (the port's own name begins with the JAX
# package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "dust_tpu")


def forbidden_modules(modules=None):
    names = sys.modules if modules is None else modules
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def _cache_dirs():
    """torch's build and kernel caches at fixed places inside the checkout
    (the port builds its own kernels into `dust_tpu_torch/_build/`)."""
    cache = ROOT / ".perfbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(cache / "kernels")


def card_line():
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not available"


def end_to_end(cell, ctx):
    """The cell's end-to-end metrics from the untraced window, each by its
    reader."""
    out = {}
    for m in cell.end_to_end:
        value = cell.end_to_end_reader(m["name"]).read(ctx)
        if value is None:
            raise KeyError(f"{cell.name} cannot report {m['name']}")
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def per_layer(cell, ctx):
    """The cell's per-layer metrics: each metric's reader on the traced
    context; a reader that finds nothing leaves its metric out."""
    out = {}
    for m in cell.per_layer:
        value = cell.metric_reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def judge(cell, numbers):
    """(correct, [[name, value, limit]]): every number the check compared
    within its limit, every limit's number compared."""
    rows, ok = [], bool(numbers)
    for name in sorted(set(numbers) | set(cell.limits)):
        value = numbers.get(name, math.inf)
        limit = cell.limits.get(name)
        if limit is None or not value <= limit:
            ok = False
        rows.append([name, value, limit])
    return ok, rows


def build_kernels():
    """Build the program's kernel library into `dust_tpu_torch/_build/`
    where it is missing or stale (a checkout's first run). Returns the
    seconds the build took, 0 where there was nothing to build."""
    from dust_tpu_torch.ops import _build

    if not _build.is_stale():
        return 0.0
    t = time.perf_counter()
    _build.build()
    return time.perf_counter() - t


def run_cell(cell, seed, seconds, trace, device, t0=None):
    """One run of `cell`: set-up, warm-up, the window, with `trace` the
    traced slice, the check. Returns (result dict, check rows)."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    dev = torch.device(device)
    t_import = time.perf_counter()
    build_s = build_kernels() if dev.type == "cuda" else 0.0
    t_build = time.perf_counter()
    runner = cell.runner(cell, seed, dev)
    t_stack = time.perf_counter()
    unit_s = runner.warm_up()
    t_warm = time.perf_counter()
    # the build has a line of its own: it is part of set-up, but only a
    # checkout's first run pays it
    print(f"perfbench: kernel library build {build_s:.3f} s", file=sys.stderr)
    print(f"perfbench: set-up {t_warm - t0:.3f} s: interpreter and imports "
          f"{t_import - t0:.3f}, build {t_build - t_import:.3f}, inputs and "
          f"stack {t_stack - t_build:.3f}, warm-up {t_warm - t_stack:.3f} "
          f"(last unit {unit_s:.4f})", file=sys.stderr)
    runner.plan_samples(seconds, unit_s)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t0
    win = runner.window(seconds)
    traced = runner.traced() if trace else None
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": cell.chips,
        "memory_peak_bytes": int(peak),
    }
    result = {"correct": False, "attempted": win.attempted,
              "failed": win.failed}
    ctx = SimpleNamespace(window=win, setup_s=setup_s, runner=runner,
                          cell=cell, trace=None, unit_works=None)
    if trace:
        tr, ctx.unit_works = traced
        ctx.trace = tr if tr.spans else None
        result["metrics"] = per_layer(cell, ctx)
        if tr.spans:
            device_info["busy_s"] = tr.busy_s
            device_info["window_s"] = tr.window_s
            result["breakdown"] = {"device_ops": tr.top_device_ops(),
                                   "idle_gaps": tr.idle_gaps()}
    else:
        result["metrics"] = end_to_end(cell, ctx)
    result["device"] = device_info
    correct, rows = judge(cell, runner.check())
    result["correct"] = correct and win.failed == 0
    # a number that is not finite (a reference or answer that diverged)
    # reads as null
    result["checks"] = {
        name: {"value": value if math.isfinite(value) else None,
               "limit": limit}
        for name, value, limit in rows}
    return result, rows


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="run one cell of the port's benchmark once")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _cache_dirs()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))

    import torch

    from perfbench.harness import load_cell

    cell = load_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device (torch.cuda.is_available() is "
              "False); the benchmark runs only on the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {cell.name} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    print(f"perfbench: card {card_line()}", file=sys.stderr)
    result, rows = run_cell(cell, args.seed, args.seconds, args.trace,
                            "cuda", t0=T0)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run imported {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, value, limit in rows:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
