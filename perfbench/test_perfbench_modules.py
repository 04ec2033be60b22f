"""What a run imports, and how a configuration, a cell and a per-layer
metric are added as new files and `BENCHMARK.json` entries."""

import json
import shutil
import subprocess
import sys

import pytest

from perfbench import run
from perfbench.harness import ROOT, load_cell
from perfbench.tiny import tiny_cell


@pytest.mark.parametrize("names,found", [
    (["dust_tpu_torch", "dust_tpu_torch.ops", "torch", "numpy"], []),
    (["dust_tpu_torch", "dust_tpu.ops.pallas_episode"], ["dust_tpu"]),
    (["jaxlib.xla_client", "flax"], ["flax", "jaxlib"]),
    (["jax_like", "jaxtyping"], []),
])
def test_forbidden_modules_compare_whole_top_level_names(names, found):
    assert run.forbidden_modules(names) == found


@pytest.mark.parametrize("workload", ["pendulum.sweep", "particle.sweep"])
def test_a_run_imports_no_jax(workload):
    """A whole run (CPU, tiny) in a fresh interpreter, then sys.modules:
    no top-level jax, jaxlib, flax or dust_tpu."""
    code = (
        "import sys, torch; torch.set_num_threads(1)\n"
        "from perfbench import run\n"
        "from perfbench.tiny import tiny_cell\n"
        f"run.run_cell(tiny_cell({workload!r}), 3, 0.2, 1, 'cpu')\n"
        "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_cli_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "pendulum.sweep",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    if out.returncode == 0:
        pytest.skip("a CUDA card is present")
    assert out.stdout == ""


STUB_RUNNER = """
from pathlib import Path

from perfbench.harness import load_module

_sweep = load_module(Path(__file__).with_name("pendulum_sweep.py"),
                     "perfbench.runners.pendulum_sweep")


class Runner(_sweep.Runner):
    OUTCOME = ("cost", "th")
"""


def test_a_cell_and_metrics_added_as_files(tmp_path):
    """A copy of the benchmark with a new configuration (the pendulum's
    with another learning rate, its reference one line), a new traffic
    mix of a new kind with its runner, a new cell, a new end-to-end and a
    new per-layer metric, all as added files and entries: the harness
    finds and runs them, and no file changed."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*")
              if p.is_file()}
    pb = tmp_path / "perfbench"
    cfg = json.loads((pb / "configs" / "pendulum.json").read_text())
    cfg["name"] = "pendulum_lr1"
    cfg["config"]["exp_params"]["learning_rate"] = 1.0
    (pb / "configs" / "pendulum_lr1.json").write_text(json.dumps(cfg))
    (pb / "reference" / "pendulum_lr1.py").write_text(
        "from .pendulum import *  # noqa: F401,F403\n"
        "from .pendulum import LOG_FIELDS  # noqa: F401\n")
    traffic = json.loads((pb / "traffic" / "pendulum_sweep.json")
                         .read_text())
    traffic.update(kind="stub_sweep", groups=2)
    (pb / "traffic" / "pendulum_two_groups.json").write_text(
        json.dumps(traffic))
    (pb / "runners" / "pendulum_stub_sweep.py").write_text(STUB_RUNNER)
    (pb / "limits" / "pendulum_lr1.two_groups.json").write_text(
        (pb / "limits" / "pendulum.sweep.json").read_text())
    (pb / "metrics" / "calls_traced.py").write_text(
        "def read(ctx):\n"
        "    return None if ctx.trace is None else len(ctx.trace.spans)\n")
    (pb / "end_to_end" / "calls_per_s.py").write_text(
        "def read(ctx):\n"
        "    return ctx.window.attempted / ctx.window.seconds\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "pendulum_lr1", "source": "test",
                             "file": "perfbench/configs/pendulum_lr1.json",
                             "reduced": ["learning_rate"], "why": "test"})
    bench["workloads"].append({"name": "pendulum_lr1.two_groups",
                               "config": "pendulum_lr1",
                               "traffic": "pendulum_two_groups",
                               "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "calls_per_s", "unit": "calls/s",
                                "better": "higher", "bound": 0.03,
                                "source": "host_clock",
                                "workloads": ["pendulum_lr1.two_groups"]})
    bench["per_layer"].append({"name": "calls_traced", "unit": "calls",
                               "better": "higher", "source": "program_span",
                               "layer": "loop", "moves": "calls_per_s",
                               "workloads": ["pendulum_lr1.two_groups"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = load_cell("pendulum_lr1.two_groups", tmp_path)
    assert cell.config["config"]["exp_params"]["learning_rate"] == 1.0
    assert cell.traffic["groups"] == 2
    assert cell.runner.OUTCOME == ("cost", "th")
    tiny = tiny_cell("pendulum_lr1.two_groups", tmp_path)
    result, _ = run.run_cell(tiny, 5, 0.2, 1, "cpu")
    assert result["metrics"]["calls_traced"]["value"] == 2
    assert result["correct"], result["checks"]
    result, _ = run.run_cell(tiny, 6, 0.2, 0, "cpu")
    assert set(result["metrics"]) == {"setup_s", "calls_per_s"}
    for p, data in before.items():
        assert p.read_bytes() == data, p
