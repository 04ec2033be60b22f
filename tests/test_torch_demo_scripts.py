"""The port's entry points, `python -m dust_tpu_torch.demo.<name>`, end to
end on the CPU at tiny sizes (the counterpart of tests/test_demo_scripts.py):
each demo's `main` with `--device cpu`, its report lines and its return
value; `--render` (one PNG per step and the MP4), `--save` and `--tuned`;
`--device` defaulting to cuda and raising without a card; the package and
every demo importing, and the pendulum demo running, where pandas,
matplotlib, PyYAML, JAX and `dust_tpu` cannot be imported (a demo imports
the first three only under `--render`, `--config` or `--save`).

The pendulum demo's numpy summaries equal JAX's pandas expressions
(`demo/pendulum_example.py:160-162, 172-177`) on the same columns, and the
sweep demo's rows equal the JAX demo's formulas
(`demo/sweep_example.py:96-104, 131-139`) on the same `out` arrays, exactly.
The columns of a demo run, combined over its cases, give JAX's HTML pages
on the DataFrame JAX's demo concatenates.
"""

import json
import pickle
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from dust_tpu.utils import plots_html as jhtml
from dust_tpu_torch.demo import (
    particle_example,
    particle_tuning,
    pendulum_example,
    pendulum_tuning,
    sweep_example,
)
from dust_tpu_torch.simulation import to_dataframe
from dust_tpu_torch.utils import helper
from dust_tpu_torch.utils import plots_html as thtml

ROOT = Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]
DEMOS = (pendulum_example, particle_example, sweep_example, pendulum_tuning,
         particle_tuning)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def results_root(tmp_path, monkeypatch):
    """`save_progress`'s default root (the project root) moved to a
    temporary folder."""
    monkeypatch.setattr(helper, "get_project_root", lambda: tmp_path)
    return tmp_path


def test_pendulum_example_runs(capsys):
    res = pendulum_example.main(CPU + ["--steps", "6", "--cases",
                                       "svmpc,mppi", "--episodes", "1"])
    out = capsys.readouterr().out
    assert "true parameter sets:" in out and "Summary" in out
    assert "Running SVMPC simulation:" in out
    assert "Running MPPI Baseline simulation:" in out
    assert set(res["summary"]) == {"SVMPC", "MPPI Baseline"}
    for label, cols in res["columns"].items():
        assert cols["Cost"].shape == (6,) and np.isfinite(cols["Cost"]).all()
        # the printed summary line holds the returned number
        summary = out.split("Summary")[1]
        assert re.search(rf"^{re.escape(label)} +"
                         rf"{re.escape(str(res['summary'][label]))}$",
                         summary, re.M), summary
    length = res["parameters_set"][0]["length"]
    assert 0.6 <= length <= 1.3


def test_particle_example_runs(capsys):
    (res,) = particle_example.main(CPU + ["--steps", "6"])
    out = capsys.readouterr().out
    m = re.search(r"episode 0: steps=(\d+) crashed=(\w+) success=(\w+) "
                  r"cum_cost=(\S+) final_state=", out)
    assert m, out
    assert int(m.group(1)) == res["steps"] == 6
    assert m.group(2) == str(res["crashed"])
    assert f"MPF mass estimate: {res['mass_estimate']:.3f}" in out
    assert np.isfinite(res["cum_cost"])


@pytest.mark.parametrize("task,last", [("pendulum", "swing-up achieved"),
                                       ("particle", "success")])
def test_sweep_example_runs(task, last, capsys):
    res = sweep_example.main(CPU + ["--task", task, "--scenarios", "8",
                                    "--steps", "4"])
    out = capsys.readouterr().out
    assert last in out
    assert res["n"] == 8 and len(res["rows"]) == 8
    assert [r[0] for r in res["rows"]] == list(range(8))


def test_pendulum_tuning_parallel_lr_runs(capsys):
    res = pendulum_tuning.main(CPU + ["--parallel-lr", "2", "--steps", "5"])
    out = capsys.readouterr().out
    assert "best lr" in out and out.count("avg_cum_cost=") == 2
    assert res["best"] in res["lrs"] and np.isfinite(res["costs"]).all()


def test_pendulum_tuning_asha_runs(capsys):
    res = pendulum_tuning.main(CPU + ["--asha", "6", "--steps", "9"])
    out = capsys.readouterr().out
    assert "episode-equivalents" in out
    assert "rung 0" in out and "rung 2" in out
    assert [b for b, _ in res["history"]] == [1, 3, 9]


def test_pendulum_tuning_random_search_and_tail_run(capsys):
    res = pendulum_tuning.main(CPU + ["--trials", "2", "--steps", "4"])
    assert len(res["history"]) == 2 and np.isfinite(res["value"])
    res = pendulum_tuning.main(CPU + ["--tail", "3", "--seeds", "1",
                                      "--max-budget", "6", "--steps", "6"])
    out = capsys.readouterr().out
    assert "worst-corner tail" in out
    assert [(b, len(r)) for b, r in res["history"]] == [(6, 3)]


def test_particle_tuning_runs(capsys):
    res = particle_tuning.main(CPU + ["--trials", "2", "--steps", "4"])
    assert len(res["history"]) == 2
    res = particle_tuning.main(CPU + ["--sweep", "--trials", "2",
                                      "--steps", "4"])
    out = capsys.readouterr().out
    assert "episode-equivalents" in out
    assert sorted(res["held_out"]) == [100, 200, 300]
    assert all(np.isfinite(v) for v in res["held_out"].values())


@pytest.mark.parametrize("demo,args", [
    (pendulum_example, ["--steps", "4", "--cases", "dust"]),
    (particle_example, ["--steps", "4"]),
])
def test_tuned_config_runs(demo, args, capsys):
    demo.main(CPU + ["--tuned"] + args)
    assert "episode 0" in capsys.readouterr().out


def test_pendulum_example_render_frames_and_video(results_root, capsys):
    res = pendulum_example.main(CPU + ["--steps", "5", "--cases", "svmpc",
                                       "--episodes", "1", "--render"])
    out = capsys.readouterr().out
    m = re.search(r"rendered (\d+) frames -> (\S+)", out)
    assert m, out
    assert int(m.group(1)) == 5
    video = Path(m.group(2))
    assert video == res["frames"]["SVMPC"][1]
    assert video.name == "video.mp4" and video.stat().st_size > 0
    assert video.parent.parent == results_root / "data" / "local"
    assert len(sorted(video.parent.glob("plots/frame_*.png"))) == 5


def test_particle_example_render_frames_and_video(results_root, capsys):
    (res,) = particle_example.main(CPU + ["--steps", "5", "--render"])
    out = capsys.readouterr().out
    m = re.search(r"rendered (\d+) frames -> (\S+)", out)
    assert m, out
    assert int(m.group(1)) == res["steps"]
    video = Path(m.group(2))
    assert video.name == "video.mp4" and video.stat().st_size > 0
    assert (res["saved"] / "trajectory.png").exists()
    assert len(sorted(video.parent.glob("plots/frame_*.png"))) == \
        res["steps"]


def test_pendulum_example_save(results_root, capsys):
    res = pendulum_example.main(CPU + ["--steps", "3", "--cases",
                                       "dust,mppi", "--save"])
    assert f"saved to {res['saved']}" in capsys.readouterr().out
    with (res["saved"] / "data.pkl").open("rb") as fh:
        data = pickle.load(fh)
    assert list(data["Case"]) == ["DuSt-MPC"] * 3 + ["MPPI Baseline"] * 3
    np.testing.assert_array_equal(
        data["Cost"], np.concatenate([res["columns"][c]["Cost"]
                                      for c in ("DuSt-MPC",
                                                "MPPI Baseline")]))
    # DuSt's MPF particles per row; the mppi rows have none
    assert data["DynParticles"][0].shape == (50, 2)
    assert data["DynParticles"][5] is None
    assert (res["saved"] / "config.yaml").exists()


@pytest.mark.parametrize("demo", DEMOS, ids=lambda m: m.__name__)
def test_default_device_is_cuda_and_raises_without_a_card(demo,
                                                          monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        demo.main([])


_BLOCKED = """
import sys
for name in ("pandas", "matplotlib", "yaml", "jax", "dust_tpu", "seaborn"):
    sys.modules[name] = None
import importlib, json, pkgutil
import dust_tpu_torch
for mod in pkgutil.walk_packages(dust_tpu_torch.__path__, "dust_tpu_torch."):
    importlib.import_module(mod.name)
from dust_tpu_torch.demo import pendulum_example
res = pendulum_example.main(["--device", "cpu", "--steps", "2"])
print("COST", json.dumps(res["columns"]["DuSt-MPC"]["Cost"].tolist()))
"""


def test_demos_import_and_run_without_pandas_matplotlib_yaml_jax():
    res = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    cost = json.loads(re.search(r"COST (\[.*\])", res.stdout).group(1))
    assert len(cost) == 2 and np.isfinite(cost).all()


def test_module_entry_point_runs():
    res = subprocess.run(
        [sys.executable, "-m", "dust_tpu_torch.demo.sweep_example"] + CPU
        + ["--scenarios", "8", "--steps", "2"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "swing-up achieved: " in res.stdout


def _columns(rng, steps, episodes):
    """`PendulumSimulation.run`'s scalar columns of `episodes` episodes."""
    cost = rng.gamma(1.0, 20.0, steps * episodes).astype(np.float32)
    ts = np.tile(np.arange(steps), episodes)
    it = np.repeat(np.arange(episodes), steps)
    avg = np.concatenate([np.round(np.cumsum(c) / (np.arange(steps) + 1), 2)
                          for c in cost.reshape(episodes, steps)])
    return {"Cost": cost, "Timestep": ts, "Iteration": it,
            "AvgCumCost": avg}


@pytest.mark.parametrize("steps,episodes", [(6, 1), (37, 3), (200, 2)])
def test_pendulum_summaries_equal_jax_pandas_expressions(steps, episodes):
    rng = np.random.default_rng(steps)
    columns = {label: _columns(rng, steps, episodes)
               for label in ("DuSt-MPC", "SVMPC", "MPPI Baseline", "DISCO")}
    frames = []
    for label, cols in columns.items():
        df = pd.DataFrame(cols)
        # demo/pendulum_example.py:160-162
        want = df.groupby("Iteration")["Cost"].apply(
            lambda s: s.tail(max(steps // 10, 1)).mean())
        episodes_, means = pendulum_example.tail_costs(cols, steps)
        np.testing.assert_array_equal(episodes_, want.index.to_numpy())
        assert means.dtype == want.dtype
        np.testing.assert_array_equal(means, want.to_numpy())
        df["Case"] = label
        frames.append(df)
    result_df = pd.concat(frames, axis=0)
    # demo/pendulum_example.py:172-177
    want = result_df[result_df["Timestep"] == steps - 1] \
        .groupby("Case")["AvgCumCost"].mean()
    got = pendulum_example.final_summary(columns, steps)
    assert list(got) == list(want.index)
    np.testing.assert_array_equal(np.asarray(list(got.values())),
                                  want.to_numpy())


def test_pendulum_summaries_of_a_run_equal_jax_pandas_expressions(capsys):
    steps = 6
    res = pendulum_example.main(CPU + ["--steps", str(steps), "--cases",
                                       "svmpc,mppi", "--episodes", "2"])
    frames = []
    for label, cols in res["columns"].items():
        df = to_dataframe(cols)
        want = df.groupby("Iteration")["Cost"].apply(
            lambda s: s.tail(max(steps // 10, 1)).mean())
        np.testing.assert_array_equal(res["tail"][label][1],
                                      want.to_numpy())
        df["Case"] = label
        frames.append(df)
    result_df = pd.concat(frames, axis=0)
    want = result_df[result_df["Timestep"] == steps - 1] \
        .groupby("Case")["AvgCumCost"].mean()
    assert list(res["summary"]) == list(want.index)
    np.testing.assert_array_equal(list(res["summary"].values()),
                                  want.to_numpy())
    # the combined columns give JAX's pages on the concatenated DataFrame
    combined = pendulum_example.combine_cases(res["columns"])
    for value in ("AvgCumCost", "Cost"):
        assert thtml.html_mean_results(combined, value=value) == \
            jhtml.html_mean_results(result_df, value=value)
    assert thtml.html_stein_particles(combined) == \
        jhtml.html_stein_particles(result_df)


def test_sweep_rows_equal_jax_formulas():
    rng = np.random.default_rng(11)
    S, steps, g = 8, 40, 1
    lens = np.linspace(0.7, 1.25, S, dtype=np.float32)
    mass = np.linspace(1.25, 0.7, S, dtype=np.float32)
    cost = rng.gamma(1.0, 2.0, (steps, S)).astype(np.float32)
    j_out = {"cost": jnp.asarray(cost)}
    # demo/sweep_example.py:96-104
    j_lens, j_mass = jnp.asarray(lens), jnp.asarray(mass)
    c = np.asarray(j_out["cost"])
    half = steps // 2
    want = [(g * S + s, float(j_lens[s]), float(j_mass[s]),
             c[half:, s].min(), c[-5:, s].mean()) for s in range(S)]
    got = sweep_example.pendulum_rows({"cost": torch.as_tensor(cost)},
                                      torch.as_tensor(lens),
                                      torch.as_tensor(mass), g, steps)
    assert got == want
    assert [type(v) for v in got[0]] == [type(v) for v in want[0]]

    masses = np.linspace(1.5, 3.0, S, dtype=np.float32)
    flags = rng.integers(0, 2, (2, steps, S)).astype(np.float32)
    cum = rng.gamma(2.0, 300.0, (steps, S)).astype(np.float32)
    j_out = {"done": jnp.asarray(flags[0]), "crashed": jnp.asarray(flags[1]),
             "cum": jnp.asarray(cum)}
    # demo/sweep_example.py:131-139
    done = np.asarray(j_out["done"][-1])
    crashed = np.asarray(j_out["crashed"][-1])
    cm = np.asarray(j_out["cum"][-1])
    j_masses = jnp.asarray(masses)
    want = [(g * S + s, float(j_masses[s]),
             bool(done[s] > 0.5 and crashed[s] < 0.5),
             bool(crashed[s] > 0.5), cm[s]) for s in range(S)]
    got = sweep_example.particle_rows(
        {"done": torch.as_tensor(flags[0]),
         "crashed": torch.as_tensor(flags[1]), "cum": torch.as_tensor(cum)},
        torch.as_tensor(masses), g)
    assert got == want
    assert [type(v) for v in got[0]] == [type(v) for v in want[0]]
