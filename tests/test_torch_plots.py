"""`dust_tpu_torch.utils.plots_html`, `utils.plots` and the plotting
helpers against `dust_tpu`'s on the same data.

The pendulum columns come from one seeded numpy draw in the schema of
`PendulumSimulation.run` (three cases, three episodes each); the JAX side
gets them as the DataFrame its harness returns (`to_dataframe` plus a
"Case" column, concatenated), the port side as the column mapping. Every
`plots_html` function returns JAX's string to the character and
`vega_lite_mean_results` an equal spec; every `plots` function draws the
same artists' data (line x/y, band vertices, scatter offsets and colors,
images) under the Agg backend. The particle map comes from both packages'
`Particle` built from the demo config. `Particle.to_map_coord` is held to
JAX's at rtol 1e-6, `ObstacleMap.plot` to JAX's image, and
`create_video_from_plots` writes an MP4 with OpenCV and returns None with
JAX's message where neither moviepy nor OpenCV imports."""

import json
import sys

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from dust_tpu.models import Particle as JParticle  # noqa: E402
from dust_tpu.utils import helper as jhelper  # noqa: E402
from dust_tpu.utils import plots as jplots  # noqa: E402
from dust_tpu.utils import plots_html as jhtml  # noqa: E402
from dust_tpu_torch.experiments import PARTICLE_DEMO_CONFIG  # noqa: E402
from dust_tpu_torch.models import Particle as TParticle  # noqa: E402
from dust_tpu_torch.simulation import COLUMNS, to_dataframe  # noqa: E402
from dust_tpu_torch.utils import helper as thelper  # noqa: E402
from dust_tpu_torch.utils import plots as tplots  # noqa: E402
from dust_tpu_torch.utils import plots_html as thtml  # noqa: E402

CASES = ("DuSt-MPC", "SVMPC", "MPPI Baseline")
EPISODES, STEPS = 3, 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


def _episode(rng, episode):
    """One episode's columns in `PendulumSimulation.run`'s schema."""
    cost = rng.gamma(1.0, 20.0, STEPS).astype(np.float32)
    ts = np.arange(STEPS)
    return {
        "Cost": cost,
        "Position": rng.normal(size=STEPS).astype(np.float32),
        "Speed": rng.normal(size=STEPS).astype(np.float32),
        "Actions": rng.normal(size=STEPS).astype(np.float32),
        "Timestep": ts,
        "Iteration": np.full(STEPS, episode),
        "DynParticles": None,
        "DynBandwidths": np.zeros(STEPS, np.float32),
        "PolParticles": rng.normal(size=(STEPS, 3)).astype(np.float32),
        "Weights": rng.dirichlet(np.ones(3), STEPS).astype(np.float32),
        "ExpParams": np.tile([1.0, 1.0], (STEPS, 1)),
        "AvgCumCost": np.round(np.cumsum(cost) / (ts + 1), 2),
    }


@pytest.fixture(scope="module")
def pendulum_data():
    """(the port's column mapping, JAX's DataFrame) of the same rows."""
    rng = np.random.default_rng(0)
    episodes = [(case, _episode(rng, ep)) for case in CASES
                for ep in range(EPISODES)]
    mapping = {name: np.concatenate([cols[name] for _, cols in episodes])
               for name in COLUMNS if name != "DynParticles"}
    mapping["Case"] = np.asarray([case for case, _ in episodes
                                  for _ in range(STEPS)], dtype=object)
    df = pd.concat([to_dataframe(cols).assign(Case=case)
                    for case, cols in episodes])
    return mapping, df


@pytest.fixture(scope="module")
def particles():
    """The demo config's particle model in both packages."""
    env = PARTICLE_DEMO_CONFIG["env_params"]
    return (JParticle(uncertain_params=["mass"], mass=2.0, **env),
            TParticle(uncertain_params=["mass"], mass=2.0, device="cpu",
                      **env))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_group_mean_std_equals_pandas(dtype):
    """pandas' group mean (compensated sum) and std (Welford, ddof 1) to
    the bit, NaN skipped, a group of one with a NaN std."""
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 7, 200)
    values = (rng.normal(size=200) * 10.0 ** rng.uniform(-3, 3, 200)) \
        .astype(dtype)
    values[::17] = np.nan
    keys = np.append(keys, 9)                  # a group of one
    values = np.append(values, dtype(3.5))
    want = pd.DataFrame({"k": keys, "v": values}).groupby("k")["v"].agg(
        ["mean", "std"])
    got_keys, mean, std = thtml.group_mean_std(keys, values)
    np.testing.assert_array_equal(got_keys, want.index.to_numpy())
    assert mean.dtype == want["mean"].dtype and std.dtype == want["std"].dtype
    np.testing.assert_array_equal(mean, want["mean"].to_numpy())
    np.testing.assert_array_equal(std, want["std"].to_numpy())


@pytest.mark.parametrize("value", ["AvgCumCost", "Cost"])
def test_html_mean_results_equals_jax(pendulum_data, value, tmp_path):
    mapping, df = pendulum_data
    want = jhtml.html_mean_results(df, value=value)
    assert thtml.html_mean_results(mapping, value=value) == want
    # a DataFrame is a mapping of columns too
    assert thtml.html_mean_results(df, value=value) == want
    # no "Case" column: one series named "run"
    one = {k: v for k, v in mapping.items() if k != "Case"}
    assert thtml.html_mean_results(one, value=value) == \
        jhtml.html_mean_results(df.drop(columns="Case"), value=value)
    path = tmp_path / "mean.html"
    thtml.html_mean_results(mapping, value=value, save_path=path)
    assert path.read_text() == want


@pytest.mark.parametrize("timesteps", [None, [1, 5, 11]])
def test_html_stein_particles_equals_jax(pendulum_data, timesteps):
    mapping, df = pendulum_data
    assert thtml.html_stein_particles(mapping, timesteps=timesteps) == \
        jhtml.html_stein_particles(df, timesteps=timesteps)


def test_html_part2d_cost_equals_jax():
    rng = np.random.default_rng(2)
    costs = rng.gamma(2.0, 5.0, (4, 30))
    costs[1, 3] = np.nan
    assert thtml.html_part2d_cost(costs, labels="run") == \
        jhtml.html_part2d_cost(costs, labels="run")
    assert thtml.html_part2d_cost(list(costs[0])) == \
        jhtml.html_part2d_cost(list(costs[0]))


def test_html_part2d_traj_equals_jax(particles):
    jm, tm = particles
    rng = np.random.default_rng(3)
    trajs = [np.cumsum(rng.normal(0.0, 0.3, (25, 4)), axis=0) - 9.0
             for _ in range(2)]
    rollouts = np.cumsum(rng.normal(0.0, 0.3, (3, 10, 4)), axis=1)
    want = jhtml.html_part2d_traj(jm, trajs, rollouts=rollouts)
    assert thtml.html_part2d_traj(tm, trajs, rollouts=rollouts) == want
    # tensors in place of arrays
    assert thtml.html_part2d_traj(
        tm, [torch.as_tensor(t) for t in trajs],
        rollouts=torch.as_tensor(rollouts)) == want


@pytest.mark.parametrize("value", ["AvgCumCost", "CumCost"])
def test_vega_lite_spec_equals_jax(pendulum_data, value, tmp_path):
    mapping, df = pendulum_data
    want = jhtml.vega_lite_mean_results(df, value=value, title="t")
    got = thtml.vega_lite_mean_results(mapping, value=value, title="t",
                                       save_path=tmp_path / "spec.json")
    assert got == want
    assert json.dumps(got) == json.dumps(want)
    jhtml.vega_lite_mean_results(df, value=value, title="t",
                                 save_path=tmp_path / "want.json")
    assert (tmp_path / "spec.json").read_text() == \
        (tmp_path / "want.json").read_text()
    assert thtml.vega_embed_html(got) == jhtml.vega_embed_html(want)


def _lines(ax):
    return [line.get_xydata() for line in ax.lines]


def _bands(ax):
    return [p.vertices for c in ax.collections for p in c.get_paths()]


def _assert_same_arrays(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_plot_mean_results_draws_jax_artists(pendulum_data, tmp_path):
    mapping, df = pendulum_data
    got = tplots.plot_mean_results(mapping, value="Cost")
    want = jplots.plot_mean_results(df, value="Cost")
    _assert_same_arrays(_lines(got), _lines(want))
    _assert_same_arrays(_bands(got), _bands(want))
    assert [t.get_text() for t in got.get_legend().get_texts()] == \
        [t.get_text() for t in want.get_legend().get_texts()]
    tplots.plot_mean_results(mapping, save_path=tmp_path / "mean.png")
    assert (tmp_path / "mean.png").stat().st_size > 0


def test_plot_stein_particles_draws_jax_artists(pendulum_data):
    mapping, df = pendulum_data
    got = tplots.plot_stein_particles(mapping, timesteps=[0, 4])
    want = jplots.plot_stein_particles(df, timesteps=[0, 4])
    _assert_same_arrays([c.get_offsets() for c in got.collections],
                        [c.get_offsets() for c in want.collections])
    _assert_same_arrays([c.get_array() for c in got.collections],
                        [c.get_array() for c in want.collections])


def test_plot_part2d_cost_draws_jax_artists():
    costs = np.random.default_rng(4).gamma(2.0, 5.0, (4, 30))
    got = tplots.plot_part2d_cost(torch.as_tensor(costs), labels="run")
    want = jplots.plot_part2d_cost(costs, labels="run")
    _assert_same_arrays(_lines(got), _lines(want))
    _assert_same_arrays(_bands(got), _bands(want))


def test_plot_part2d_traj_draws_jax_artists(particles, tmp_path):
    jm, tm = particles
    rng = np.random.default_rng(5)
    trajs = [np.cumsum(rng.normal(0.0, 0.3, (25, 4)), axis=0) - 9.0]
    rollouts = np.cumsum(rng.normal(0.0, 0.3, (3, 10, 4)), axis=1)
    got = tplots.plot_part2d_traj(tm, trajs, rollouts=rollouts)
    want = jplots.plot_part2d_traj(jm, trajs, rollouts=rollouts)
    _assert_same_arrays([im.get_array() for im in got.images],
                        [im.get_array() for im in want.images])
    _assert_same_arrays([c.get_offsets() for c in got.collections],
                        [c.get_offsets() for c in want.collections])
    _assert_same_arrays(_lines(got), _lines(want))
    tplots.plot_part2d_traj(tm, trajs, save_path=tmp_path / "traj.png")
    assert (tmp_path / "traj.png").stat().st_size > 0


def test_plot_dist_ridgeplot_draws_jax_artists():
    dyn = np.random.default_rng(6).normal(0.7, 0.1, (25, 50))
    got = tplots.plot_dist_ridgeplot(torch.as_tensor(dyn), true_value=2.0,
                                     log_space=True, every=10)
    want = jplots.plot_dist_ridgeplot(dyn, true_value=2.0, log_space=True,
                                      every=10)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        _assert_same_arrays(_bands(a), _bands(b))
        _assert_same_arrays(_lines(a), _lines(b))
        assert a.get_ylabel() == b.get_ylabel()


def test_to_map_coord_equals_jax(particles):
    jm, tm = particles
    xy = np.random.default_rng(7).uniform(-11.0, 11.0, (40, 2))
    np.testing.assert_allclose(tm.to_map_coord(xy).numpy(),
                               np.asarray(jm.to_map_coord(xy)), rtol=1e-6)
    np.testing.assert_allclose(thtml.map_coords(tm, torch.as_tensor(xy)),
                               np.asarray(jm.to_map_coord(xy)), rtol=1e-6)


def test_obstacle_map_plot_equals_jax(particles, tmp_path):
    jm, tm = particles
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jm.obst_map.plot(save_dir=tmp_path / "j")
    tm.obst_map.plot(save_dir=tmp_path / "t", filename="map.png")
    np.testing.assert_array_equal(
        plt.imread(tmp_path / "t" / "map.png"),
        plt.imread(tmp_path / "j" / "obst_map.png"))
    tm.obst_map.plot()                        # draws, saves nothing
    assert sorted(p.name for p in tmp_path.rglob("*.png")) == \
        ["map.png", "obst_map.png"]


def _frames(folder, n=3):
    folder.mkdir(parents=True)
    for t in range(n):
        fig, ax = plt.subplots(figsize=(2, 2))
        ax.plot([0, t], [0, 1])
        fig.savefig(folder / f"frame_{t:04d}.png")
        plt.close(fig)


def test_create_video_from_plots_with_opencv(tmp_path, monkeypatch):
    import cv2

    _frames(tmp_path / "plots")
    monkeypatch.setitem(sys.modules, "moviepy", None)
    monkeypatch.setitem(sys.modules, "moviepy.editor", None)
    out = thelper.create_video_from_plots(tmp_path, fps=10)
    assert out == tmp_path / "video.mp4" and out.stat().st_size > 0
    cap = cv2.VideoCapture(str(out))
    try:
        assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 3
    finally:
        cap.release()
    # no frames: None, as JAX's
    (tmp_path / "empty").mkdir()
    assert thelper.create_video_from_plots(tmp_path, tmp_path / "empty") \
        is None


def test_create_video_from_plots_without_encoders(tmp_path, monkeypatch,
                                                  capsys):
    _frames(tmp_path / "plots", n=1)
    for name in ("moviepy", "moviepy.editor", "cv2"):
        monkeypatch.setitem(sys.modules, name, None)
    assert jhelper.create_video_from_plots(tmp_path) is None
    want = capsys.readouterr().out
    assert thelper.create_video_from_plots(tmp_path) is None
    got = capsys.readouterr().out
    assert got == want == ("Neither MoviePy nor OpenCV available. Aborting "
                           "video creation.\n")
    assert not (tmp_path / "video.mp4").exists()
