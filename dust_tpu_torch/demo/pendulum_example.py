"""Pendulum swing-up: the DuSt paper's four-case comparison (counterpart of
`demo/pendulum_example.py`): DuSt-MPC (dual inference), SVMPC (mean
parameters), the MPPI baseline (exact model) and DISCO over UTF sigma
points, all on one draw of true parameter sets.

    python -m dust_tpu_torch.demo.pendulum_example [--steps N] [--episodes N]
        [--cases dust,svmpc,mppi,disco_utf] [--seed N] [--save] [--render]
        [--tuned] [--config YAML] [--device cuda|cpu]

`--render` needs matplotlib (and OpenCV or moviepy for the video);
`--config` and `--save` need PyYAML.
"""

from __future__ import annotations

import argparse
import math
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..distributions import Uniform
from ..experiments import (
    PENDULUM_DEMO_CONFIG,
    PENDULUM_TUNED_CONFIG,
    build_pendulum_stack,
)
from ..simulation import COLUMNS, PendulumSimulation
from ..utils.helper import create_video_from_plots, save_progress
from ..utils.plots_html import group_mean_std
from . import add_device_argument, choose_config, seeded_generators

CASES = {
    "dust": "DuSt-MPC",
    "svmpc": "SVMPC",
    "mppi": "MPPI Baseline",
    "disco_utf": "DISCO",
}


def render_frames(columns, out_dir, fps=20):
    """Per-step pendulum frames (PNG) of one episode's columns and their
    MP4: a rod from the pivot at angle theta (0 = upright), the bob, and
    the applied torque as a signed bar. One figure; only the rod, bob and
    torque artists change between frames. Returns (frame folder, video
    path or None)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out_dir = Path(out_dir)
    plot_dir = out_dir / "plots"
    plot_dir.mkdir(parents=True, exist_ok=True)
    thetas = np.asarray(columns["Position"])
    actions = np.asarray(columns["Actions"])
    costs = np.asarray(columns["Cost"])

    fig, ax = plt.subplots(figsize=(4, 4))
    ax.set_xlim(-1.3, 1.3)
    ax.set_ylim(-1.3, 1.3)
    ax.set_aspect("equal")
    ax.axhline(0.0, color="#cccccc", lw=0.8, zorder=0)
    ax.axvline(0.0, color="#cccccc", lw=0.8, zorder=0)
    (rod,) = ax.plot([], [], lw=5, color="#8b5a2b", solid_capstyle="round")
    (bob,) = ax.plot([], [], "o", markersize=14, color="#1f77b4")
    (torque,) = ax.plot([], [], lw=6, color="#d62728",
                        solid_capstyle="butt")
    title = ax.set_title("")
    for t in range(len(thetas)):
        x, y = math.sin(thetas[t]), math.cos(thetas[t])
        rod.set_data([0.0, x], [0.0, y])
        bob.set_data([x], [y])
        torque.set_data([0.0, actions[t] / 2.0], [-1.2, -1.2])
        title.set_text(f"t={t}  cost={costs[t]:.2f}")
        fig.savefig(plot_dir / f"frame_{t:04d}.png")
    plt.close(fig)
    video = create_video_from_plots(out_dir, plot_dir, fps=fps)
    return plot_dir, video


def draw_parameter_sets(generator, episodes, device):
    """`episodes` true (length, mass) sets from the Uniform(0.6, 1.3)
    prior, shared by all cases."""
    dev = resolve_device(device)
    prior = Uniform(torch.tensor([0.6, 0.6], device=dev),
                    torch.tensor([1.3, 1.3], device=dev), event_ndims=1)
    draws = prior.sample(generator, (episodes,)).tolist()
    return [{"length": d[0], "mass": d[1]} for d in draws]


def episode_rows(columns, episode):
    """The rows of one episode of a column mapping."""
    rows = columns["Iteration"] == episode
    return {k: v[rows] for k, v in columns.items() if v is not None}


def tail_costs(columns, steps):
    """Per episode, the mean of its last max(steps // 10, 1) costs:
    (episode indices, means in the costs' dtype), the numbers of JAX's
    `df.groupby("Iteration")["Cost"].apply(lambda s: s.tail(k).mean())`."""
    k = max(steps // 10, 1)
    iteration, cost = columns["Iteration"], columns["Cost"]
    episodes = np.unique(iteration)
    means = [cost[iteration == i][-k:].mean() for i in episodes]
    return episodes, np.asarray(means, dtype=cost.dtype)


def final_summary(columns_by_case, steps):
    """{case label: the mean AvgCumCost of its episodes at the last step},
    labels sorted: the numbers of JAX's
    `df[df["Timestep"] == steps - 1].groupby("Case")["AvgCumCost"].mean()`
    (pandas' compensated sum, `group_mean_std`)."""
    labels, values = [], []
    for label, cols in columns_by_case.items():
        last = cols["AvgCumCost"][cols["Timestep"] == steps - 1]
        labels += [label] * len(last)
        values.append(last)
    keys, means, _ = group_mean_std(np.asarray(labels, dtype=object),
                                    np.concatenate(values))
    return dict(zip(keys, means))


def combine_cases(columns_by_case):
    """One column mapping of every case's rows, in case order, with a
    "Case" column of labels (JAX's concatenated DataFrame). A column with
    one row shape in every case is concatenated; any other becomes an
    object array of per-row cells (None where a case has no such
    column)."""
    parts = list(columns_by_case.values())
    n_rows = [len(cols["Cost"]) for cols in parts]
    out = {}
    for name in COLUMNS:
        cols = [c[name] for c in parts]
        if all(c is not None for c in cols) and \
                len({c.shape[1:] for c in cols}) == 1:
            out[name] = np.concatenate(cols)
            continue
        cells = []
        for c, n in zip(cols, n_rows):
            cells += [None] * n if c is None else list(c)
        out[name] = np.empty(len(cells), dtype=object)
        for i, cell in enumerate(cells):
            out[name][i] = cell
    out["Case"] = np.asarray([label for label, n in zip(columns_by_case,
                                                         n_rows)
                              for _ in range(n)], dtype=object)
    return out


def _print_series(index_name, items, name, dtype):
    """A pandas-Series-like block: index name, one "key  value" line per
    item, the name and dtype."""
    print(index_name)
    width = max(len(str(k)) for k, _ in items)
    for k, v in items:
        print(f"{str(k):<{width}}    {str(v)}")
    print(f"Name: {name}, dtype: {dtype}")


def run_cases(config, cases=tuple(CASES), steps=None, episodes=None, seed=0,
              device="cuda", parameters_set=None, render=False, save=False):
    """Run each case of `cases` on one list of true parameter sets
    (`parameters_set`, or `episodes` draws from the prior) and print the
    report. Returns {"parameters_set", "columns" (case label ->
    `PendulumSimulation.run`'s columns), "tail" (label -> (episodes,
    means)), "summary" (label -> mean AvgCumCost at the last step),
    "frames" (label -> (frame folder, video)), "saved" (folder or
    None)}."""
    device = resolve_device(device)
    sim = config["sim_params"]
    steps = steps or sim["steps"]
    episodes = episodes or sim["episodes"]
    gens = seeded_generators(seed, 1 + 2 * len(cases), device)
    if parameters_set is None:
        parameters_set = draw_parameter_sets(gens[0], episodes, device)
    print("true parameter sets:", parameters_set)

    columns, tails, frames = {}, {}, {}
    for i, case in enumerate(cases):
        label = CASES[case]
        print(f"\nRunning {label} simulation:")
        g_build, g_run = gens[1 + 2 * i], gens[2 + 2 * i]
        stack = build_pendulum_stack(config, g_build, case=case,
                                     device=device)
        harness = PendulumSimulation(
            controller=stack.controller,
            svmpc=stack.svmpc,
            mpf=stack.mpf,
            model=stack.model,
            steps=steps,
            warm_up=sim["warm_up"],
            use_svmpc=stack.svmpc is not None,
            mpf_bw=stack.mpf_bw,
            mpf_steps=stack.mpf_steps,
            # the MPPI baseline plans with each episode's exact model
            use_exact_model=(case == "mppi"),
            device=device,
        )
        cols = harness.run(
            g_run,
            parameters_set,
            init_state=stack.init_state,
            init_policies=stack.init_policies,
            policies_prior=stack.policies_prior,
            dyn_dist=stack.dynamics_prior,
            mpf_init=stack.mpf_init,
            verbose=True,
        )
        columns[label] = cols
        tails[label] = tail_costs(cols, steps)
        print(f"{label}: mean terminal cost per episode:")
        _print_series("Iteration", list(zip(*tails[label])), "Cost",
                      cols["Cost"].dtype)
        if render:
            out = save_progress(data=cols, params=config)
            plot_dir, video = render_frames(episode_rows(cols, 0), out)
            frames[label] = (plot_dir, video)
            n_frames = len(list(plot_dir.glob("frame_*.png")))
            print(f"  rendered {n_frames} frames -> {video}")

    summary = final_summary(columns, steps)
    print("\nSummary (mean AvgCumCost at final step):")
    _print_series("Case", list(summary.items()), "AvgCumCost",
                  np.asarray(list(summary.values())).dtype)
    saved = None
    if save:
        saved = save_progress(data=combine_cases(columns), params=config)
        print(f"saved to {saved}")
    return {"parameters_set": parameters_set, "columns": columns,
            "tail": tails, "summary": summary, "frames": frames,
            "saved": saved}


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="the DuSt paper's four pendulum cases")
    parser.add_argument("--config", default=None,
                        help="a YAML config (needs PyYAML)")
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--episodes", type=int, default=None)
    parser.add_argument("--cases", default="dust,svmpc,mppi,disco_utf")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--save", action="store_true")
    parser.add_argument("--render", action="store_true",
                        help="per-step pendulum frames + MP4 for each "
                        "case's episode 0 (needs matplotlib)")
    parser.add_argument("--tuned", action="store_true",
                        help="use the robustness-tuned config "
                        "(PENDULUM_TUNED_CONFIG, the --tail search's)")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    config = choose_config(args.config, args.tuned, PENDULUM_DEMO_CONFIG,
                           PENDULUM_TUNED_CONFIG)
    return run_cases(config, cases=args.cases.split(","), steps=args.steps,
                     episodes=args.episodes, seed=args.seed, device=device,
                     render=args.render, save=args.save)


if __name__ == "__main__":
    main()
