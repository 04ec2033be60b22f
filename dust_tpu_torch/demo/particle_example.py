"""Particle 2-D navigation with obstacles: DuSt with changing dynamics
(counterpart of `demo/particle_example.py`). The SVMPC + MPF dual loop
drives a point mass across an occupancy-grid world; the simulator mass
grows a quarter of the way in and the MPF posterior tracks it online.

    python -m dust_tpu_torch.demo.particle_example [--steps N] [--episodes N]
        [--seed N] [--render] [--save] [--tuned] [--config YAML]
        [--device cuda|cpu]

`--render` needs matplotlib (and OpenCV or moviepy for the video);
`--config` and `--save` need PyYAML.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..device import resolve_device
from ..experiments import PARTICLE_DEMO_CONFIG, PARTICLE_TUNED_CONFIG
from ..utils.helper import create_video_from_plots, save_progress, to_np
from ..utils.plots_html import map_coords
from . import (
    add_device_argument,
    choose_config,
    run_particle,
    seeded_generators,
)


def _map_axes(model):
    """A figure and axes with the occupancy map, start and target drawn,
    and the world -> map-cell transform."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    ax.imshow(np.asarray(model.obst_map.map).T, cmap="Oranges",
              origin="lower")
    to_map = lambda xy: map_coords(model, xy)  # noqa: E731
    ax.scatter(*to_map(to_np(model.init_state)[:2]), marker="o", color="r",
               s=200)
    ax.scatter(*to_map(to_np(model.target)[:2]), marker="*", color="r",
               s=200)
    return fig, ax, to_map


def render_episode(model, trajectory, out_dir):
    """The whole trajectory over the obstacle map, as trajectory.png."""
    import matplotlib.pyplot as plt

    fig, ax, to_map = _map_axes(model)
    traj_m = to_map(trajectory[:, :2])
    ax.plot(traj_m[:, 0], traj_m[:, 1], "b.-", linewidth=1, markersize=2)
    out = Path(out_dir) / "trajectory.png"
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out)
    plt.close(fig)
    return out


def render_frames(model, trajectory, out_dir, fps=20):
    """Per-step PNG frames of the trajectory so far and their MP4. One
    figure; only the trajectory artists change between frames. Returns
    (frame folder, video path or None)."""
    import matplotlib.pyplot as plt

    out_dir = Path(out_dir)
    plot_dir = out_dir / "plots"
    plot_dir.mkdir(parents=True, exist_ok=True)
    fig, ax, to_map = _map_axes(model)
    traj_m = to_map(trajectory[:, :2])
    (line,) = ax.plot([], [], "b.-", linewidth=1, markersize=2)
    (head,) = ax.plot([], [], "bo", markersize=6)
    for t in range(len(traj_m)):
        line.set_data(traj_m[: t + 1, 0], traj_m[: t + 1, 1])
        head.set_data(traj_m[t : t + 1, 0], traj_m[t : t + 1, 1])
        fig.savefig(plot_dir / f"frame_{t:04d}.png")
    plt.close(fig)
    video = create_video_from_plots(out_dir, plot_dir, fps=fps)
    return plot_dir, video


def mass_estimate(result, log_space):
    """The MPF's mass estimate at the episode's last step (the mean of its
    particles), or None without MPF particles."""
    if not len(result["dyn_particles"]):
        return None
    est = result["dyn_particles"][-1]
    if log_space:
        est = np.exp(est)
    return float(est.mean())


def run_episodes(config, steps=None, episodes=None, seed=0, device="cuda",
                 render=False, save=False):
    """Run `episodes` particle episodes of `config`, each on a stack built
    from its own generator, and print one line per episode. Returns the
    `run_particle_episode` dicts, each with "mass_estimate" and "saved"
    (folder or None) added."""
    device = resolve_device(device)
    sim = config["sim_params"]
    steps = steps or sim["steps"]
    episodes = episodes or sim["episodes"]
    gens = seeded_generators(seed, 2 * episodes, device)
    results = []
    for ep in range(episodes):
        stack, result = run_particle(config, gens[2 * ep],
                                     gens[2 * ep + 1], steps, device)
        print(
            f"episode {ep}: steps={result['steps']} "
            f"crashed={result['crashed']} success={result['success']} "
            f"cum_cost={result['cum_cost']:.1f} "
            f"final_state={np.round(result['final_state'], 2)}"
        )
        result["mass_estimate"] = None
        if stack.mpf is not None:
            result["mass_estimate"] = mass_estimate(
                result, config["exp_params"]["mpf_log_space"])
            if result["mass_estimate"] is not None:
                print(f"  MPF mass estimate: "
                      f"{result['mass_estimate']:.3f}")

        result["saved"] = None
        if save or render:
            out = save_progress(
                data={k: v for k, v in result.items()
                      if k not in ("crashed", "success", "mass_estimate",
                                   "saved")},
                params=config,
            )
            result["saved"] = out
            if render:
                png = render_episode(stack.model, result["trajectory"], out)
                print(f"  rendered {png}")
                frames, video = render_frames(
                    stack.model, result["trajectory"], out)
                n_frames = len(list(frames.glob("frame_*.png")))
                print(f"  rendered {n_frames} frames -> {video}")
        results.append(result)
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="particle navigation with a mid-episode mass change")
    parser.add_argument("--config", default=None,
                        help="a YAML config (needs PyYAML)")
    parser.add_argument("--tuned", action="store_true",
                        help="use PARTICLE_TUNED_CONFIG (the strict-success "
                        "config of particle_tuning --sweep --refine)")
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--episodes", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--render", action="store_true",
                        help="trajectory PNG, per-step frames and MP4 "
                        "(needs matplotlib)")
    parser.add_argument("--save", action="store_true")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    config = choose_config(args.config, args.tuned, PARTICLE_DEMO_CONFIG,
                           PARTICLE_TUNED_CONFIG)
    return run_episodes(config, steps=args.steps, episodes=args.episodes,
                        seed=args.seed, device=device, render=args.render,
                        save=args.save)


if __name__ == "__main__":
    main()
