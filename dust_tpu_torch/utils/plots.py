"""Result plots on matplotlib and seaborn (counterpart of
`dust_tpu/utils/plots.py`):

* `plot_mean_results`     — mean cost / avg-cum-cost per case over time
* `plot_stein_particles`  — policy-particle scatter with posterior weights
* `plot_part2d_cost`      — particle-task cost curves with std bands
* `plot_part2d_traj`      — trajectory overlays on the occupancy map
* `plot_dist_ridgeplot`   — MPF posterior ridgeline vs the true parameter

They take the column mapping that `PendulumSimulation.run` returns (or a
DataFrame), the port's `Particle`, and arrays or tensors; each draws the
same artists' data as JAX's function on the same inputs. matplotlib (and
seaborn for the ridgeline) is imported inside each function, so the
module imports without them.
"""

from __future__ import annotations

import numpy as np

from .helper import to_np
from .plots_html import (
    case_rows,
    column,
    group_mean_std,
    map_coords,
    selected_rows,
)


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_mean_results(df, value="AvgCumCost", save_path=None, ax=None):
    """Per-case mean of `value` over time with a std band. `df`: a mapping
    of columns with "Timestep", `value` and optionally "Case"."""
    plt = _plt()
    ax = ax or plt.figure(figsize=(8, 5)).gca()
    timestep, values = column(df, "Timestep"), column(df, value)
    for case, rows in case_rows(df):
        steps, mean, std = group_mean_std(timestep[rows], values[rows])
        std = np.where(np.isnan(std), std.dtype.type(0.0), std)
        ax.plot(steps, mean, label=str(case))
        ax.fill_between(steps, mean - std, mean + std, alpha=0.2)
    ax.set_xlabel("Timestep")
    ax.set_ylabel(value)
    ax.legend()
    if save_path is not None:
        plt.savefig(save_path, bbox_inches="tight")
        plt.close()
    return ax


def plot_stein_particles(df, timesteps=None, save_path=None):
    """Policy-particle first-action scatter colored by posterior weight.
    `df`: a mapping of columns with "Timestep", "PolParticles" and
    "Weights"; `timesteps` selects rows."""
    plt = _plt()
    timestep = column(df, "Timestep")
    particles_col = column(df, "PolParticles")
    weights_col = column(df, "Weights")
    fig, ax = plt.subplots(figsize=(8, 5))
    sc = None
    for i in selected_rows(df, timesteps):
        particles = np.asarray(particles_col[i], dtype=float)
        weights = np.asarray(weights_col[i], dtype=float)
        t = np.full_like(particles, timestep[i])
        sc = ax.scatter(t, particles, c=weights, cmap="viridis", s=25,
                        vmin=0.0, vmax=1.0)
    if sc is not None:
        fig.colorbar(sc, ax=ax, label="posterior weight")
    ax.set_xlabel("Timestep")
    ax.set_ylabel("first action of each particle")
    if save_path is not None:
        fig.savefig(save_path, bbox_inches="tight")
        plt.close(fig)
    return ax


def plot_part2d_cost(costs_list, labels=None, save_path=None):
    """Cost curves with std bands across runs. costs_list: a list of [T]
    arrays or a [N, T] array."""
    plt = _plt()
    arr = np.asarray(to_np(costs_list), dtype=float)
    if arr.ndim == 1:
        arr = arr[None]
    fig, ax = plt.subplots(figsize=(8, 5))
    mean = np.nanmean(arr, axis=0)
    std = np.nanstd(arr, axis=0)
    t = np.arange(arr.shape[1])
    label = labels if isinstance(labels, str) else None
    ax.plot(t, mean, label=label)
    ax.fill_between(t, mean - std, mean + std, alpha=0.25)
    ax.set_xlabel("step")
    ax.set_ylabel("instantaneous cost")
    if label:
        ax.legend()
    if save_path is not None:
        fig.savefig(save_path, bbox_inches="tight")
        plt.close(fig)
    return ax


def plot_part2d_traj(model, trajectories, save_path=None, rollouts=None):
    """Trajectory overlays on the occupancy map of the port's `Particle`.
    `trajectories`: a list of [T, >=2] state arrays or tensors in world
    coordinates; `rollouts`: [batch, T, >=2]."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 6))
    if model.with_obstacle:
        ax.imshow(np.asarray(model.obst_map.map).T, cmap="Oranges",
                  origin="lower")
    if model.init_state is not None:
        ax.scatter(*map_coords(model, to_np(model.init_state)[:2]),
                   marker="o", c="r", s=150)
    ax.scatter(*map_coords(model, to_np(model.target)[:2]), marker="*",
               c="r", s=150)
    for traj in trajectories:
        m = map_coords(model, to_np(traj)[:, :2])
        ax.plot(m[:, 0], m[:, 1], linewidth=1)
    if rollouts is not None:
        for ro in to_np(rollouts):
            m = map_coords(model, ro[:, :2])
            ax.plot(m[:, 0], m[:, 1], alpha=0.25, linewidth=0.6)
    if save_path is not None:
        fig.savefig(save_path, bbox_inches="tight")
        plt.close(fig)
    return ax


def plot_dist_ridgeplot(dyn_particles, true_value=None, log_space=False,
                        every=10, save_path=None, bw_adjust=1.0):
    """MPF posterior over time as a ridgeline: one KDE row per sampled
    step, an optional true-parameter line. `dyn_particles`: a [T, n] array
    or tensor (the first uncertain dimension)."""
    plt = _plt()
    import seaborn as sns

    arr = np.asarray(to_np(dyn_particles), dtype=float)
    if log_space:
        arr = np.exp(arr)
    steps = list(range(0, arr.shape[0], every))
    fig, axes = plt.subplots(
        len(steps), 1, figsize=(7, 1.0 * len(steps)), sharex=True
    )
    if len(steps) == 1:
        axes = [axes]
    for ax, t in zip(axes, steps):
        sns.kdeplot(x=arr[t].ravel(), ax=ax, fill=True,
                    bw_adjust=bw_adjust)
        ax.set_ylabel(f"t={t}", rotation=0, ha="right")
        ax.set_yticks([])
        if true_value is not None:
            ax.axvline(true_value, ls="--", c="r")
    axes[-1].set_xlabel("parameter value")
    if save_path is not None:
        fig.savefig(save_path, bbox_inches="tight")
        plt.close(fig)
    return axes
