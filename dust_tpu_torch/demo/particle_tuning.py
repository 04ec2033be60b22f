"""Particle-navigation hyperparameter tuning (counterpart of
`demo/particle_tuning.py`). Two modes:

* default: random search over lr / alpha / prior sigma / weighted prior /
  ctrl sigma / horizon, each trial one closed-loop episode scored by its
  cumulative cost (+inf on a crash);
* `--sweep`: strict-success tuning, each trial one 8-scenario robustness
  sweep (true masses 1.5-3.0) in one sweep-kernel (K10) launch, scored on
  the strict success test (the full 4-dim state within 1.0 of the
  target); the best config is scored again on three held-out seeds.
  `--refine` searches the neighborhood the wide search converged to.
  With dt 0.015 and a speed limit of 5 per axis, (-9, -9) -> (9, 9) takes
  at least 240 steps, so strict success needs --steps well above 240
  (the tuned config was found at 600).

    python -m dust_tpu_torch.demo.particle_tuning [--trials N] [--steps N]
        [--sweep [--refine]] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import copy

import torch

from ..device import resolve_device
from ..experiments import PARTICLE_DEMO_CONFIG
from ..tuning import (
    particle_sweep_asha_objective,
    random_search,
    successive_halving,
)
from . import add_device_argument, run_particle
from .sweep_example import particle_grid

SPACE = {
    "learning_rate": (1.0, 300.0, "log"),
    "alpha": (0.25, 4.0, "log"),
    "prior_sigma": (1.0, 10.0),
    "weighted_prior": [True, False],
    "ctrl_sigma": (1.0, 10.0),
    "horizon": [30, 40, 50],
}

# --sweep: the continuous keys are scalar arguments of K10; w_qvel_T (the
# terminal velocity weight) and shape = (n_particles, horizon) are grids
SWEEP_SPACE = {
    "learning_rate": (1.0, 300.0, "log"),
    "alpha": (0.25, 16.0, "log"),
    "prior_sigma": (1.0, 10.0),
    "ctrl_sigma": (1.0, 12.0),
    "w_qvel_T": [0.1, 100.0, 400.0],
    "shape": [(6, 40), (4, 56)],
}

# --refine: the neighborhood the wide search converged to (lr 210, alpha
# 0.29, prior_sigma 9.3, ctrl_sigma 7.7, w_qvel_T 400, shape (6, 40));
# run it at --steps 600
REFINE_SPACE = {
    "learning_rate": (80.0, 400.0, "log"),
    "alpha": (0.1, 1.0, "log"),
    "prior_sigma": (5.0, 12.0),
    "ctrl_sigma": (5.0, 11.0),
    "w_qvel_T": [400.0, 800.0],
    "shape": [(6, 40), (4, 56)],
}

# the held-out sweep seeds, offsets of --seed
HELD_OUT = (100, 200, 300)


def tune(base_config, trials=10, steps=100, seed=0, sweep=False,
         refine=False, device="cuda"):
    """Run the mode the arguments select on `base_config` and print its
    report. Returns {"mode", "best", "value", "history"} and, for
    --sweep, "episode_equivalents" and "held_out" (the best config's score
    per held-out seed)."""
    device = resolve_device(device)
    if sweep:
        masses = particle_grid(device)
        space = REFINE_SPACE if refine else SWEEP_SPACE
        objective = particle_sweep_asha_objective(
            base_config, masses, seed=seed, verbose=True, device=device)
        best, value, history, episodes = successive_halving(
            objective, space, n_configs=trials, eta=4, min_budget=steps,
            max_budget=steps, seed=seed)
        print(f"\nbest: {best} -> {value:.4f} "
              f"({episodes:.0f} episode-equivalents)")
        # the tuned config must succeed on noise it was not tuned on
        held_out = {}
        if best is not None:
            for offset in HELD_OUT:
                ho = particle_sweep_asha_objective(
                    base_config, masses, seed=seed + offset, verbose=True,
                    device=device)
                held_out[seed + offset] = float(ho([best], steps)[0])
        return {"mode": "sweep", "best": best, "value": value,
                "history": history, "episode_equivalents": episodes,
                "held_out": held_out}

    def objective(trial):
        config = copy.deepcopy(base_config)
        config["exp_params"].update(trial)
        _, result = run_particle(
            config, torch.Generator(device=device).manual_seed(seed),
            torch.Generator(device=device).manual_seed(seed + 1), steps,
            device)
        return result["cum_cost"]  # inf on a crash

    best, value, history = random_search(objective, SPACE, trials,
                                         seed=seed, verbose=True)
    print(f"\nbest: {best} -> {value:.3f}")
    return {"mode": "random_search", "best": best, "value": value,
            "history": history}


def main(argv=None):
    parser = argparse.ArgumentParser(description="particle tuning")
    parser.add_argument("--trials", type=int, default=10)
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--sweep", action="store_true",
                        help="strict-success tuning over the sweep kernel")
    parser.add_argument("--refine", action="store_true",
                        help="with --sweep: search the converged "
                        "neighborhood (REFINE_SPACE) instead of the "
                        "wide space")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    return tune(copy.deepcopy(PARTICLE_DEMO_CONFIG), trials=args.trials,
                steps=args.steps, seed=args.seed, sweep=args.sweep,
                refine=args.refine, device=device)


if __name__ == "__main__":
    main()
