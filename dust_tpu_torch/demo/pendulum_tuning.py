"""Pendulum hyperparameter tuning (counterpart of `demo/pendulum_tuning.py`):
random search over lr / alpha / prior sigma / horizon minimizing the mean
episode cost, and three batched modes:

* `--parallel-lr N`: N learning rates as the lanes of one ScenarioSweep;
* `--asha N`: successive halving over N configs, the trials sharing
  (alpha, horizon) as lanes of one sweep per rung;
* `--tail N`: successive halving over N configs minimizing the worst-corner
  tail cost of the 8-scenario robustness sweep, one sweep-kernel (K5)
  launch per trial and sweep seed.

    python -m dust_tpu_torch.demo.pendulum_tuning [--trials N] [--steps N]
    python -m dust_tpu_torch.demo.pendulum_tuning --parallel-lr 16
    python -m dust_tpu_torch.demo.pendulum_tuning --tail 81 --seeds 3 --max-budget 200
"""

from __future__ import annotations

import argparse
import copy

import numpy as np
import torch

from ..device import resolve_device
from ..experiments import PENDULUM_DEMO_CONFIG, build_pendulum_stack
from ..simulation import PendulumSimulation
from ..tuning import (
    parallel_lr_sweep,
    pendulum_asha_objective,
    pendulum_sweep_tail_objective,
    random_search,
    successive_halving,
)
from ..utils.helper import to_np
from . import add_device_argument
from .sweep_example import pendulum_grid

SPACE = {
    "learning_rate": (0.1, 10.0, "log"),
    "alpha": (0.25, 4.0, "log"),
    "prior_sigma": (0.5, 5.0),
    "horizon": [20, 30, 40],
}

# the ASHA space draws alpha and horizon from grids, so each rung runs the
# trials that share them as lanes of one sweep
ASHA_SPACE = {
    "learning_rate": (0.1, 10.0, "log"),
    "alpha": [0.25, 0.5, 1.0, 2.0, 4.0],
    "prior_sigma": (0.5, 5.0),
    "horizon": [20, 30, 40],
}

# --tail: every key is a scalar argument of the sweep kernel; the ranges
# bracket the demo config (lr 2, alpha 1, ctrl_sigma 2, prior_sigma 2)
TAIL_SPACE = {
    "learning_rate": (0.5, 15.0, "log"),
    "alpha": (0.5, 2.0, "log"),
    "ctrl_sigma": (1.0, 4.0),
    "prior_sigma": (1.0, 4.0),
}

TRUE_PARAMS = {"length": 1.0, "mass": 1.0}


def svmpc_harness(config, seed, steps, device):
    """(stack, harness): the svmpc case of `config` built from `seed` and
    a `PendulumSimulation` of `steps` steps on it, no warm-up."""
    stack = build_pendulum_stack(
        config, torch.Generator(device=device).manual_seed(seed),
        case="svmpc", device=device)
    harness = PendulumSimulation(
        controller=stack.controller, svmpc=stack.svmpc, model=stack.model,
        steps=steps, warm_up=0, device=device)
    return stack, harness


def tune(base_config, trials=20, steps=100, seed=0, parallel_lr=0, asha=0,
         max_budget=0, tail=0, seeds=2, device="cuda"):
    """Run the mode the arguments select on `base_config` and print its
    report. Returns {"mode", "best", "value"} and the mode's own keys:
    "history" (every search), "episode_equivalents" (asha, tail), "lrs"
    and "costs" (parallel_lr)."""
    device = resolve_device(device)
    if tail:
        # every sampled key is a scalar argument of K5: no rebuild per trial
        max_budget = max_budget or max(steps, 200)
        lens, mass = pendulum_grid(device)
        objective = pendulum_sweep_tail_objective(
            base_config, lens, mass, seed=seed, verbose=True,
            n_seeds=seeds, device=device)
        best, value, history, episode_eq = successive_halving(
            objective, TAIL_SPACE, tail, eta=3,
            min_budget=max(25, max_budget // 9),
            max_budget=max_budget, seed=seed, verbose=True,
        )
        print(f"\nbest: {best} -> worst-corner tail {value:.4f} "
              f"({episode_eq:.1f} sweep-equivalents for {tail} configs)")
        return {"mode": "tail", "best": best, "value": value,
                "history": history, "episode_equivalents": episode_eq}

    if asha:
        max_budget = max_budget or steps
        objective = pendulum_asha_objective(
            base_config, TRUE_PARAMS, seed=seed, device=device)
        best, value, history, episode_eq = successive_halving(
            objective, ASHA_SPACE, asha, eta=3,
            min_budget=max(1, max_budget // 9), max_budget=max_budget,
            seed=seed, verbose=True,
        )
        print(f"\nbest: {best} -> {value:.3f} "
              f"({episode_eq:.1f} episode-equivalents for {asha} configs; "
              f"the reference's Optuna study spends 200)")
        return {"mode": "asha", "best": best, "value": value,
                "history": history, "episode_equivalents": episode_eq}

    if parallel_lr:
        # N lanes of one ScenarioSweep, each lane's rate on its own state
        stack, harness = svmpc_harness(copy.deepcopy(base_config), seed,
                                       steps, device)
        lrs = np.logspace(-1, 1, parallel_lr)
        costs = to_np(parallel_lr_sweep(harness, stack, lrs, seed + 1,
                                        TRUE_PARAMS))
        for lr, c in zip(lrs, costs):
            print(f"lr={lr:8.3f}  avg_cum_cost={c:10.2f}")
        best = int(np.nanargmin(costs))
        print(f"best lr: {float(lrs[best]):.3f} "
              f"(cost {float(costs[best]):.2f})")
        return {"mode": "parallel_lr", "best": float(lrs[best]),
                "value": float(costs[best]), "lrs": lrs, "costs": costs}

    def objective(trial):
        config = copy.deepcopy(base_config)
        config["exp_params"].update(
            learning_rate=trial["learning_rate"],
            alpha=trial["alpha"],
            prior_sigma=trial["prior_sigma"],
            horizon=trial["horizon"],
        )
        stack, harness = svmpc_harness(config, seed, steps, device)
        cols = harness.run(
            torch.Generator(device=device).manual_seed(seed + 1),
            [TRUE_PARAMS],
            init_state=stack.init_state,
            init_policies=stack.init_policies,
            policies_prior=stack.policies_prior,
            dyn_dist=stack.dynamics_prior,
        )
        return float(cols["Cost"].mean())

    best, value, history = random_search(objective, SPACE, trials,
                                         seed=seed, verbose=True)
    print(f"\nbest: {best} -> {value:.3f}")
    return {"mode": "random_search", "best": best, "value": value,
            "history": history}


def main(argv=None):
    parser = argparse.ArgumentParser(description="pendulum tuning")
    parser.add_argument("--trials", type=int, default=20)
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--parallel-lr", type=int, default=0,
                        help="evaluate N learning rates in one sweep")
    parser.add_argument("--asha", type=int, default=0,
                        help="batched successive halving over N configs")
    parser.add_argument("--max-budget", type=int, default=0,
                        help="ASHA full-episode budget (default --steps)")
    parser.add_argument("--tail", type=int, default=0,
                        help="ASHA over N configs minimizing the "
                        "worst-corner tail cost of the 8-scenario "
                        "robustness sweep (K5)")
    parser.add_argument("--seeds", type=int, default=2,
                        help="--tail: sweep seeds averaged per trial")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    return tune(copy.deepcopy(PENDULUM_DEMO_CONFIG), trials=args.trials,
                steps=args.steps, seed=args.seed,
                parallel_lr=args.parallel_lr, asha=args.asha,
                max_budget=args.max_budget, tail=args.tail,
                seeds=args.seeds, device=device)


if __name__ == "__main__":
    main()
