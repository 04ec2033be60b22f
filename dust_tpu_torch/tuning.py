"""Hyperparameter tuning harness (counterpart of `dust_tpu/tuning.py`).

The reference tunes with sequential Optuna trials, one full episode per
trial. Here:

* `random_search` and `successive_halving`: host-side searches over any
  config keys, numpy-identical to JAX's (the same seeds give the same
  trials). Failed trials score +inf, the reference's guard.
* `parallel_lr_sweep` and `pendulum_asha_objective`: learning rates as
  lanes of one `ScenarioSweep` (sharded over `mesh` when given). Each lane
  carries its rate on its own `SVMPCState.lr`, where JAX carries it in
  `optax.inject_hyperparams` state.
* `pendulum_sweep_tail_objective` and `particle_sweep_asha_objective`:
  each trial one robustness sweep through the sweep kernels (K5, K10) in
  their device-RNG mode.

The kernel objectives score a trial +inf where its configuration is
rejected (ValueError, e.g. a shape the kernel does not take); any other
error, a kernel's among them, is raised, not scored.
"""

from __future__ import annotations

import copy
import math
from dataclasses import replace

import numpy as np
import torch

from .device import resolve_device


def sample_space(rng, space):
    """Draw one trial from `space`. Tuples are ranges — (low, high) for
    uniform, (low, high, 'log') for log-uniform, int bounds give int
    draws; lists are categorical choices."""
    trial = {}
    for name, spec in space.items():
        if isinstance(spec, tuple):
            low, high = spec[0], spec[1]
            if len(spec) == 3 and spec[2] == "log":
                value = math.exp(rng.uniform(math.log(low), math.log(high)))
            else:
                value = rng.uniform(low, high)
            if isinstance(low, int) and isinstance(high, int):
                value = int(round(value))
            trial[name] = value
        else:
            trial[name] = spec[int(rng.integers(len(spec)))]
    return trial


def random_search(objective, space, n_trials, seed=0, verbose=False):
    """Minimize `objective(trial: dict) -> float` over random draws.
    Exceptions / non-finite scores count as +inf (the reference's guard).
    Returns (best_params, best_value, history list of (params, value))."""
    rng = np.random.default_rng(seed)
    best_params, best_value = None, float("inf")
    history = []
    for i in range(n_trials):
        trial = sample_space(rng, space)
        try:
            value = float(objective(trial))
            if not math.isfinite(value):
                value = float("inf")
        except (FloatingPointError, RuntimeError, ValueError) as exc:
            if verbose:
                print(f"trial {i} failed: {exc}")
            value = float("inf")
        history.append((trial, value))
        if value < best_value:
            best_params, best_value = trial, value
        if verbose:
            print(f"trial {i}: {value:.4f} {trial} (best {best_value:.4f})")
    return best_params, best_value, history


def successive_halving(batch_objective, space, n_configs, eta=3,
                       min_budget=25, max_budget=200, seed=0,
                       verbose=False):
    """Batched successive halving (the ASHA rung schedule run
    rung-synchronously: one rung is one wide batch of trials).

    Minimizes `batch_objective(trials: list[dict], budget: int) ->
    per-trial scores [len(trials)]` where `budget` is in episode steps.
    Rung k evaluates the survivors at budget `min_budget * eta^k`
    (clipped to `max_budget`) and keeps the best `1/eta` fraction.
    Non-finite scores count as +inf.

    Returns `(best_params, best_value, history, episode_equivalents)`
    where `history` is a list of `(budget, [(trial, score), ...])` per
    rung and `episode_equivalents` is the total steps evaluated divided
    by `max_budget`."""
    rng = np.random.default_rng(seed)
    survivors = [sample_space(rng, space) for _ in range(n_configs)]

    budgets = []
    b = int(min_budget)
    while b < int(max_budget):
        budgets.append(b)
        b *= eta
    budgets.append(int(max_budget))

    history = []
    total_steps = 0
    best_params, best_value = None, float("inf")
    for k, budget in enumerate(budgets):
        scores = np.asarray(batch_objective(survivors, budget),
                            dtype=float)
        scores = np.where(np.isfinite(scores), scores, np.inf)
        total_steps += budget * len(survivors)
        history.append((budget, list(zip(survivors, scores))))
        order = np.argsort(scores, kind="stable")
        if budget == budgets[-1] and np.isfinite(scores[order[0]]):
            # full-budget scores are the real objective
            best_params = survivors[int(order[0])]
            best_value = float(scores[order[0]])
        if verbose:
            print(f"rung {k} (budget {budget}, {len(survivors)} "
                  f"trials): best {scores[order[0]]:.4f} "
                  f"{survivors[int(order[0])]}")
        keep = max(1, int(math.ceil(len(survivors) / eta)))
        survivors = [survivors[int(i)] for i in order[:keep]]
    return best_params, best_value, history, total_steps / max_budget


def set_injected_lr(svstate, lr):
    """`svstate` with its own learning rate (`SVMPCState.lr`, the rate of
    whichever optimizer the SVMPC steps by; JAX overwrites the rate inside
    `optax.inject_hyperparams` state)."""
    return replace(svstate, lr=float(lr))


def _lanes(stack, svstates, seed, true_params, mesh, harness, device):
    """Run one ScenarioSweep lane per entry of `svstates`, every lane from
    generator seed `seed` (common random numbers); returns its output."""
    from .parallel.sweep import ScenarioSweep, broadcast_scenarios

    k = len(svstates)
    params = {name: torch.full((k,), float(v), device=device)
              for name, v in true_params.items()}
    init_obs = stack.init_state.reshape(1, 1, -1).expand(
        k, 1, stack.init_state.shape[0])
    dstate = broadcast_scenarios(
        stack.controller.init_state(stack.init_policies), k)
    mstate = broadcast_scenarios(
        stack.mpf.init_state(stack.mpf_init, stack.init_state,
                             stack.controller.dim_a)
        if stack.mpf is not None else (), k)
    sweep = ScenarioSweep(harness, stack.dynamics_prior, mesh=mesh,
                          device=device)
    return sweep.run([seed] * k, params, init_obs, dstate, svstates, mstate)


def parallel_lr_sweep(harness, stack, lrs, seed, true_params, mesh=None):
    """Evaluate K learning rates as K lanes of one ScenarioSweep
    (sharded over `mesh` when given), every lane from generator seed
    `seed`. Each lane's state carries its rate (`set_injected_lr`).
    Returns avg-cum-cost [K]."""
    svstate0 = stack.svmpc.init_state(stack.init_policies,
                                      stack.policies_prior)
    svstates = [set_injected_lr(svstate0, lr) for lr in lrs]
    out = _lanes(stack, svstates, seed, true_params, mesh, harness,
                 harness.device)
    return out["avg_cum_cost"]


def pendulum_asha_objective(base_config, true_params, seed=0,
                            case="svmpc", mesh=None, device="cuda"):
    """Build a `successive_halving` batch objective for the pendulum
    SV-MPC task (the reference's tuning target).

    Trials may vary `learning_rate`, `prior_sigma` (per lane: the rate on
    the lane's state, the prior sigma in its prior's scale_tril and the
    matching spread of its initial particles), and `alpha` / `horizon`
    (per stack: trials sharing them run as lanes of one ScenarioSweep, so
    a rung costs one sweep per distinct (alpha, horizon)). Budget is
    episode steps; all lanes share one generator seed (common random
    numbers), so rung comparisons are paired."""
    from .experiments import build_pendulum_stack
    from .simulation import PendulumSimulation

    device = resolve_device(device)
    base_exp = base_config["exp_params"]

    def batch_objective(trials, budget):
        scores = np.full(len(trials), np.inf)
        groups = {}
        for i, t in enumerate(trials):
            gkey = (round(float(t.get("alpha", base_exp["alpha"])), 8),
                    int(t.get("horizon", base_exp["horizon"])))
            groups.setdefault(gkey, []).append(i)
        for (alpha, horizon), idxs in groups.items():
            config = copy.deepcopy(base_config)
            config["exp_params"].update(alpha=alpha, horizon=horizon)
            stack = build_pendulum_stack(
                config, torch.Generator(device=device).manual_seed(seed),
                case=case, device=device)
            harness = PendulumSimulation(
                controller=stack.controller, svmpc=stack.svmpc,
                model=stack.model, steps=int(budget), warm_up=0,
                device=device)
            svstate0 = stack.svmpc.init_state(stack.init_policies,
                                              stack.policies_prior)
            base_sigma = float(config["exp_params"]["prior_sigma"])
            locs = stack.policies_prior.locs

            def make_lane(t):
                lr = t.get("learning_rate", base_exp["learning_rate"])
                r = torch.tensor(t.get("prior_sigma", base_sigma)
                                 / base_sigma, dtype=torch.float32)
                prior = replace(svstate0.prior,
                                scale_tril=r * svstate0.prior.scale_tril)
                theta = locs + r * (svstate0.theta - locs)
                return set_injected_lr(replace(svstate0, theta=theta,
                                               prior=prior), lr)

            out = _lanes(stack, [make_lane(trials[i]) for i in idxs],
                         seed + 1, true_params, mesh, harness, device)
            scores[np.asarray(idxs)] = out["avg_cum_cost"].cpu().numpy()
        return scores

    return batch_objective


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def particle_sweep_score(out, target, steps):
    """Strict-success score of one robustness sweep
    (`megakernel_particle_sweep_fn` outputs, [steps, n_sc] logs).

    Success is the reference's strict test: the full 4-dim state (position
    and velocity) within `success_dist` of the target, which the kernel
    evaluates per step into the cumulative `done`/`crashed` flags.

    Per scenario (lower is better):
      success:  t_success / steps            in [0, 1)
      no goal:  1 + final_4dim_dist / 36     in [1, ~2)
      crashed:  4 + final_4dim_dist / 36     in [4, ~5)
    so any success beats any failure, earlier success beats later,
    closer failure beats farther, and crashes are worst. Returns
    (mean score, n_success, n_crash, per-scenario success mask)."""
    done = _np(out["done"])
    crashed = _np(out["crashed"])
    last = steps - 1
    crash = crashed[last] > 0.5
    succ = (done[last] > 0.5) & ~crash
    t_succ = done.argmax(axis=0)  # first step the flag latched
    dist = np.sqrt(
        (_np(out["px"][last]) - target[0]) ** 2
        + (_np(out["py"][last]) - target[1]) ** 2
        + (_np(out["vx"][last]) - target[2]) ** 2
        + (_np(out["vy"][last]) - target[3]) ** 2
    )
    per = np.where(crash, 4.0 + dist / 36.0,
                   np.where(succ, t_succ / steps, 1.0 + dist / 36.0))
    return float(per.mean()), int(succ.sum()), int(crash.sum()), succ


def particle_sweep_asha_objective(base_config, true_masses, seed=0,
                                  verbose=False, device="cuda"):
    """Build a `successive_halving` batch objective that scores each trial
    as one n_sc-scenario robustness sweep through the particle sweep
    kernel (K10, `megakernel_particle_sweep_fn`, device-RNG mode; one
    launch per trial).

    Trial keys: `learning_rate` / `alpha` / `ctrl_sigma` / `prior_sigma`
    / any exp_params key set the kernel's scalars; `w_*` keys override
    env cost_params, and `shape` = (n_particles, horizon) changes the
    operand shapes. Budget is episode steps. All trials share one seed
    (common random numbers: rung comparisons are paired)."""
    from .experiments import build_particle_stack
    from .simulation import megakernel_particle_sweep_fn

    device = resolve_device(device)
    true_masses = torch.as_tensor(true_masses, dtype=torch.float32,
                                  device=device)
    n_sc = int(true_masses.shape[0])
    target = np.asarray(base_config["env_params"]["target_state"],
                        np.float64)

    def batch_objective(trials, budget):
        scores = np.full(len(trials), np.inf)
        for i, t in enumerate(trials):
            config = copy.deepcopy(base_config)
            cost = dict(config["env_params"].get("cost_params", {}))
            for k, v in t.items():
                if k.startswith("w_"):
                    cost[k] = float(v)
                elif k == "shape":
                    (config["exp_params"]["n_particles"],
                     config["exp_params"]["horizon"]) = v
                else:
                    config["exp_params"][k] = v
            config["env_params"]["cost_params"] = cost
            exp = config["exp_params"]
            try:
                stack = build_particle_stack(
                    config, torch.Generator(device=device).manual_seed(seed),
                    device=device)
                sweep = megakernel_particle_sweep_fn(
                    stack, exp, steps=int(budget), n_sc=n_sc)
                out = sweep(torch.tensor([seed + 1, 0], device=device),
                            true_masses)
            except ValueError as exc:
                if verbose:
                    print(f"  trial {i} rejected: {exc}", flush=True)
                continue
            score, n_succ, n_crash, _ = particle_sweep_score(
                out, target, int(budget))
            scores[i] = score
            if verbose:
                print(f"  trial {i}: score={score:.4f} "
                      f"success={n_succ}/{n_sc} crash={n_crash} {t}",
                      flush=True)
        return scores

    return batch_objective


def pendulum_tail_score(out, steps, tail=5):
    """Worst-corner tail score of one pendulum robustness sweep
    (`megakernel_pendulum_sweep_fn` outputs, [steps, n_sc] costs).

    Per scenario: tail = mean cost over the last `tail` steps; a scenario
    that never swings up (2nd-half min cost >= 1) scores 10 + its
    2nd-half min, so any all-swing-up config beats any failure. The trial
    score is the max over scenarios (a worst-corner metric: a mean would
    let one bad corner hide behind the good ones). Returns (score,
    n_solved, per-scenario tails)."""
    cost = _np(out["cost"])                          # [steps, n_sc]
    half_min = cost[steps // 2:].min(axis=0)
    tails = cost[-tail:].mean(axis=0)
    solved = half_min < 1.0
    per = np.where(solved, tails, 10.0 + half_min)
    return float(per.max()), int(solved.sum()), tails


def pendulum_sweep_tail_objective(base_config, lens, masses, seed=0,
                                  verbose=False, n_seeds=1, device="cuda"):
    """Build a `successive_halving` batch objective that scores each trial
    as one n_sc-scenario pendulum robustness sweep through the sweep
    kernel (K5, `megakernel_pendulum_sweep_fn`, device-RNG mode),
    minimizing the worst-corner tail cost (`pendulum_tail_score`).

    Trial keys `learning_rate` / `alpha` / `ctrl_sigma` / `prior_sigma` /
    `mpf_learning_rate` set the kernel's scalars; `horizon` /
    `n_particles` / `mpf_steps` change its shapes. All trials share the
    seeds (common random numbers); `n_seeds > 1` averages the score over
    independent sweep seeds (one launch each)."""
    from .experiments import build_pendulum_stack
    from .simulation import megakernel_pendulum_sweep_fn

    device = resolve_device(device)
    lens = torch.as_tensor(lens, dtype=torch.float32, device=device)
    masses = torch.as_tensor(masses, dtype=torch.float32, device=device)
    n_sc = int(lens.shape[0])

    def batch_objective(trials, budget):
        scores = np.full(len(trials), np.inf)
        for i, t in enumerate(trials):
            config = copy.deepcopy(base_config)
            for k, v in t.items():
                config["exp_params"][k] = v
            exp = config["exp_params"]
            try:
                stack = build_pendulum_stack(
                    config, torch.Generator(device=device).manual_seed(seed),
                    case="dust", device=device)
                sweep = megakernel_pendulum_sweep_fn(
                    stack, exp, steps=int(budget), n_sc=n_sc)
                outs = [sweep(torch.tensor([seed + 1, sd * 1000],
                                           device=device), lens, masses)
                        for sd in range(n_seeds)]
            except ValueError as exc:
                if verbose:
                    print(f"  trial {i} rejected: {exc}", flush=True)
                continue
            vals, solved_min = [], n_sc
            for out in outs:
                v, n_solved, _ = pendulum_tail_score(out, int(budget))
                vals.append(v)
                solved_min = min(solved_min, n_solved)
            scores[i] = float(np.mean(vals))
            if verbose:
                print(f"  trial {i}: score={scores[i]:.4f} "
                      f"solved={solved_min}/{n_sc} {t}", flush=True)
        return scores

    return batch_objective
