"""Experiment-stack builders: config -> (model, controller, SVMPC, MPF,
priors) wiring (counterpart of `dust_tpu/experiments.py`: the pendulum
and particle-navigation stacks).

The demo configurations are kept as Python dicts, `PENDULUM_DEMO_CONFIG`
and `PARTICLE_DEMO_CONFIG`, equal to `demo/pendulum_config.yaml` and
`demo/particle_config.yaml`, so the stacks build where no YAML parser is
installed; `load_config` reads a YAML file when one is.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from .controllers import MultiDisco
from .device import resolve_device
from .distributions import GMM, Normal, Uniform
from .inference import (
    ExpectedCost,
    ExponentiatedUtility,
    FusedParticleSVMPC,
    FusedPendulumSVMPC,
    GaussianLikelihood,
    MPF,
    SVMPC,
)
from .models import Particle, PendulumModel
from .ops.particle_rollout import make_fused_particle_state_costs
from .ops.rollout import make_fused_pendulum_state_costs
from .utils.utf import MerweScaledUTF

_LIKELIHOODS = {
    "ExpectedCost": ExpectedCost,
    "ExponentiatedUtility": ExponentiatedUtility,
}

# `demo/pendulum_config.yaml`, key for key
PENDULUM_DEMO_CONFIG = {
    "sim_params": {
        "episodes": 1,
        "render": False,
        "steps": 200,
        "verbose": False,
        "warm_up": 0,
    },
    "exp_params": {
        "init_state": [3.0, 0.0],
        "horizon": 30,
        "n_particles": 3,
        "action_samples": 128,
        "params_samples": 8,
        "alpha": 1,
        "learning_rate": 2.0,
        "bandwidth_scaling": 1.0,
        "ctrl_sigma": 2,
        "ctrl_dim": 1,
        "prior_sigma": 2,
        "weighted_prior": False,
        "params_prior_loc": [[0.5, 0.5], [0.5, 1.5], [1.5, 0.5], [1.5, 1.5]],
        "params_prior_sigma": 0.1,
        "likelihood": "ExponentiatedUtility",
        "kernel": "rbf",
        "mpf_n_particles": 50,
        "mpf_steps": 20,
        "mpf_log_space": False,
        "mpf_learning_rate": 0.001,
        "mpf_bandwidth": None,
        "mpf_bandwidth_scaling": 1.0,
        "mpf_obs_std": 0.1,
    },
    "utf": {"n": 2, "alpha": 0.5},
}

CASES = ("dust", "svmpc", "mppi", "disco_utf")


def load_config(path):
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def pendulum_cost_fns():
    """The DuSt paper's swing-up cost: 50 (cos theta - 1)^2 + theta_dot^2."""

    def inst_cost(states, actions=None, **_):
        theta = states[..., 0]
        theta_d = states[..., 1]
        return 50.0 * (torch.cos(theta) - 1.0) ** 2 + theta_d**2

    def term_cost(states, **_):
        return inst_cost(states)

    return inst_cost, term_cost


def _check_case(config_data, case):
    if case not in CASES:
        raise ValueError(f"unknown case {case!r}; expected one of {CASES}")


def draw_stack_arrays(config_data, generator, case="dust", device="cuda"):
    """Draw the stack's initial arrays from `generator`: the policy prior
    and initial particles, the dynamics prior, the initial MPF particles
    and the initial state."""
    exp = config_data["exp_params"]
    device = resolve_device(device)
    n_pol = exp["n_particles"] if case in ("dust", "svmpc") else 1
    horizon, ctrl_dim = exp["horizon"], exp["ctrl_dim"]

    prior_locs = torch.randn((n_pol, horizon, ctrl_dim), generator=generator,
                             device=device)
    policies_prior = GMM.from_cov(
        prior_locs, torch.ones(n_pol, device=device),
        exp["prior_sigma"] ** 2 * torch.eye(ctrl_dim, device=device),
    )
    arrays = {
        "init_policies": policies_prior.sample(generator, (n_pol,)),
        "policies_prior.locs": policies_prior.locs,
        "policies_prior.scale_tril": policies_prior.scale_tril,
        "policies_prior.logits": policies_prior.logits,
        # Uniform over (length, mass)
        "dynamics_prior.low": torch.tensor([0.6, 0.6], device=device),
        "dynamics_prior.high": torch.tensor([1.3, 1.3], device=device),
        "init_state": torch.tensor(exp["init_state"], dtype=torch.float32,
                                   device=device),
    }
    if case == "dust":
        dyn = Uniform(arrays["dynamics_prior.low"],
                      arrays["dynamics_prior.high"], event_ndims=1)
        mpf_init = dyn.sample(generator, (exp["mpf_n_particles"],))
        if exp["mpf_log_space"]:
            mpf_init = torch.log(torch.clamp(mpf_init, min=1e-6))
        arrays["mpf_init"] = mpf_init
    return arrays


def assemble_stack(config_data, arrays, case="dust", reference_compat=False,
                   device="cuda"):
    """Wire model, controller, SVMPC and MPF around given initial arrays
    (tensors on `device`, keyed as `draw_stack_arrays` returns them)."""
    _check_case(config_data, case)
    exp = config_data["exp_params"]
    device = resolve_device(device)
    horizon = exp["horizon"]
    m = exp["n_particles"]
    alpha = exp["alpha"]
    ctrl_dim = exp["ctrl_dim"]
    use_svmpc = case in ("dust", "svmpc")
    n_pol = m if use_svmpc else 1

    inst_cost, term_cost = pendulum_cost_fns()
    model = PendulumModel(
        uncertain_params=(("length", "mass") if case in ("dust", "disco_utf")
                          else None)
    )

    if case == "disco_utf":
        utf = config_data["utf"]
        params_sampling = MerweScaledUTF(
            n=utf["n"], alpha=utf["alpha"],
            correct_sqrt=utf.get("correct_sqrt", False),
        )
    else:
        params_sampling = True if case == "dust" else "none"

    fused_state_costs = None
    if exp.get("fused_rollout", False) and use_svmpc:
        # fused rollout+cost kernel (ops/rollout.py): identical math,
        # trajectories never materialized; disco_utf's sigma-point
        # weighting needs the cost of each point, and mppi uses
        # params_override, for which the hook has no column
        fused_state_costs = make_fused_pendulum_state_costs(model)

    controller = MultiDisco(
        observation_space=model.observation_space,
        action_space=model.action_space,
        hz_len=horizon,
        n_policies=n_pol,
        action_samples=exp["action_samples"],
        params_samples=exp["params_samples"],
        temperature=1.0 / alpha,
        a_cov=exp["ctrl_sigma"] ** 2 * torch.eye(ctrl_dim),
        inst_cost_fn=inst_cost,
        term_cost_fn=term_cost,
        params_sampling=params_sampling,
        params_log_space=exp["mpf_log_space"] if case == "dust" else False,
        fused_state_costs=fused_state_costs,
        device=device,
    )

    svmpc = None
    if use_svmpc:
        lik_cls = _LIKELIHOODS[exp.get("likelihood", "ExponentiatedUtility")]
        likelihood = lik_cls(alpha=alpha, n_samples=exp["action_samples"],
                             controller=controller, model=model)
        svmpc_kwargs = dict(
            likelihood=likelihood,
            kernel=("message_passing" if exp["kernel"] == "message_passing"
                    else "rbf"),
            ctrl_dim=ctrl_dim,
            n_particles=m,
            n_steps=1,
            lr=exp["learning_rate"],
            bw_scale=exp["bandwidth_scaling"],
            weighted_prior=exp.get("weighted_prior", False),
            reference_compat=reference_compat,
        )
        # fused_solve: the whole solve as one launch (K3, ops/solve.py);
        # demo-config semantics asserted by the class. Its rollouts are
        # K3's own, so the rollout-cost hook (K1) is not launched.
        svmpc_cls = FusedPendulumSVMPC if exp.get("fused_solve", False) \
            else SVMPC
        svmpc = svmpc_cls(**svmpc_kwargs)

    mpf = None
    if case == "dust":
        dynamics_lik = GaussianLikelihood(
            obs_std=exp["mpf_obs_std"],
            model=PendulumModel(uncertain_params=("length", "mass")),
            log_space=exp["mpf_log_space"],
        )
        mpf = MPF(
            likelihood=dynamics_lik,
            lr=exp["mpf_learning_rate"],
            bw_scale=exp["mpf_bandwidth_scaling"],
            n_steps=exp["mpf_steps"],
            reference_compat=reference_compat,
        )

    return SimpleNamespace(
        model=model,
        controller=controller,
        svmpc=svmpc,
        mpf=mpf,
        mpf_init=arrays.get("mpf_init"),
        mpf_bw=exp.get("mpf_bandwidth"),
        mpf_steps=exp.get("mpf_steps"),
        policies_prior=GMM(
            locs=arrays["policies_prior.locs"],
            scale_tril=arrays["policies_prior.scale_tril"],
            logits=arrays["policies_prior.logits"],
        ),
        init_policies=arrays["init_policies"],
        dynamics_prior=Uniform(arrays["dynamics_prior.low"],
                               arrays["dynamics_prior.high"], event_ndims=1),
        init_state=arrays["init_state"],
        device=device,
    )


def build_pendulum_stack(config_data, generator, case="dust",
                         reference_compat=False, device="cuda"):
    """Build one of the pendulum experiment cases:

    * "dust"  — MultiDisco(sampled params) + SVMPC + MPF (dual loop)
    * "svmpc" — MultiDisco(mean params) + SVMPC, no MPF
    * "mppi"  — MultiDisco(n_pol=1, exact model), no SVMPC
    * "disco_utf" — MultiDisco(n_pol=1, UTF sigma points of the dynamics
      prior, from the config's `utf` block), no SVMPC

    `fused_rollout:
    true` selects the rollout-cost kernel (K1), `fused_solve: true` the
    whole-solve kernel (K3, `FusedPendulumSVMPC`).
    `generator` (a `torch.Generator` on `device`) draws the initial
    particles and priors; the stack keeps it as `stack.generator`."""
    _check_case(config_data, case)
    arrays = draw_stack_arrays(config_data, generator, case, device)
    stack = assemble_stack(config_data, arrays, case, reference_compat,
                           device)
    stack.generator = generator
    return stack


# -- particle navigation --------------------------------------------------------

# `demo/particle_config.yaml`, key for key
PARTICLE_DEMO_CONFIG = {
    "sim_params": {"warm_up": 5, "steps": 10, "episodes": 1},
    "exp_params": {
        "horizon": 40,
        "n_particles": 6,
        "action_samples": 64,
        "params_samples": 4,
        "alpha": 1,
        "learning_rate": 100,
        "bandwidth_scaling": 1.0,
        "ctrl_sigma": 5,
        "ctrl_dim": 2,
        "likelihood": "ExponentiatedUtility",
        "sampling": True,
        "kernel": "rbf",
        "use_svmpc": True,
        "use_mpf": True,
        "prior_sigma": 5,
        "weighted_prior": True,
        "dyn_prior": "Normal",
        "dyn_prior_arg1": 2,
        "dyn_prior_arg2": 0.1,
        "extra_load": 1.0,
        "mpf_n_particles": 50,
        "mpf_steps": 20,
        "mpf_log_space": True,
        "mpf_learning_rate": 0.01,
        "mpf_bandwidth": 0.5,
        "mpf_bandwidth_scaling": 1.0,
        "mpf_obs_std": 0.1,
    },
    "env_params": {
        "dt": 0.015,
        "control_type": "acceleration",
        "noise_std": [0.1, 0.1],
        "init_state": [-9.0, -9.0, 0, 0],
        "target_state": [9.0, 9.0, 0, 0],
        "can_crash": True,
        "with_obstacle": True,
        "deterministic": True,
        "cost_params": {
            "w_qpos": 0.5,
            "w_qvel": 0.25,
            "w_ctrl": 0.2,
            "w_obs": 1.0e6,
            "w_qpos_T": 1.0e3,
            "w_qvel_T": 0.1,
        },
        "obst_preset": "grid_4x4",
        "obst_width": 2.1,
        "max_speed": 5,
        "max_accel": 10,
        "map_cell_size": 0.1,
        "map_size": [22, 22],
        "map_type": "direct",
    },
}


def _dynamics_prior(exp, device):
    name = exp["dyn_prior"]
    a1 = torch.tensor(float(exp["dyn_prior_arg1"]), device=device)
    a2 = torch.tensor(float(exp["dyn_prior_arg2"]), device=device)
    if name == "Normal":
        return Normal(a1, a2)
    if name == "Uniform":
        return Uniform(a1, a2)
    raise ValueError(f"Unknown dyn_prior {name}")


def draw_particle_stack_arrays(config_data, generator, device="cuda"):
    """Draw the particle stack's initial arrays from `generator`, in the
    JAX builder's order: the policy prior's locs, the initial particles,
    then (with `use_mpf`) the initial MPF (log-)mass particles."""
    exp = config_data["exp_params"]
    device = resolve_device(device)
    m, horizon, ctrl_dim = exp["n_particles"], exp["horizon"], exp["ctrl_dim"]
    prior_locs = torch.randn((m, horizon, ctrl_dim), generator=generator,
                             device=device)
    policies_prior = GMM.from_cov(
        prior_locs, torch.ones(m, device=device),
        exp["prior_sigma"] ** 2 * torch.eye(ctrl_dim, device=device),
    )
    arrays = {
        "init_policies": policies_prior.sample(generator, (m,)),
        "policies_prior.locs": policies_prior.locs,
        "policies_prior.scale_tril": policies_prior.scale_tril,
        "policies_prior.logits": policies_prior.logits,
        "init_state": torch.tensor(
            config_data["env_params"]["init_state"], dtype=torch.float32,
            device=device),
    }
    if exp["use_mpf"]:
        n = exp["mpf_n_particles"]
        mpf_init = _dynamics_prior(exp, device).sample(
            generator, (n, 1)).reshape(n, 1)
        mpf_init = torch.clamp(mpf_init, min=1e-6)
        if exp["mpf_log_space"]:
            mpf_init = torch.log(mpf_init)
        arrays["mpf_init"] = mpf_init
    return arrays


def assemble_particle_stack(config_data, arrays, reference_compat=False,
                            device="cuda"):
    """Wire model, controller, SVMPC and MPF of the particle task around
    given initial arrays (tensors on `device`, keyed as
    `draw_particle_stack_arrays` returns them)."""
    exp = config_data["exp_params"]
    env = dict(config_data["env_params"])
    device = resolve_device(device)
    alpha, ctrl_dim = exp["alpha"], exp["ctrl_dim"]
    dynamics_prior = _dynamics_prior(exp, device)
    model = Particle(uncertain_params=["mass"],
                     mass=float(dynamics_prior.mean), device=device, **env)

    fused_state_costs = None
    if exp.get("fused_rollout", False):
        # the rollout-cost kernel (K6, ops/particle_rollout.py): identical
        # math, trajectories never materialized; deterministic models only
        fused_state_costs = make_fused_particle_state_costs(model)

    controller = MultiDisco(
        observation_space=model.observation_space,
        action_space=model.action_space,
        hz_len=exp["horizon"],
        n_policies=exp["n_particles"],
        action_samples=exp["action_samples"],
        params_samples=exp["params_samples"],
        temperature=1.0 / alpha,
        a_cov=exp["ctrl_sigma"] ** 2 * torch.eye(ctrl_dim),
        inst_cost_fn=model.default_inst_cost,
        term_cost_fn=model.default_term_cost,
        params_sampling=exp["sampling"],
        params_log_space=exp["mpf_log_space"],
        fused_state_costs=fused_state_costs,
        device=device,
    )

    lik_cls = _LIKELIHOODS[exp["likelihood"]]
    likelihood = lik_cls(alpha=alpha, n_samples=exp["action_samples"],
                         controller=controller, model=model)
    svmpc_kwargs = dict(
        likelihood=likelihood,
        kernel=("message_passing" if exp["kernel"] == "message_passing"
                else "rbf"),
        ctrl_dim=ctrl_dim,
        n_particles=exp["n_particles"],
        n_steps=1,
        lr=exp["learning_rate"],
        bw_scale=exp["bandwidth_scaling"],
        weighted_prior=exp.get("weighted_prior", False),
        reference_compat=reference_compat,
    )
    # fused_solve: the whole solve as one launch (K8, ops/solve.py); its
    # rollouts are K8's own, so the rollout-cost hook (K6) is not launched
    svmpc_cls = FusedParticleSVMPC if exp.get("fused_solve", False) \
        else SVMPC
    svmpc = svmpc_cls(**svmpc_kwargs)

    mpf = None
    if exp["use_mpf"]:
        dynamics_lik = GaussianLikelihood(obs_std=exp["mpf_obs_std"],
                                          model=model,
                                          log_space=exp["mpf_log_space"])
        mpf = MPF(likelihood=dynamics_lik, lr=exp["mpf_learning_rate"],
                  bw_scale=exp["mpf_bandwidth_scaling"],
                  n_steps=exp["mpf_steps"],
                  reference_compat=reference_compat)

    return SimpleNamespace(
        model=model,
        controller=controller,
        svmpc=svmpc,
        mpf=mpf,
        mpf_init=arrays.get("mpf_init"),
        # the MPF prior bandwidth at init: `(2 * arg2) ** 1 / 2`, which
        # operator precedence makes arg2 itself; kept verbatim
        mpf_init_bw=(2 * exp["dyn_prior_arg2"]) ** 1 / 2,
        mpf_bw=exp.get("mpf_bandwidth"),
        mpf_steps=exp.get("mpf_steps"),
        policies_prior=GMM(
            locs=arrays["policies_prior.locs"],
            scale_tril=arrays["policies_prior.scale_tril"],
            logits=arrays["policies_prior.logits"],
        ),
        init_policies=arrays["init_policies"],
        dynamics_prior=dynamics_prior,
        init_state=arrays["init_state"],
        load=exp.get("extra_load", 0.0),
        use_svmpc=exp.get("use_svmpc", True),
        device=device,
    )


def build_particle_stack(config_data, generator, reference_compat=False,
                         device="cuda"):
    """The particle-navigation stack: a `Particle` model on the
    configured obstacle map, MultiDisco with sampled masses, SVMPC and the
    mass MPF. `fused_rollout: true` selects the rollout-cost kernel (K6),
    `fused_solve: true` the whole-solve kernel (K8,
    `FusedParticleSVMPC`). `generator` (a `torch.Generator` on `device`)
    draws the initial particles and priors; the stack keeps it as
    `stack.generator`."""
    arrays = draw_particle_stack_arrays(config_data, generator, device)
    stack = assemble_particle_stack(config_data, arrays, reference_compat,
                                    device)
    stack.generator = generator
    return stack
