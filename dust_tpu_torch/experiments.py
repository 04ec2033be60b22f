"""Experiment-stack builders: config -> (model, controller, SVMPC, MPF,
priors) wiring (counterpart of `dust_tpu/experiments.py`: the pendulum
and particle-navigation stacks).

The demo configurations are kept as Python dicts, `PENDULUM_DEMO_CONFIG`
and `PARTICLE_DEMO_CONFIG`, equal to `demo/pendulum_config.yaml` and
`demo/particle_config.yaml`, and the tuned ones, `PENDULUM_TUNED_CONFIG`
and `PARTICLE_TUNED_CONFIG`, equal to `demo/*_config_tuned.yaml`, so the
stacks build where no YAML parser is installed; `load_config` reads a YAML
file where PyYAML is. `CARTPOLE_DEMO_CONFIG` is the cart-pole swing-up
under DuSt (the port's own: upstream ships the model with no demo), which
`assemble_stack` wires by its `task` key; `SKID_STEER_DEMO_CONFIG` the
skid-steer robot's navigation under DuSt (the port's own too), which
`assemble_particle_stack` wires by its `task` key.
"""

from __future__ import annotations

import copy
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
from .models import (
    CartPoleModel,
    Particle,
    PendulumModel,
    SkidSteerNavigation,
)
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

# `demo/pendulum_config_tuned.yaml`, key for key: the demo config with the
# learning rate, alpha, ctrl_sigma and prior_sigma of the worst-corner tail
# search (`python -m dust_tpu_torch.demo.pendulum_tuning --tail`)
PENDULUM_TUNED_CONFIG = copy.deepcopy(PENDULUM_DEMO_CONFIG)
PENDULUM_TUNED_CONFIG["exp_params"].update(
    alpha=1.3677, learning_rate=1.1857, ctrl_sigma=1.2633,
    prior_sigma=2.1853)

CASES = ("dust", "svmpc", "mppi", "disco_utf")

# The cart-pole swing-up under DuSt: `models.CartPoleModel`'s defaults
# (upstream dust/models/cartpole.py, total mass m_c + m_p), the DuSt widths
# of `demo/pendulum_config.yaml` key for key (its 30 steps at the same dt
# are the same 1.5 s look-ahead), hanging at th = pi with the cart centred
# (upright is th = 0), the swing-up cost of `cartpole_cost_fns`, a
# Uniform prior over (length, mass_pole) and the pole's mass doubled at
# half the episode (a tip load). The sigmas are 1: the action bound is 1
# where the pendulum's torque bound is 2. The MPF runs in log space, as
# the particle demo's: the cart-pole has no speed clamp, so a draw near
# length 0 (which the linear-space posterior's shared bandwidth reaches)
# drives its rollouts to NaN. `assemble_stack` reads `task`,
# `model_params` and `dynamics_prior`.
CARTPOLE_DEMO_CONFIG = {
    "task": "cartpole",
    "sim_params": copy.deepcopy(PENDULUM_DEMO_CONFIG["sim_params"]),
    "model_params": {
        "g": 9.8,
        "f_mag": 10.0,
        "mass_cart": 1.0,
        "mass_pole": 0.1,
        "length": 1.0,
        "mu_c": 0.0005,
        "mu_p": 2e-06,
        "dt": 0.05,
    },
    "exp_params": {
        **copy.deepcopy(PENDULUM_DEMO_CONFIG["exp_params"]),
        "init_state": [0.0, 0.0, 3.141592653589793, 0.0],
        "ctrl_dim": 1,
        "ctrl_sigma": 1.0,
        "prior_sigma": 1.0,
        "mpf_log_space": True,
        "load_step": 100,
        "load_mass_pole_scale": 2.0,
    },
    "dynamics_prior": {"kind": "uniform", "low": [0.5, 0.05],
                       "high": [1.5, 0.3]},
}

TASKS = ("pendulum", "cartpole", "skid_steer")
# the tasks of `assemble_stack` (`assemble_particle_stack` builds the
# skid-steer's, `_NAV_MODELS`)
_PENDULUM_TASKS = ("pendulum", "cartpole")


def load_config(path):
    """The config dict of a YAML file (needs PyYAML)."""
    try:
        import yaml
    except ImportError as exc:
        raise ImportError(
            "load_config reads YAML with PyYAML (the 'yaml' module), which "
            "is not installed; pass one of the config dicts of "
            "dust_tpu_torch.experiments instead") from exc

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


def cartpole_cost_fns():
    """The cart-pole swing-up cost (`CARTPOLE_DEMO_CONFIG`): 50 (cos th -
    1)^2 + th_dot^2 + x^2 + 0.1 x_dot^2, plus 1e3 at every state off the
    track (|x| > 2.4, the model's x_threshold); the terminal cost has the
    same form."""
    from .ops.cartpole_episode import state_cost

    def inst_cost(states, actions=None, **_):
        return state_cost(states[..., 0], states[..., 1],
                          torch.cos(states[..., 2]), states[..., 3])

    def term_cost(states, **_):
        return inst_cost(states)

    return inst_cost, term_cost


def _task(config_data):
    task = config_data.get("task", "pendulum")
    if task not in TASKS:
        raise ValueError(f"unknown task {task!r}; expected one of {TASKS}")
    return task


def _check_case(config_data, case):
    if _task(config_data) not in _PENDULUM_TASKS:
        raise ValueError(f"the {_task(config_data)} task builds with "
                         "build_particle_stack")
    if case not in CASES:
        raise ValueError(f"unknown case {case!r}; expected one of {CASES}")
    if _task(config_data) == "cartpole" and case != "dust":
        raise ValueError(f"the cart-pole runs the dust case only, got "
                         f"{case!r}")


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
    # Uniform over the uncertain parameters: the configuration's prior, the
    # pendulum demo's (0.6, 1.3) over (length, mass) where it has none
    prior = config_data.get("dynamics_prior",
                            {"low": [0.6, 0.6], "high": [1.3, 1.3]})
    arrays = {
        "init_policies": policies_prior.sample(generator, (n_pol,)),
        "policies_prior.locs": policies_prior.locs,
        "policies_prior.scale_tril": policies_prior.scale_tril,
        "policies_prior.logits": policies_prior.logits,
        "dynamics_prior.low": torch.tensor(prior["low"], device=device),
        "dynamics_prior.high": torch.tensor(prior["high"], device=device),
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
    (tensors on `device`, keyed as `draw_stack_arrays` returns them). The
    configuration's `task` picks the model, its uncertain parameters and
    the cost: "pendulum" (the default; `PendulumModel` over (length,
    mass), `pendulum_cost_fns`) or "cartpole" (`CartPoleModel` with the
    configuration's `model_params`, over (length, mass_pole),
    `cartpole_cost_fns`; the dust case only)."""
    _check_case(config_data, case)
    exp = config_data["exp_params"]
    device = resolve_device(device)
    horizon = exp["horizon"]
    m = exp["n_particles"]
    alpha = exp["alpha"]
    ctrl_dim = exp["ctrl_dim"]
    use_svmpc = case in ("dust", "svmpc")
    n_pol = m if use_svmpc else 1
    cartpole = _task(config_data) == "cartpole"

    if cartpole:
        if exp.get("fused_rollout", False) or exp.get("fused_solve", False):
            raise ValueError("fused_rollout and fused_solve are the "
                             "pendulum's kernels; the cart-pole's is the "
                             "sweep (simulation.megakernel_cartpole_sweep_fn)")
        inst_cost, term_cost = cartpole_cost_fns()

        def make_model(uncertain):
            return CartPoleModel(uncertain_params=uncertain, device=device,
                                 **config_data["model_params"])

        uncertain = ("length", "mass_pole")
    else:
        inst_cost, term_cost = pendulum_cost_fns()

        def make_model(uncertain):
            return PendulumModel(uncertain_params=uncertain)

        uncertain = ("length", "mass")
    model = make_model(uncertain if case in ("dust", "disco_utf") else None)

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
            model=make_model(uncertain),
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


# `demo/particle_config_tuned.yaml`, key for key: the strict-success
# config of the particle sweep search
# (`python -m dust_tpu_torch.demo.particle_tuning --sweep --refine`)
PARTICLE_TUNED_CONFIG = copy.deepcopy(PARTICLE_DEMO_CONFIG)
PARTICLE_TUNED_CONFIG["sim_params"]["steps"] = 600
PARTICLE_TUNED_CONFIG["exp_params"].update(
    alpha=0.30768551424290735, learning_rate=292.22941649531174,
    ctrl_sigma=9.67779876626442, prior_sigma=9.645154087438598)
PARTICLE_TUNED_CONFIG["env_params"]["cost_params"]["w_qvel_T"] = 800.0


# The skid-steer robot (upstream dust/models/skid_steer_robot.py's
# defaults: x_icr 0.2 m, wheel radius 0.0625 m, axial distance 0.475 m,
# wheel speeds in [-0.5, 0.5] rev/s) crossing an obstacle course under the
# particle demo's DuSt widths, key for key. The port's own (upstream ships
# no skid-steer demo): the course is upstream's grid_3x3 preset read at a
# fifth of its size (`map_scale`: a 4.4 m map of 0.02 m cells, 0.42 m
# squares 1 m apart, three of them on the diagonal), from (-1.8, -1.8)
# heading pi/4 to (1.8, 1.8) at rest; dt 0.3 s; the sigmas the particle
# demo's times the ratio of the action bounds (0.5 / 10), the learning
# rate times its square (a Stein step's score goes as 1 / sigma^2), and
# the policy prior's locations and initial policies, drawn as the
# particle's, times the ratio too (`init_policy_scale`); the tuned
# particle config's w_qvel_T 800, which makes a robot stop at the target;
# a Uniform prior over the three parameters (`dynamics_prior`), in log
# space under a fixed MPF bandwidth of 0.05, which is also the first; the
# true x_icr times `extra_load` from a quarter of the episode on (a load
# behind the axle). The cost is the particle's over (x, y) and (v, omega)
# (`models.SkidSteerNavigation`), a collision ends the episode, reaching
# within `success_dist` of the target in those four coordinates ends it
# as a success.
SKID_STEER_DEMO_CONFIG = {
    "task": "skid_steer",
    "sim_params": {"warm_up": 0, "steps": 200, "episodes": 1},
    "model_params": {
        "x_icr": 0.2,
        "wheel_radius": 0.0625,
        "axial_distance": 0.475,
        "min_wheel_speed": -0.5,
        "max_wheel_speed": 0.5,
    },
    "exp_params": {
        **{k: v for k, v in copy.deepcopy(
            PARTICLE_DEMO_CONFIG["exp_params"]).items()
           if k not in ("dyn_prior", "dyn_prior_arg1", "dyn_prior_arg2")},
        "learning_rate": 0.25,
        "ctrl_sigma": 0.25,
        "prior_sigma": 0.25,
        "init_policy_scale": 0.05,
        "mpf_bandwidth": 0.05,
        "mpf_init_bandwidth": 0.05,
        "extra_load": 2.0,
    },
    "env_params": {
        "dt": 0.3,
        "init_state": [-1.8, -1.8, 0.7853981633974483, 0.0, 0.0],
        "target_state": [1.8, 1.8, 0.0, 0.0],
        "success_dist": 0.2,
        "can_crash": True,
        "with_obstacle": True,
        "cost_params": {
            **copy.deepcopy(
                PARTICLE_DEMO_CONFIG["env_params"]["cost_params"]),
            "w_qvel_T": 800.0,
        },
        "obst_preset": "grid_3x3",
        **{k: copy.deepcopy(PARTICLE_DEMO_CONFIG["env_params"][k])
           for k in ("obst_width", "map_size", "map_cell_size",
                     "map_type")},
        "map_scale": 0.2,
    },
    "dynamics_prior": {"kind": "uniform", "low": [0.05, 0.05, 0.38],
                       "high": [0.6, 0.075, 0.57]},
}
# the skid-steer's uncertain parameters, in the MPF particles' order
SKID_STEER_PARAMS = ("x_icr", "wheel_radius", "axial_distance")


def _particle_model(config_data, env, prior, device):
    return Particle(uncertain_params=["mass"], mass=float(prior.mean),
                    device=device, **env)


def _skid_steer_model(config_data, env, prior, device):
    return SkidSteerNavigation(
        delta_t=env.pop("dt"), uncertain_params=SKID_STEER_PARAMS,
        device=device, **config_data["model_params"], **env)


# the navigation tasks of `assemble_particle_stack`: the model each builds
# from (config_data, env_params, dynamics prior, device)
_NAV_MODELS = {"particle": _particle_model, "skid_steer": _skid_steer_model}


def _nav_model(config_data):
    task = config_data.get("task", "particle")
    if task not in _NAV_MODELS:
        raise ValueError(f"the {task!r} task builds with build_pendulum_stack"
                         if task in TASKS else
                         f"unknown task {task!r}; expected one of "
                         f"{tuple(_NAV_MODELS)}")
    return _NAV_MODELS[task]


def _dynamics_prior(exp, device, arrays=None):
    """The MPF's prior: a Uniform box over several parameters where the
    arrays hold its bounds (`dynamics_prior.low` / `.high`), else
    `exp_params`' dyn_prior over one."""
    if arrays is not None and "dynamics_prior.low" in arrays:
        return Uniform(arrays["dynamics_prior.low"],
                       arrays["dynamics_prior.high"], event_ndims=1)
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
    then (with `use_mpf`) the initial MPF (log-)parameter particles [n, d].
    With `init_policy_scale` the locs and the initial particles are those
    draws times it; a configuration's `dynamics_prior` box goes into the
    arrays as its bounds (`dynamics_prior.low` / `.high`)."""
    exp = config_data["exp_params"]
    device = resolve_device(device)
    _nav_model(config_data)
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
    if "init_policy_scale" in exp:
        for k in ("init_policies", "policies_prior.locs"):
            arrays[k] = arrays[k] * float(exp["init_policy_scale"])
    box = config_data.get("dynamics_prior")
    if box is not None:
        for k in ("low", "high"):
            arrays[f"dynamics_prior.{k}"] = torch.tensor(box[k],
                                                         device=device)
    if exp["use_mpf"]:
        n = exp["mpf_n_particles"]
        mpf_init = _dynamics_prior(exp, device, arrays).sample(
            generator, (n,)).reshape(n, -1)
        mpf_init = torch.clamp(mpf_init, min=1e-6)
        if exp["mpf_log_space"]:
            mpf_init = torch.log(mpf_init)
        arrays["mpf_init"] = mpf_init
    return arrays


def assemble_particle_stack(config_data, arrays, reference_compat=False,
                            device="cuda"):
    """Wire model, controller, SVMPC and MPF of the particle task around
    given initial arrays (tensors on `device`, keyed as
    `draw_particle_stack_arrays` returns them). The configuration's `task`
    picks the model (`_NAV_MODELS`): "particle" (the default; a `Particle`
    over its mass) or "skid_steer" (`SkidSteerNavigation` with the
    configuration's `model_params` over `SKID_STEER_PARAMS`); the arrays'
    `dynamics_prior` box, where they hold one, is the MPF's prior. The
    cost, the load's effect (`extra_load`) and the goal's coordinates are
    the model's own."""
    exp = config_data["exp_params"]
    env = dict(config_data["env_params"])
    device = resolve_device(device)
    alpha, ctrl_dim = exp["alpha"], exp["ctrl_dim"]
    dynamics_prior = _dynamics_prior(exp, device, arrays)
    success_dist = float(env.pop("success_dist", 1.0))
    model = _nav_model(config_data)(config_data, env, dynamics_prior, device)
    if ((exp.get("fused_rollout", False) or exp.get("fused_solve", False))
            and not isinstance(model, Particle)):
        raise ValueError("fused_rollout and fused_solve are the particle's "
                         "kernels")

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
        # the MPF prior bandwidth at init: `mpf_init_bandwidth` where the
        # configuration gives it, else the particle's `(2 * arg2) ** 1 / 2`,
        # which operator precedence makes arg2 itself; kept verbatim
        mpf_init_bw=(exp["mpf_init_bandwidth"]
                     if "mpf_init_bandwidth" in exp
                     else (2 * exp["dyn_prior_arg2"]) ** 1 / 2),
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
        # the load from a quarter of the episode on, as the model reads it
        # (`loaded_params`)
        load=exp.get("extra_load", model.no_load),
        use_svmpc=exp.get("use_svmpc", True),
        # the goal test's distance (the particle sweeps' default 1.0)
        success_dist=success_dist,
        device=device,
    )


def build_particle_stack(config_data, generator, reference_compat=False,
                         device="cuda"):
    """The particle-navigation stack: a `Particle` model on the
    configured obstacle map, MultiDisco with sampled masses, SVMPC and the
    mass MPF; with `task: "skid_steer"` the skid-steer robot on the course
    (`SKID_STEER_DEMO_CONFIG`), its three parameters sampled and inferred.
    `fused_rollout: true` selects the rollout-cost kernel (K6),
    `fused_solve: true` the whole-solve kernel (K8,
    `FusedParticleSVMPC`). `generator` (a `torch.Generator` on `device`)
    draws the initial particles and priors; the stack keeps it as
    `stack.generator`."""
    arrays = draw_particle_stack_arrays(config_data, generator, device)
    stack = assemble_particle_stack(config_data, arrays, reference_compat,
                                    device)
    stack.generator = generator
    return stack
