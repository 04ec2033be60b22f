"""Closed-loop MPC episode harnesses (counterpart of
`dust_tpu/simulation.py`): `PendulumSimulation`, the particle-navigation
`particle_episode_fn` / `run_particle_episode`, the whole-episode and
sweep kernel adapters of both tasks, and the cart-pole's sweep adapter
(`megakernel_cartpole_sweep_fn`, K14).

One MPC step: SVMPC optimize -> (after warm-up) forward and select ->
simulator step -> MPF optimize, logged per step. The simulator is the
dynamics model itself with the episode's true parameters (gym
`Pendulum-v0` dynamics == `PendulumModel.step` with g=10). Where the JAX
harness scans and branches on device, this one is a Python loop over
steps with `if t >= warm_up`; the logs stay on the device until the
episode ends.

When MPF is active, rollout parameters are drawn from the *current* MPF
prior each step.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models.pendulum import PendulumModel
from .utils.profiling import span

COLUMNS = (
    "Cost", "Position", "Speed", "Actions", "Timestep", "Iteration",
    "DynParticles", "DynBandwidths", "PolParticles", "Weights",
    "ExpParams", "AvgCumCost",
)


class PendulumSimulation:
    """Multi-episode pendulum harness."""

    def __init__(self, controller, svmpc=None, mpf=None, model=None,
                 sim_g=10.0, sim_dt=0.05, steps=200, warm_up=1,
                 use_svmpc=True, disco_strategy="average", mpf_bw=None,
                 mpf_steps=None, use_exact_model=False, device="cuda"):
        self.device = resolve_device(device)
        self.controller = controller
        self.svmpc = svmpc
        self.mpf = mpf
        self.model = model  # internal rollout model
        self.sim_model = PendulumModel(g=sim_g, dt=sim_dt)
        self.steps = int(steps)
        self.warm_up = int(warm_up)
        self.use_svmpc = bool(use_svmpc)
        self.disco_strategy = disco_strategy
        self.mpf_bw = mpf_bw          # None -> per-step Silverman
        self.mpf_steps = mpf_steps    # None -> mpf.n_steps
        # exact-model baselines: the controller rolls out under the
        # episode's true parameters
        self.use_exact_model = bool(use_exact_model)

    def step_fn(self, static_dyn_dist):
        """The per-step function
        (carry, t, true_params) -> (carry, log), with carry =
        (generator, obs [1, S], dstate, svstate, mstate) and log =
        (obs, action, cost, theta, weights, dyn_particles, bw). Its
        phases run in the spans `svmpc.optimize`, `svmpc.forward`,
        `simulator.step` and `mpf.optimize`."""
        ctrl, svmpc, mpf = self.controller, self.svmpc, self.mpf
        dev = self.device

        def step(carry, t, true_params):
            generator, obs, dstate, svstate, mstate = carry
            dyn_dist = mstate.prior if mpf is not None else static_dyn_dist

            if self.use_svmpc:
                with span("svmpc.optimize"):
                    svstate, dstate, costs = svmpc.optimize(
                        svstate, dstate, obs, dyn_dist, generator
                    )
                if t >= self.warm_up:
                    with span("svmpc.forward"):
                        svstate, a_seq, weights = svmpc.forward(
                            svstate, costs, generator=generator
                        )
                    action = a_seq[0]
                else:
                    action = torch.zeros((ctrl.dim_a,), device=dev)
                    weights = torch.full((svmpc.n_particles,), float("nan"),
                                         device=dev)
            else:
                override = (
                    {k: v for k, v in true_params.items()
                     if k in self.model.params_dict}
                    if self.use_exact_model else None
                )
                dstate, _, _, _, _, _ = ctrl.forward(
                    dstate, obs, self.model, dyn_dist, generator,
                    params_override=override,
                )
                dstate, next_actions = ctrl.step(
                    dstate, strategy=self.disco_strategy
                )
                action = next_actions.reshape(-1)
                weights = dstate.a_mix

            with span("simulator.step"):
                obs = self.sim_model.step(obs, action[None], true_params)

            if mpf is not None:
                with span("mpf.optimize"):
                    mstate, _, bw = mpf.optimize(
                        mstate, action, obs[0], bw=self.mpf_bw,
                        n_steps=self.mpf_steps,
                    )
            else:
                bw = 0.0

            cost = ctrl.inst_cost_fn(obs)[0]
            theta_log = (
                svstate.theta if self.use_svmpc
                else torch.zeros((ctrl.n_pol, ctrl.hz_len, ctrl.dim_a),
                                 device=dev)
            )
            dyn_log = mstate.x if mpf is not None else torch.zeros(
                (1, 1), device=dev)
            bw = torch.as_tensor(bw, dtype=torch.float32, device=dev)
            log = (obs[0], action, cost, theta_log, weights, dyn_log, bw)
            return (generator, obs, dstate, svstate, mstate), log

        return step

    def episode_fn(self, static_dyn_dist):
        """(generator, true_params, init_obs, dstate, svstate, mstate) ->
        (carry, logs), logs stacked over steps on the device."""
        step = self.step_fn(static_dyn_dist)

        def episode(generator, true_params, init_obs, dstate, svstate,
                    mstate):
            carry = (generator, init_obs, dstate, svstate, mstate)
            logs = []
            for t in range(self.steps):
                carry, log = step(carry, t, true_params)
                logs.append(log)
            return carry, tuple(torch.stack(col) for col in zip(*logs))

        return episode

    def run(self, generator, experiment_params, init_state, init_policies,
            policies_prior=None, dyn_dist=None, mpf_init=None,
            episodes=None, verbose=False):
        """Run one episode per entry of `experiment_params` (list of dicts
        of true simulator parameters). Returns the reference-schema columns
        (`COLUMNS`) as numpy arrays over all episodes' steps; see
        `to_dataframe`."""
        episodes = len(experiment_params) if episodes is None else episodes
        episode = self.episode_fn(dyn_dist)
        init_obs = torch.as_tensor(init_state, dtype=torch.float32,
                                   device=self.device).reshape(1, -1)
        parts = []
        for i in range(episodes):
            true = experiment_params[i]
            true_params = {
                k: torch.tensor(v, dtype=torch.float32, device=self.device)
                for k, v in true.items()
            }
            dstate = self.controller.init_state(init_policies)
            svstate = (
                self.svmpc.init_state(init_policies, policies_prior)
                if self.use_svmpc else ()
            )
            mstate = (
                self.mpf.init_state(mpf_init, init_obs[0],
                                    self.controller.dim_a)
                if self.mpf is not None else ()
            )
            _, logs = episode(generator, true_params, init_obs, dstate,
                              svstate, mstate)
            states, actions, costs, thetas, weights, dyn_parts, bws = (
                col.detach().cpu().numpy() for col in logs
            )
            if verbose:
                print(f"episode {i}: params={true} "
                      f"final avg cost={costs[-20:].mean():.3f}")
            timestep = np.arange(self.steps)
            parts.append({
                "Cost": costs,
                "Position": states[:, 0],
                "Speed": states[:, 1],
                "Actions": actions[:, 0],
                "Timestep": timestep,
                "Iteration": np.full(self.steps, i),
                "DynParticles": dyn_parts if self.mpf is not None else None,
                "DynBandwidths": bws,
                "PolParticles": thetas[..., 0, 0],
                "Weights": weights,
                "ExpParams": np.tile(
                    np.asarray(list(true.values()), dtype=np.float64),
                    (self.steps, 1),
                ),
                "AvgCumCost": np.round(np.cumsum(costs) / (timestep + 1), 2),
            })
        return {
            name: (None if parts[0][name] is None
                   else np.concatenate([p[name] for p in parts]))
            for name in COLUMNS
        }


def to_dataframe(columns):
    """The columns `PendulumSimulation.run` returns as a pandas DataFrame
    in the reference schema (index = timestep; array-valued cells as
    per-row lists)."""
    import pandas as pd

    n = len(columns["Cost"])
    data = {}
    for name in COLUMNS:
        col = columns[name]
        if col is None:
            data[name] = None
        elif name == "DynParticles":
            data[name] = list(col)
        elif col.ndim > 1:
            data[name] = col.tolist()
        else:
            data[name] = col
    return pd.DataFrame(index=list(columns["Timestep"][:n]), data=data)


def _exp_util(exp):
    return exp.get("likelihood", "ExponentiatedUtility") \
        == "ExponentiatedUtility"


def megakernel_pendulum_episode_fn(stack, exp_params, steps, warm_up=0,
                                   unroll=True):
    """Whole-episode kernel adapter (K4, `ops/episode.py`): the whole
    closed loop — every SVMPC solve, simulator step and MPF update — runs
    as one launch with the kernel's own counter-based noise. Returns
    episode(seed [2] int, true_length=1.0, true_mass=1.0) -> logs dict.
    The noise stream differs from the plain and fused paths' generator
    (equal in distribution); use it for throughput, not for step-by-step
    equivalence. `unroll` changes no value."""
    from .ops.episode import fused_pendulum_episode

    exp = exp_params
    mstate = stack.mpf.init_state(stack.mpf_init, stack.init_state, 1)
    dstate = stack.controller.init_state(stack.init_policies)
    theta0 = stack.init_policies[..., 0]
    locs0 = stack.policies_prior.locs[..., 0]
    amat0 = dstate.a_mat[..., 0]
    aseq0 = dstate.a_seq[..., 0]
    g_model = float(stack.model.params_dict["g"])

    def episode(seed, true_length=1.0, true_mass=1.0):
        return fused_pendulum_episode(
            seed, stack.init_state, theta0, locs0, amat0, aseq0,
            stack.mpf_init, mstate.prior_bw, true_length, true_mass,
            exp["ctrl_sigma"], exp["learning_rate"], exp["alpha"],
            1.0 / exp["alpha"], exp["prior_sigma"],
            exp["mpf_learning_rate"], exp["mpf_obs_std"],
            steps=steps, warm_up=warm_up, hz=exp["horizon"],
            m=exp["n_particles"], n_params=exp["params_samples"],
            n_act=exp["action_samples"], m_mpf=exp["mpf_n_particles"],
            mpf_steps=exp["mpf_steps"], g_model=g_model, g_sim=10.0,
            exp_util=_exp_util(exp), mpf_log_space=exp["mpf_log_space"],
            mpf_fixed_bw=exp.get("mpf_bandwidth"),
            mpf_bw_scale=exp["mpf_bandwidth_scaling"], unroll=unroll,
        )

    return episode


def megakernel_pendulum_sweep_fn(stack, exp_params, steps, n_sc,
                                 warm_up=0, unroll=True, svmpc_only=False,
                                 n_chains=1):
    """Scenario-sweep kernel adapter (K5, `ops/sweep_episode.py`): n_sc
    <= 16 independent pendulum DuSt episodes (per-scenario true
    parameters, bandwidths and MPF posteriors) times `n_chains` chains in
    one launch. Returns sweep(seed [2] int, true_lengths [n_sc],
    true_masses [n_sc], host_eps=None, host_pdz=None, host_pdu=None) ->
    per-scenario logs; `sweep.groups(seeds [G, 2], true_lengths,
    true_masses, ...)` runs G groups in one launch (the
    `parallel.MegakernelGroupSweep` path); `sweep.phase_clock` is the
    kernel's clock (`ops.episode.phase_clock`); `sweep.wrapper` is
    `ops.sweep_episode.fused_pendulum_sweep_episode`, whose `launches`,
    `input_hits` and `input_builds` count the calls. The calls pass the
    same stack tensors and numbers each time, so a repeat call with the
    same true-parameter tensors reuses the kernel's inputs.

    Rejected, as the kernel does not model them: a nonzero controller
    a_seq (the kernel drops the a_seq term), `weighted_prior`, and
    non-uniform initial prior mixture weights.

    svmpc_only=True degenerates the dual loop into the SV-MPC case (model
    default parameters, no dynamics inference) with no kernel change: one
    MPF particle at the default (length, mass), zero prior bandwidth and
    zero MPF steps make every dynamics draw exactly the default
    parameters and freeze the posterior."""
    from .ops.episode import phase_clock as episode_clock
    from .ops.sweep_episode import (
        fused_pendulum_sweep_episode,
        fused_pendulum_sweep_groups,
    )

    exp = exp_params
    theta0, locs0, amat0 = _sweep_priors(stack, exp)
    g_model = float(stack.model.params_dict["g"])
    dev = theta0.device
    if svmpc_only:
        mpf_init = torch.tensor([[
            float(stack.model.params_dict["length"]),
            float(stack.model.params_dict["mass"]),
        ]], device=dev)
        # a fixed zero MPF bandwidth keeps the prior bandwidth exactly
        # zero every step (the Silverman floor would re-inject noise)
        mpf_cfg = dict(m_mpf=1, mpf_steps=0, mpf_log_space=False,
                       mpf_fixed_bw=0.0)
        prior_bw0 = 0.0
        n_params = 1
    else:
        mstate = stack.mpf.init_state(stack.mpf_init, stack.init_state, 1)
        mpf_init = stack.mpf_init
        mpf_cfg = dict(m_mpf=exp["mpf_n_particles"],
                       mpf_steps=exp["mpf_steps"],
                       mpf_log_space=exp["mpf_log_space"],
                       mpf_fixed_bw=exp.get("mpf_bandwidth"))
        prior_bw0 = mstate.prior_bw
        n_params = exp["params_samples"]

    def groups(seeds, true_lengths, true_masses, host_eps=None,
               host_pdz=None, host_pdu=None):
        return fused_pendulum_sweep_groups(
            seeds, stack.init_state, theta0, locs0, amat0, mpf_init,
            prior_bw0, true_lengths, true_masses, exp["ctrl_sigma"],
            exp["learning_rate"], exp["alpha"], 1.0 / exp["alpha"],
            exp["prior_sigma"], exp["mpf_learning_rate"],
            exp["mpf_obs_std"], n_sc=n_sc, steps=steps, warm_up=warm_up,
            hz=exp["horizon"], m=exp["n_particles"], n_params=n_params,
            n_act=exp["action_samples"], g_model=g_model, g_sim=10.0,
            exp_util=_exp_util(exp),
            mpf_bw_scale=exp["mpf_bandwidth_scaling"], unroll=unroll,
            n_chains=n_chains, host_eps=host_eps, host_pdz=host_pdz,
            host_pdu=host_pdu, **mpf_cfg,
        )

    return _sweep_adapter(groups, episode_clock, fused_pendulum_sweep_episode)


def _sweep_adapter(groups, clock, wrapper):
    """A sweep adapter's one-group `sweep`: `groups` with a leading group
    axis of one added to every argument (None stays None) and taken off
    every output; `sweep.groups`, `sweep.phase_clock` (the kernel's clock)
    and `sweep.wrapper` (the wrapper whose counters count its calls)."""
    def sweep(*args, **kwargs):
        lead = lambda v: None if v is None else torch.as_tensor(v)[None]
        out = groups(*map(lead, args),
                     **{k: lead(v) for k, v in kwargs.items()})
        return {k: v[0] for k, v in out.items()}

    sweep.groups = groups
    sweep.phase_clock = clock
    sweep.wrapper = wrapper
    return sweep


def _zero_a_seq(dstate, name):
    """Raise unless the controller's a_seq is zero, as the sweep kernels
    assume; `name` begins the message."""
    if bool(torch.any(dstate.a_seq != 0)):
        raise ValueError(f"{name} requires a zero controller a_seq "
                         "(SVMPC demo semantics)")


def _sweep_priors(stack, exp):
    """The controller's zero a_seq and uniform prior, which the sweep
    kernels assume, checked; returns (theta0, locs0, amat0)."""
    dstate = stack.controller.init_state(stack.init_policies)
    _zero_a_seq(dstate, "sweep megakernel")
    if exp.get("weighted_prior", False):
        raise ValueError("sweep megakernel supports the unweighted "
                         "policy prior only (pendulum demo semantics)")
    lg = stack.policies_prior.logits.detach().cpu().to(torch.float64)
    if (torch.log_softmax(lg, dim=0) + np.log(exp["n_particles"])).abs() \
            .max() > 1e-5:
        raise ValueError("sweep megakernel requires uniform initial "
                         "prior mixture weights")
    return (stack.init_policies[..., 0], stack.policies_prior.locs[..., 0],
            dstate.a_mat[..., 0])


def megakernel_cartpole_sweep_fn(stack, exp_params, steps, n_sc, n_chains=1):
    """Scenario-sweep kernel adapter (K14, `ops/cartpole_sweep_episode.py`)
    of a cart-pole stack (`experiments.assemble_stack` with `task:
    "cartpole"`): n_sc <= 16 independent DuSt swing-up episodes
    (per-scenario true length and pole mass, bandwidths and MPF
    posteriors) times `n_chains` chains in one launch, the pole mass times
    `load_mass_pole_scale` from step `load_step` on (the configuration's
    `exp_params`; none without them). Returns sweep(seed [2] int,
    true_lengths [n_sc], true_mass_poles [n_sc]) -> per-scenario logs
    x / x_dot / th / th_dot / action / cost / bw_sv / bw_mpf [steps, n_sc]
    (a leading chain axis when n_chains > 1), final theta / locs / a_mat
    and mpf_x [n_sc, m_mpf, 2]; `sweep.groups(seeds [G, 2], true_lengths,
    true_mass_poles)` runs G groups in one launch (the
    `parallel.MegakernelGroupSweep` path); `sweep.phase_clock` is the
    kernel's clock (`ops.cartpole_episode.phase_clock`); `sweep.wrapper`
    is `ops.cartpole_sweep_episode.fused_cartpole_sweep_groups`, whose
    `launches`, `input_hits` and `input_builds` count the calls.

    Rejected, as the kernel does not model them: a nonzero controller
    a_seq, `weighted_prior`, non-uniform initial prior mixture weights."""
    from .ops.cartpole_episode import phase_clock as cartpole_clock
    from .ops.cartpole_sweep_episode import fused_cartpole_sweep_groups

    exp = exp_params
    theta0, locs0, amat0 = _sweep_priors(stack, exp)
    model = stack.model
    mstate = stack.mpf.init_state(stack.mpf_init, stack.init_state, 1)
    statics = dict(
        n_sc=n_sc, n_chains=n_chains, steps=steps, hz=exp["horizon"],
        m=exp["n_particles"],
        n_params=exp["params_samples"], n_act=exp["action_samples"],
        m_mpf=exp["mpf_n_particles"], mpf_steps=exp["mpf_steps"],
        dt=model.dt,
        **{k: float(model.params_dict[k])
           for k in ("g", "mass_cart", "mu_c", "mu_p", "f_mag")},
        load_step=int(exp.get("load_step", steps)),
        load_scale=float(exp.get("load_mass_pole_scale", 1.0)),
        exp_util=_exp_util(exp), mpf_log_space=exp["mpf_log_space"],
        mpf_fixed_bw=exp.get("mpf_bandwidth"),
        mpf_bw_scale=exp["mpf_bandwidth_scaling"])

    def groups(seeds, true_lengths, true_mass_poles):
        return fused_cartpole_sweep_groups(
            seeds, stack.init_state, theta0, locs0, amat0, stack.mpf_init,
            mstate.prior_bw, true_lengths, true_mass_poles,
            exp["ctrl_sigma"], exp["learning_rate"], exp["alpha"],
            1.0 / exp["alpha"], exp["prior_sigma"], exp["mpf_learning_rate"],
            exp["mpf_obs_std"], **statics)

    return _sweep_adapter(groups, cartpole_clock, fused_cartpole_sweep_groups)


def megakernel_skid_steer_sweep_fn(stack, exp_params, steps, n_sc,
                                   warm_up=0, n_chains=1):
    """Scenario-sweep kernel adapter (K15, `ops/skid_steer_sweep_episode.py`)
    of a skid-steer stack (`experiments.assemble_particle_stack` with
    `task: "skid_steer"`): n_sc <= 16 independent navigation DuSt episodes
    (per-scenario true x_icr, wheel radius and axial distance, crash and
    goal termination, weighted priors and MPF posteriors) times `n_chains`
    chains in one launch, x_icr times the stack's `load`
    (`extra_load`) from steps // 4 on. Returns sweep(seed [2] int,
    true_x_icr [n_sc], true_wheel_radius [n_sc], true_axial_distance
    [n_sc]) -> per-scenario logs x / y / theta / v / omega / a_r / a_l /
    cost / done / crashed / bw_sv / bw_mpf [steps, n_sc] (a leading chain
    axis when n_chains > 1), final theta / locs / a_mat [n_sc, m, hz, 2]
    and mpf_x [n_sc, m_mpf, 3]; `sweep.groups(seeds [G, 2], true_x_icr,
    true_wheel_radius, true_axial_distance)` runs G groups in one launch
    (the `parallel.MegakernelGroupSweep` path); `sweep.phase_clock` is the
    kernel's clock (`ops.skid_steer_episode.phase_clock`); `sweep.wrapper`
    is `ops.skid_steer_sweep_episode.fused_skid_steer_sweep_groups`, whose
    `launches`, `input_hits` and `input_builds` count the calls.

    Rejected, as the kernel does not model it: a nonzero controller
    a_seq."""
    from .ops.skid_steer_episode import phase_clock as skid_clock
    from .ops.skid_steer_episode import skid_steer_kernel_statics
    from .ops.skid_steer_sweep_episode import fused_skid_steer_sweep_groups

    exp = exp_params
    statics = skid_steer_kernel_statics(stack.model)
    mstate = stack.mpf.init_state(stack.mpf_init, stack.init_state, 2,
                                  bw=stack.mpf_init_bw)
    dstate = stack.controller.init_state()
    _zero_a_seq(dstate, "skid-steer sweep megakernel")
    log_mix0 = torch.log_softmax(stack.policies_prior.logits, dim=0)
    kwargs = dict(
        n_sc=n_sc, n_chains=n_chains, steps=steps, warm_up=warm_up,
        hz=exp["horizon"], m=exp["n_particles"],
        n_params=exp["params_samples"], n_act=exp["action_samples"],
        m_mpf=exp["mpf_n_particles"], mpf_steps=exp["mpf_steps"],
        load_step=steps // 4, load_scale=float(stack.load),
        success_dist=stack.success_dist, exp_util=_exp_util(exp),
        weighted_prior=exp.get("weighted_prior", False),
        mpf_log_space=exp["mpf_log_space"], mpf_fixed_bw=stack.mpf_bw,
        mpf_bw_scale=exp["mpf_bandwidth_scaling"], **statics)

    def groups(seeds, true_x_icr, true_wheel_radius, true_axial_distance):
        return fused_skid_steer_sweep_groups(
            seeds, stack.init_state, stack.init_policies,
            stack.policies_prior.locs, log_mix0, dstate.a_mat,
            stack.mpf_init, mstate.prior_bw, true_x_icr, true_wheel_radius,
            true_axial_distance, exp["ctrl_sigma"], exp["learning_rate"],
            exp["alpha"], 1.0 / exp["alpha"], exp["prior_sigma"],
            exp["mpf_learning_rate"], exp["mpf_obs_std"], **kwargs)

    return _sweep_adapter(groups, skid_clock, fused_skid_steer_sweep_groups)


# -- particle navigation --------------------------------------------------------


def particle_episode_fn(model, controller, svmpc=None, mpf=None,
                        dyn_dist=None, load=0.0, steps=400, warm_up=30,
                        mpf_bw=None, mpf_steps=None, use_svmpc=True,
                        success_dist=1.0):
    """The particle-navigation episode (counterpart of
    `dust_tpu/simulation.py:particle_episode_fn`): the model doubles as
    the simulator, the simulator mass gains `load` at steps // 4, a
    collision terminates the episode as a crash, reaching within
    `success_dist` of the target (full 4-dim distance) terminates it as a
    success. All `steps` run; the state freezes once done. The model owns
    the load and the goal: `model.loaded_params(sim_mass, load)` gives the
    simulator's parameters before steps // 4 and from then on, and the
    distance to the target is taken over `model.goal_coords` (the skid-steer
    stack, `SKID_STEER_DEMO_CONFIG`, runs the same loop: its `sim_mass` is
    the dict of its true parameters, its goal (x, y, v, omega)).

    Returns episode(generator, state0, dstate, svstate, mstate, sim_mass)
    -> (final_state, done, crashed, cum_cost, logs), logs = (states,
    actions, costs, dyn_particles, dones) stacked over steps on the
    device. Per step, as JAX sequences it: SVMPC optimize; forward only at
    t >= warm_up (else the zero action); the simulator with the mass of
    step t; the state frozen once done; the MPF update when t >= warm_up
    and not done; the cost of the new state added to the sum unless done;
    then crash and success detection against the pre-detection done. The
    done flag is read on the host every step (it gates the MPF). The
    phases run in the spans `svmpc.optimize`, `svmpc.forward`,
    `simulator.step` and `mpf.optimize`."""
    ctrl = controller
    dev = ctrl.device
    target = model.target
    change_at = steps // 4
    has_map = model.with_obstacle and model.obst_map is not None

    def episode(generator, state0, dstate, svstate, mstate, sim_mass):
        unloaded, loaded = model.loaded_params(sim_mass, load)
        state = torch.as_tensor(state0, dtype=torch.float32, device=dev)
        done = crashed = False
        cum = torch.zeros((), device=dev)
        logs = []
        for t in range(steps):
            dyn_dist_t = mstate.prior if mpf is not None else dyn_dist
            if use_svmpc:
                with span("svmpc.optimize"):
                    svstate, dstate, costs = svmpc.optimize(
                        svstate, dstate, state[None], dyn_dist_t, generator)
                if t >= warm_up:
                    with span("svmpc.forward"):
                        svstate, a_seq, _ = svmpc.forward(
                            svstate, costs, generator=generator)
                    action = a_seq[0]
                else:
                    action = torch.zeros((ctrl.dim_a,), device=dev)
            else:
                dstate, _, _, _, _, _ = ctrl.forward(
                    dstate, state[None], model, dyn_dist_t, generator)
                dstate, next_actions = ctrl.step(dstate, strategy="argmax")
                action = next_actions.reshape(-1)

            if not done:
                with span("simulator.step"):
                    state = model.step(
                        state[None], action[None],
                        loaded if t >= change_at else unloaded)[0]
                if mpf is not None and t >= warm_up:
                    with span("mpf.optimize"):
                        mstate, _, _ = mpf.optimize(
                            mstate, action, state, bw=mpf_bw,
                            n_steps=mpf_steps)

            cost = ctrl.inst_cost_fn(state[None])[0]
            if not done:
                cum = cum + cost
            crash_now = (model.obst_map.get_collisions(state[:2]) > 0) \
                if has_map else torch.zeros((), dtype=torch.bool, device=dev)
            success_now = (torch.linalg.norm(target
                                             - model.goal_coords(state))
                           <= success_dist)
            # the one host read of the step
            crash_now, success_now = (bool(v) for v in torch.stack(
                [crash_now, success_now]).cpu())
            crashed = crashed or (crash_now and not done)
            done = done or crash_now or success_now

            dyn_log = mstate.x if mpf is not None else torch.zeros(
                (1, 1), device=dev)
            logs.append((state, action, cost, dyn_log, done))
        states, actions, costs, dyn_parts = (
            torch.stack([log[i] for log in logs]) for i in range(4))
        dones = torch.tensor([log[4] for log in logs], device=dev)
        return state, done, crashed, cum, (states, actions, costs,
                                           dyn_parts, dones)

    return episode


def run_particle_episode(generator, model, controller, svmpc=None,
                         svstate=None, mpf=None, mstate=None, dyn_dist=None,
                         init_state=None, load=0.0, steps=400, warm_up=30,
                         mpf_bw=None, mpf_steps=None, use_svmpc=True,
                         success_dist=1.0):
    """Run one particle episode end to end; returns a dict of outcome
    scalars and logged arrays (numpy): the trajectory cut at termination,
    cum_cost = inf on a crash."""
    episode = particle_episode_fn(
        model, controller, svmpc=svmpc, mpf=mpf, dyn_dist=dyn_dist,
        load=load, steps=steps, warm_up=warm_up, mpf_bw=mpf_bw,
        mpf_steps=mpf_steps, use_svmpc=use_svmpc, success_dist=success_dist,
    )
    state0 = init_state if init_state is not None else model.init_state
    dstate = controller.init_state()
    state, done, crashed, cum, logs = episode(
        generator, state0, dstate, svstate if use_svmpc else (),
        mstate if mpf is not None else (), model.params_dict["mass"])
    states, actions, costs, dyn_parts, dones = (
        v.detach().cpu().numpy() for v in logs)
    n_steps = int(dones.argmax() + 1) if bool(dones.any()) else int(steps)
    return {
        "cum_cost": float(np.inf) if crashed else float(cum),
        "crashed": bool(crashed),
        "success": bool(done) and not bool(crashed),
        "steps": n_steps,
        "trajectory": states[:n_steps],
        "actions": actions[:n_steps],
        "costs": costs[:n_steps],
        "dyn_particles": dyn_parts[:n_steps],
        "final_state": state.detach().cpu().numpy(),
    }


def megakernel_particle_episode_fn(stack, exp_params, steps, warm_up=0,
                                   success_dist=1.0):
    """Whole-episode kernel adapter of the particle task (K9,
    `ops/particle_episode.py`): the whole obstacle-navigation episode —
    SVMPC solves, the simulator with the mass change at steps // 4,
    crash/goal termination, gated MPF mass-posterior updates — runs as one
    launch with the kernel's own counter-based noise. Returns
    episode(seed [2] int, base_mass=None) -> logs dict. Requires the
    demo config's fixed MPF bandwidth (`mpf_bandwidth` set)."""
    from .ops.particle_episode import fused_particle_episode
    from .ops.particle_rollout import particle_kernel_statics

    exp = exp_params
    if stack.mpf_bw is None:
        raise ValueError("particle megakernel expects a fixed "
                         "mpf_bandwidth (the demo config sets 0.5)")
    statics = particle_kernel_statics(stack.model)
    mstate = stack.mpf.init_state(stack.mpf_init, stack.init_state, 2,
                                  bw=stack.mpf_init_bw)
    dstate = stack.controller.init_state()
    log_mix0 = torch.log_softmax(stack.policies_prior.logits, dim=0)
    model = stack.model

    def episode(seed, base_mass=None):
        return fused_particle_episode(
            seed, stack.init_state, stack.init_policies,
            stack.policies_prior.locs, log_mix0, dstate.a_mat, dstate.a_seq,
            stack.mpf_init, mstate.prior_bw,
            model.params_dict["mass"] if base_mass is None else base_mass,
            stack.load, exp["ctrl_sigma"], exp["learning_rate"],
            exp["alpha"], 1.0 / exp["alpha"], exp["prior_sigma"],
            exp["mpf_learning_rate"], exp["mpf_obs_std"], stack.mpf_bw,
            steps=steps, warm_up=warm_up, hz=exp["horizon"],
            m=exp["n_particles"], n_params=exp["params_samples"],
            n_act=exp["action_samples"], m_mpf=exp["mpf_n_particles"],
            mpf_steps=exp["mpf_steps"], dt=float(model.dt),
            max_acc=float(model.max_acc), max_speed=float(model.max_speed),
            change_at=steps // 4, success_dist=success_dist,
            exp_util=_exp_util(exp),
            weighted_prior=exp.get("weighted_prior", False),
            mpf_log_space=exp["mpf_log_space"], use_fixed_mpf_bw=True,
            mpf_bw_scale=exp["mpf_bandwidth_scaling"], **statics,
        )

    return episode


def megakernel_particle_sweep_fn(stack, exp_params, steps, n_sc, warm_up=0,
                                 success_dist=1.0, probe_skip=(),
                                 n_chains=1):
    """Scenario-sweep kernel adapter of the particle task (K10,
    `ops/particle_sweep_episode.py`): n_sc <= 16 independent
    obstacle-navigation DuSt episodes (per-scenario seeds, true simulator
    masses, crash/goal termination, weighted priors and MPF mass
    posteriors) times `n_chains` chains in one launch. Returns
    sweep(seed [2] int, true_masses [n_sc], host_eps=None, host_pdz=None,
    host_pdu=None) -> per-scenario logs; `sweep.groups(seeds [G, 2],
    true_masses, ...)` runs G groups in one launch (the
    `parallel.MegakernelGroupSweep` path); `sweep.phase_clock` is the
    kernel's clock (`ops.particle_episode.phase_clock`); `sweep.wrapper`
    is `ops.particle_sweep_episode.fused_particle_sweep_episode`, whose
    `launches`, `input_hits` and `input_builds` count the calls. The calls
    pass the same stack tensors and numbers each time, so a repeat call
    with the same true-mass tensor reuses the kernel's inputs.

    Rejected, as the kernel does not model them: a nonzero controller
    a_seq, and an MPF bandwidth that is not fixed (the demo config sets
    `mpf_bandwidth` 0.5)."""
    from .ops.particle_episode import phase_clock as episode_clock
    from .ops.particle_rollout import particle_kernel_statics
    from .ops.particle_sweep_episode import (
        fused_particle_sweep_episode,
        fused_particle_sweep_groups,
    )

    exp = exp_params
    if stack.mpf_bw is None:
        raise ValueError("particle sweep megakernel expects a fixed "
                         "mpf_bandwidth (the demo config sets 0.5)")
    statics = particle_kernel_statics(stack.model)
    mstate = stack.mpf.init_state(stack.mpf_init, stack.init_state, 2,
                                  bw=stack.mpf_init_bw)
    dstate = stack.controller.init_state()
    _zero_a_seq(dstate, "particle sweep megakernel")
    log_mix0 = torch.log_softmax(stack.policies_prior.logits, dim=0)
    model = stack.model

    def groups(seeds, true_masses, host_eps=None, host_pdz=None,
               host_pdu=None):
        return fused_particle_sweep_groups(
            seeds, stack.init_state, stack.init_policies,
            stack.policies_prior.locs, log_mix0, dstate.a_mat,
            stack.mpf_init, mstate.prior_bw, true_masses, stack.load,
            exp["ctrl_sigma"], exp["learning_rate"], exp["alpha"],
            1.0 / exp["alpha"], exp["prior_sigma"],
            exp["mpf_learning_rate"], exp["mpf_obs_std"], stack.mpf_bw,
            n_sc=n_sc, steps=steps, warm_up=warm_up, hz=exp["horizon"],
            m=exp["n_particles"], n_params=exp["params_samples"],
            n_act=exp["action_samples"], m_mpf=exp["mpf_n_particles"],
            mpf_steps=exp["mpf_steps"], dt=float(model.dt),
            max_acc=float(model.max_acc), max_speed=float(model.max_speed),
            change_at=steps // 4, success_dist=success_dist,
            exp_util=_exp_util(exp),
            weighted_prior=exp.get("weighted_prior", False),
            mpf_log_space=exp["mpf_log_space"], use_fixed_mpf_bw=True,
            mpf_bw_scale=exp["mpf_bandwidth_scaling"], host_eps=host_eps,
            host_pdz=host_pdz, host_pdu=host_pdu, probe_skip=probe_skip,
            n_chains=n_chains, **statics,
        )

    return _sweep_adapter(groups, episode_clock, fused_particle_sweep_episode)
