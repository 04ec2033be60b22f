"""The system's entry points on the port (counterparts of `demo/*.py`):

    python -m dust_tpu_torch.demo.pendulum_example   the paper's four cases
    python -m dust_tpu_torch.demo.particle_example   particle navigation
    python -m dust_tpu_torch.demo.sweep_example      sweep kernels (K5, K10)
    python -m dust_tpu_torch.demo.pendulum_tuning    pendulum searches
    python -m dust_tpu_torch.demo.particle_tuning    particle searches

Each takes the options of its JAX script and `--device` (default `cuda`,
which raises where there is no card; `cpu` runs every kernel's plain
version). Each has a `main(argv=None)` whose body calls a function that
takes the config dict, so a caller can run a demo in-process with a
config of its own. The configs are the dicts of
`dust_tpu_torch.experiments` (`--config <yaml>` reads a file with PyYAML).
Randomness comes from `torch.Generator`s seeded from `--seed`, where JAX
splits keys: the draws equal JAX's in distribution only.

A demo imports `torch`, `numpy` and `dust_tpu_torch` only; matplotlib
(`--render`) and PyYAML (`--config`, `--save`) are imported where they
are used.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..experiments import build_particle_stack, load_config
from ..simulation import run_particle_episode


def seeded_generators(seed, n, device):
    """n `torch.Generator`s on `device`, seeded from one numpy
    `SeedSequence` of `seed` (the place of JAX's key splits)."""
    seeds = np.random.SeedSequence(seed).generate_state(n)
    return [torch.Generator(device=device).manual_seed(int(s))
            for s in seeds]


def choose_config(path, tuned, demo_config, tuned_config):
    """The YAML file at `path` when given, else a copy of the tuned or the
    demo config dict."""
    if path is not None:
        return load_config(path)
    return copy.deepcopy(tuned_config if tuned else demo_config)


def run_particle(config, g_build, g_run, steps, device):
    """One particle episode of `config` for `steps` steps: the stack built
    from `g_build`, the episode run from `g_run`. Returns (stack,
    `run_particle_episode`'s dict)."""
    stack = build_particle_stack(config, g_build, device=device)
    svstate = (
        stack.svmpc.init_state(stack.init_policies, stack.policies_prior)
        if stack.use_svmpc else None
    )
    mstate = (
        stack.mpf.init_state(
            stack.mpf_init, stack.init_state, stack.controller.dim_a,
            bw=stack.mpf_init_bw,
        )
        if stack.mpf is not None else None
    )
    result = run_particle_episode(
        g_run,
        model=stack.model,
        controller=stack.controller,
        svmpc=stack.svmpc,
        svstate=svstate,
        mpf=stack.mpf,
        mstate=mstate,
        dyn_dist=stack.dynamics_prior,
        init_state=stack.init_state,
        load=stack.load,
        steps=steps,
        warm_up=config["sim_params"]["warm_up"],
        mpf_bw=stack.mpf_bw,
        mpf_steps=stack.mpf_steps,
        use_svmpc=stack.use_svmpc,
    )
    return stack, result


def add_device_argument(parser):
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs every "
                        "kernel's plain version)")
