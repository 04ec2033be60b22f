"""State carried across from numpy arrays.

The DuSt stack has no network weights: its "parameters" are the initial
particles and priors of a stack, plus the solver states. These functions
build the port's stack and states from numpy arrays (for example a JAX
stack's arrays taken through `np.asarray`), so the port can start from,
or be re-synced to, exactly the same values.
"""

from __future__ import annotations

import numpy as np
import torch

from .controllers import AMPPIState, DiscoState
from .device import resolve_device
from .distributions import GMM
from .experiments import assemble_particle_stack, assemble_stack
from .inference import LikelihoodState, MPFState, SVMPCState

STACK_ARRAY_KEYS = (
    "init_policies",
    "policies_prior.locs", "policies_prior.scale_tril",
    "policies_prior.logits",
    "mpf_init",
    "dynamics_prior.low", "dynamics_prior.high",
    "init_state",
)


def _tensor(array, device):
    return torch.tensor(np.asarray(array, dtype=np.float32), device=device)


def _gmm(locs, scale_tril, logits, device):
    return GMM(locs=_tensor(locs, device),
               scale_tril=_tensor(scale_tril, device),
               logits=_tensor(logits, device))


def stack_arrays_from_numpy(arrays, config, device="cuda", case="dust",
                            reference_compat=False):
    """Build the port's stack of any pendulum case ("dust", "svmpc",
    "mppi", "disco_utf") from numpy arrays keyed by `STACK_ARRAY_KEYS`
    (`mpf_init` only for case "dust") instead of drawing them; the
    disco_utf case's sigma points come from the config's `utf` block."""
    device = resolve_device(device)
    keys = [k for k in STACK_ARRAY_KEYS if k != "mpf_init" or case == "dust"]
    missing = [k for k in keys if k not in arrays]
    if missing:
        raise KeyError(f"missing stack arrays: {missing}")
    tensors = {k: _tensor(arrays[k], device) for k in keys}
    return assemble_stack(config, tensors, case, reference_compat, device)


def svmpc_state_from_numpy(theta, prior_locs, prior_scale_tril,
                           prior_logits, prior_updated=False, device="cuda"):
    device = resolve_device(device)
    return SVMPCState(
        theta=_tensor(theta, device),
        prior=_gmm(prior_locs, prior_scale_tril, prior_logits, device),
        prior_updated=bool(np.asarray(prior_updated)),
    )


def mpf_state_from_numpy(x, prior_locs, prior_scale_tril, prior_logits, loc,
                         past_obs, past_action, prior_bw, device="cuda"):
    device = resolve_device(device)
    return MPFState(
        x=_tensor(x, device),
        prior=_gmm(prior_locs, prior_scale_tril, prior_logits, device),
        lik=LikelihoodState(loc=_tensor(loc, device),
                            past_obs=_tensor(past_obs, device),
                            past_action=_tensor(past_action, device)),
        prior_bw=_tensor(prior_bw, device).reshape(()),
    )


def disco_state_from_numpy(a_seq, a_mat, a_mix, device="cuda"):
    device = resolve_device(device)
    return DiscoState(a_seq=_tensor(a_seq, device),
                      a_mat=_tensor(a_mat, device),
                      a_mix=_tensor(a_mix, device))


def amppi_state_from_numpy(a_seq, device="cuda"):
    return AMPPIState(a_seq=_tensor(a_seq, resolve_device(device)))


PARTICLE_STACK_ARRAY_KEYS = (
    "init_policies",
    "policies_prior.locs", "policies_prior.scale_tril",
    "policies_prior.logits",
    "mpf_init",
    "init_state",
)


def particle_stack_from_numpy(arrays, config, device="cuda",
                              reference_compat=False):
    """Build the port's particle stack from numpy arrays keyed by
    `PARTICLE_STACK_ARRAY_KEYS` (`mpf_init` only with `use_mpf`) instead
    of drawing them; the dynamics prior comes from the config's scalars.
    The controller's a_mat / a_seq carry across with
    `disco_state_from_numpy`."""
    device = resolve_device(device)
    keys = [k for k in PARTICLE_STACK_ARRAY_KEYS
            if k != "mpf_init" or config["exp_params"]["use_mpf"]]
    missing = [k for k in keys if k not in arrays]
    if missing:
        raise KeyError(f"missing stack arrays: {missing}")
    tensors = {k: _tensor(arrays[k], device) for k in keys}
    return assemble_particle_stack(config, tensors, reference_compat, device)
