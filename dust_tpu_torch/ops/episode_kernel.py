"""The launch path of the whole-episode kernels: K4/K5
(`csrc/pendulum_episode.cu`), K9/K10 (`csrc/particle_episode.cu`), K14
(`csrc/cartpole_episode.cu`) and K15 (`csrc/skid_steer_episode.cu`).

Each kernel is an `EpisodeKernel`, a descriptor of its C entry, kept
beside its task's plain version (`ops/episode.py:PENDULUM`,
`ops/particle_episode.py:K9` / `K10`, `ops/cartpole_episode.py:KERNEL`,
`ops/skid_steer_episode.py:KERNEL`).
`run_episodes` runs B episodes of any of them from canonical inputs: the
plain version on CPU tensors, one launch of the kernel on CUDA tensors. A
sweep keeps the kernel's static operands (`kernel_statics`) across its
calls (`ops/sweep_inputs.py`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from .phase_clock import PhaseClock


@dataclass(frozen=True)
class EpisodeKernel:
    """What `run_episodes` launches: a whole-episode kernel's C entry, its
    plain version on canonical inputs (`plain(inputs, st)`), its log's
    fields, its clock, the inputs its entry takes by pointer before the
    noise, in the entry's order (`ep_i` among them; the others are the
    static inputs `kernel_statics` makes), whether the entry takes host
    noise (eps, pdz, pdu and a `host_noise` flag), and `scalars(st)`, the
    entry's scalars after B. Then:

    * `operands(st, device)`: the static operands made from the statics
      alone, {pointer name: tensor} (the particle's model array), or None;
    * `plan_width`: a plan's values per horizon step (theta, locs and
      a_mat are [B, m, plan_width * hz]);
    * `mpf_width`: the values of one MPF particle;
    * `log_mix`: None where the entry has no final log-mix output, else
      whether the launch writes it (K10) or passes a null pointer (K9);
    * `counts_mpf_loop`: whether each launch is counted by the MPF loop it
      takes (`mpf.episode_register_loop`: the rule of the pendulum's Stein
      loop, which K4/K5, K14 and K15 run, and of the particle's mass loop,
      which K9/K10 run);
    * `rollout_guards`: None, or where the entry counts its rollouts'
      fallbacks (K14, K15: a pointer after the clock),
      `rollout_guards(st, B)`, the guarded steps of a launch of B
      episodes (`GuardCounts`)."""

    entry: str
    plain: Callable
    log_fields: tuple
    clock: PhaseClock
    pointers: tuple
    host_noise: bool
    scalars: Callable
    operands: Optional[Callable] = None
    plan_width: int = 1
    mpf_width: int = 2
    log_mix: Optional[bool] = None
    counts_mpf_loop: bool = True
    rollout_guards: Optional[Callable] = None


class GuardCounts:
    """The guarded steps of a kernel's rollouts over a wrapper's launches
    (K14's chunk-steps, `csrc/cartpole.cuh:rollout_mcost`; K15's
    trajectory steps, `csrc/skid_steer.cuh:step`): `fast`, those that
    took the branch-free forms, and `fallback`, those recomputed with the
    library's sincosf (and K14's division). A launch adds its steps here
    on the host (`EpisodeKernel.rollout_guards`) and the kernel its
    fallbacks to a device count, in its fallback branch alone, so a launch
    waits for nothing; reading `fallback` or `fast` waits for the launches
    before it."""

    def __init__(self):
        self.steps = 0
        self._counts = {}

    def buffer(self, device):
        """The int64 [1] count that launches on `device` add to."""
        if device not in self._counts:
            self._counts[device] = torch.zeros(1, dtype=torch.int64,
                                               device=device)
        return self._counts[device]

    @property
    def fallback(self):
        return sum(int(c.item()) for c in self._counts.values())

    @property
    def fast(self):
        return self.steps - self.fallback


def mpf_scalars(st):
    """The last scalars of an episode kernel's C entry, from the statics:
    exp_util, log_space, fixed_bw, mpf_fixed_bw, mpf_bw_scale."""
    fixed = st["mpf_fixed_bw"]
    return (int(st["exp_util"]), int(st["mpf_log_space"]),
            int(fixed is not None), 0.0 if fixed is None else fixed,
            st["mpf_bw_scale"])


def kernel_statics(inputs, st, kernel):
    """The kernel's operands that do not change with the seeds or the host
    noise, from canonical inputs: its `operands`, each static input
    contiguous and `args`, the scalars of the kernel's C entry from B on.
    A sweep makes them once per argument set (`ops/sweep_inputs.py`)."""
    theta0 = inputs["theta0"]
    out = {} if kernel.operands is None else kernel.operands(st,
                                                             theta0.device)
    for k in kernel.pointers:
        if k not in out and k != "ep_i":
            out[k] = None if inputs[k] is None else inputs[k].contiguous()
    out["args"] = (theta0.shape[0], *kernel.scalars(st))
    return out


def episode_ids(seeds, scenario):
    """The kernel's per-episode integers [B, 3] int32: the two seed words
    and the scenario index."""
    return torch.cat([seeds, scenario[:, None]], dim=1).to(torch.int32)


def launch_args(kernel, inputs, st, stream, fallbacks=None):
    """One launch of `kernel.entry` on inputs in the kernel's form
    (`kernel_statics`' entries, `ep_i` and the host noise or None), on
    their device: (outputs, tensors, args). outputs: log, theta, locs,
    a_mat, mpf_x and, where the entry has one, the log-mix output (None
    where the launch does not write it); tensors: every tensor the launch
    reads or writes, to be kept referenced until it is queued; args: the
    entry's arguments in its order (the pointers, the noise, the outputs,
    the clock, where `kernel.rollout_guards` the fallback count
    `fallbacks` (None: not counted), `inputs["args"]`, the host-noise flag
    where it takes host noise, the stream)."""
    theta0 = inputs["theta0"]
    dev = theta0.device
    B = theta0.shape[0]
    hz, m, m_mpf = st["hz"], st["m"], st["m_mpf"]
    plan = kernel.plan_width * hz
    eps, pdz, pdu = (None if inputs.get(k) is None else inputs[k].contiguous()
                     for k in ("eps", "pdz", "pdu"))
    host_noise = eps is not None
    if host_noise and not kernel.host_noise:
        raise ValueError(f"{kernel.entry} draws its own noise")
    if not host_noise:
        # per-step draws are written here by the kernel and read back
        eps = torch.empty((B, plan * m * st["n_act"]), dtype=torch.float32,
                          device=dev)
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                       device=dev)
    outputs = (empty(B, st["steps"], len(kernel.log_fields)),
               empty(B, m, plan), empty(B, m, plan), empty(B, m, plan),
               empty(B, m_mpf, kernel.mpf_width))
    if kernel.log_mix is not None:
        outputs += (empty(B, m) if kernel.log_mix else None,)
    noise = (eps, pdz, pdu) if kernel.host_noise else (eps,)
    tensors = [*(inputs[k] for k in kernel.pointers), *noise, *outputs,
               kernel.clock.rows(B, dev)]
    if kernel.rollout_guards is not None:
        tensors.append(fallbacks)
    flag = (int(host_noise),) if kernel.host_noise else ()
    args = (*(None if t is None else t.data_ptr() for t in tensors),
            *inputs["args"], *flag, stream)
    return outputs, tensors, args


def run_episodes(wrapper, inputs, st, kernel):
    """Run B episodes from canonical inputs: the plain version on CPU
    tensors, the kernel (`kernel.entry`) on CUDA tensors (one launch,
    counted in `wrapper.launches`). inputs: the task's per-episode and
    shared inputs, seeds [B, 2], scenario [B] and eps/pdz/pdu (host-noise
    mode) or None. On CUDA tensors `inputs` may instead hold the kernel's
    form, as a sweep keeps it: `kernel_statics`' entries and `ep_i`
    (`episode_ids`) in place of seeds and scenario. Where
    `kernel.counts_mpf_loop`, a launch is also counted by the MPF loop it
    takes (`mpf.episode_register_loop`), in `wrapper.mpf_reg_launches` or
    `wrapper.mpf_smem_launches`; where `kernel.rollout_guards`, its
    rollouts' chunk-steps in `wrapper.rollout_guard` (`GuardCounts`).
    Returns the plain version's outputs on CPU tensors, `launch_args`'
    outputs on CUDA tensors."""
    dev = inputs["theta0"].device
    if dev.type == "cpu":
        return kernel.plain(inputs, st)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from ._build import check, load_library
    from .mpf import episode_register_loop

    if "ep_i" not in inputs:
        inputs = dict(inputs, **kernel_statics(inputs, st, kernel),
                      ep_i=episode_ids(inputs["seeds"], inputs["scenario"]))
    # `tensors` stays referenced until the launch is queued: a temporary's
    # memory could be handed to the next allocation
    guard = (None if kernel.rollout_guards is None
             else wrapper.rollout_guard)
    outputs, tensors, args = launch_args(
        kernel, inputs, st, torch.cuda.current_stream(dev).cuda_stream,
        None if guard is None else guard.buffer(dev))
    rc = getattr(load_library(), kernel.entry)(*args)
    wrapper.launches += 1
    if guard is not None:
        guard.steps += kernel.rollout_guards(st, inputs["theta0"].shape[0])
    if kernel.counts_mpf_loop:
        if episode_register_loop(st["m_mpf"]):
            wrapper.mpf_reg_launches += 1
        else:
            wrapper.mpf_smem_launches += 1
    check(rc, kernel.entry)
    return outputs


def split_log(log, fields):
    """log [..., steps, len(fields)] -> {field: [..., steps]}."""
    return {k: log[..., i] for i, k in enumerate(fields)}
