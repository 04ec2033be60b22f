"""What the runners share: the seed's streams, the run's initial arrays,
the widest-gap measure, the timed window and the traced slice, and the
general sweep runner.

A runner is the file `perfbench/runners/<task>_<kind>.py` (the
configuration file's `task`, the traffic file's `kind`), whose `Runner`
class drives the program's entry point as the traffic's parameters say.
Everything a run draws comes from `--seed`: the initial arrays (on the
device, with a `torch.Generator`), the traffic's parameters and the
sample of answers that the check compares with the configuration's plain
reference (`perfbench/reference/`).
"""

from __future__ import annotations

import copy
import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from .trace import profile_slice

# the first steps' numbers read this quantile over the episodes of each
# episode's widest gap: a rounding of the program's can flip one
# episode's selection between two plans at one step, which the widest gap
# over all episodes would read as a fault (PERF.md section 4)
EPISODE_QUANTILE = 0.95


def seed_streams(seed):
    """Three independent streams of `seed`: the initial arrays, the
    traffic, the check's sample."""
    return np.random.SeedSequence(int(seed) & (2 ** 64 - 1)).spawn(3)


def torch_seed(ss):
    return int(ss.generate_state(1, np.uint64)[0])


def _gaps(prog, ref):
    """Each element's |p - r| against the reference's size there plus its
    mean size, |r| + mean |r|; None where either side is not finite, or
    empty."""
    p = torch.as_tensor(prog).to(torch.float64).cpu()
    r = torch.as_tensor(ref).to(torch.float64).cpu()
    if p.shape != r.shape:
        raise ValueError(f"shapes differ: {tuple(p.shape)} and "
                         f"{tuple(r.shape)}")
    if p.numel() == 0 or not (torch.isfinite(p).all()
                              and torch.isfinite(r).all()):
        return None
    return (p - r).abs() / (r.abs() + r.abs().mean() + 1e-30)


def gap(prog, ref):
    """The widest gap of `prog` from `ref` (`_gaps`); infinite where
    `_gaps` finds none."""
    g = _gaps(prog, ref)
    return math.inf if g is None else float(g.max())


def episode_gap(prog, ref):
    """Each episode's (the first axis') widest gap, then their
    `EPISODE_QUANTILE`; infinite where `_gaps` finds none."""
    g = _gaps(prog, ref)
    if g is None:
        return math.inf
    per = g.reshape(g.shape[0], -1).amax(dim=1)
    return float(torch.quantile(per, EPISODE_QUANTILE))


def draw_arrays(config, gen, device):
    """The initial arrays of a run, drawn on the device: the policy
    prior's locations (standard normal), the initial policies (a draw of
    that prior: a random component plus prior_sigma times a normal), the
    initial MPF particles (the configuration's dynamics prior, in log
    space where it says so) and the initial state."""
    exp = config["exp_params"]
    m, hz, a = exp["n_particles"], exp["horizon"], exp["ctrl_dim"]
    locs = torch.randn((m, hz, a), generator=gen, device=device)
    pick = torch.randint(m, (m,), generator=gen, device=device)
    init = locs[pick] + float(exp["prior_sigma"]) * torch.randn(
        (m, hz, a), generator=gen, device=device)
    n = exp["mpf_n_particles"]
    prior = config["dynamics_prior"]
    if prior["kind"] == "uniform":
        lo = torch.tensor(prior["low"], device=device)
        hi = torch.tensor(prior["high"], device=device)
        mpf = lo + (hi - lo) * torch.rand((n, lo.shape[0]), generator=gen,
                                          device=device)
    else:
        mpf = float(exp["dyn_prior_arg1"]) + float(exp["dyn_prior_arg2"]) \
            * torch.randn((n, 1), generator=gen, device=device)
        mpf = torch.clamp(mpf, min=1e-6)
    if exp["mpf_log_space"]:
        mpf = torch.log(torch.clamp(mpf, min=1e-6))
    # the pendulum's initial state is an experiment parameter, the
    # particle's an environment one
    state0 = (config["env_params"]["init_state"] if "env_params" in config
              else exp["init_state"])
    return {"prior_locs": locs, "init_policies": init, "mpf_init": mpf,
            "init_state": torch.tensor(state0, dtype=torch.float32,
                                       device=device)}


def program_arrays(config, arrays):
    """The arrays as the program's stack functions take them."""
    exp = config["exp_params"]
    m, a = exp["n_particles"], exp["ctrl_dim"]
    dev = arrays["prior_locs"].device
    out = {
        "init_policies": arrays["init_policies"],
        "policies_prior.locs": arrays["prior_locs"],
        "policies_prior.scale_tril": float(exp["prior_sigma"])
        * torch.eye(a, device=dev),
        "policies_prior.logits": torch.full((m,), -math.log(m), device=dev),
        "init_state": arrays["init_state"],
        "mpf_init": arrays["mpf_init"],
    }
    prior = config["dynamics_prior"]
    if prior["kind"] == "uniform":
        out["dynamics_prior.low"] = torch.tensor(prior["low"], device=dev)
        out["dynamics_prior.high"] = torch.tensor(prior["high"], device=dev)
    return out


def grid_params(rng, ranges, shape):
    """Each parameter on an even grid over its range, one value per
    scenario, in an order drawn from the seed: every seed sweeps the same
    set of parameters."""
    n = int(np.prod(shape))
    return {k: rng.permutation(np.linspace(lo, hi, n)).reshape(shape)
            for k, (lo, hi) in ranges.items()}


@dataclass
class Work:
    """One unit's work: the algorithm's operations and bytes at the
    cell's shapes, and the solves (episodes x steps) it completed."""

    ops: float
    bytes: float
    solves: float


@dataclass
class Window:
    """What the timed window saw."""

    attempted: int
    failed: int
    seconds: float
    times: list            # seconds of each unit
    ops: float             # the algorithm's operations over the window
    solves: float          # the solves completed over the window


class Runner:
    """Shared by the runners: the timed window and the traced slice. A
    runner gives `unit_call(record)` -> (seconds, outcome on the host),
    `judge(outcome)` -> (sound, Work), `warm_up()`, `plan_samples(...)`
    and `check(control=False)` -> {number: value}."""

    unit = "unit"

    def window(self, seconds):
        """Units back to back for `seconds`; each unit's outcome is judged
        (finite, its work) after the window, not inside it."""
        times, outcomes = [], []
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            dt, outcome = self.unit_call(record=len(times) in self.plan)
            times.append(dt)
            outcomes.append(outcome)
        elapsed = time.perf_counter() - start
        judged = [self.judge(o) for o in outcomes]
        return Window(attempted=len(times),
                      failed=sum(not ok for ok, _ in judged),
                      seconds=elapsed, times=times,
                      ops=sum(w.ops for _, w in judged),
                      solves=sum(w.solves for _, w in judged))

    def traced(self):
        """A traced slice of the same loop: warm-up and active units as the
        traffic's `trace` says. Returns the `Trace` and the `Work` of each
        active unit."""
        tr = self.traffic["trace"]
        outcomes = []

        def one():
            outcomes.append(self.unit_call(record=False)[1])

        trace = profile_slice(one, tr["warmup"], tr["active"],
                              span_name=f"perfbench.{self.unit}")
        return trace, [self.judge(o)[1] for o in outcomes[tr["warmup"]:]]


class Sweep(Runner):
    """`MegakernelGroupSweep.run` over a task's sweep adapter: `groups` x
    `n_chains` x `n_sc` episodes of `episode_steps` steps per call, the
    scenarios' true parameters an even grid over `true_params` in an order
    drawn from the seed, new seeds for every call; a call is timed from
    its start to its outcomes on the host.

    A task's runner gives `adapter(cfg, arrays)` (the program's sweep
    function), `OUTCOME` (the log fields a call brings to the host),
    `work(outcome)`, and for the check `reference_run(seeds, k, dtype)`,
    `first_step_gaps(got, want, measure)`, `physics(logs, inputs)` and
    `chain_gaps(logs, out, control)`."""

    unit = "sweep"
    OUTCOME = ("cost",)

    def __init__(self, cell, seed, device):
        from dust_tpu_torch.parallel import MegakernelGroupSweep

        self.cell, self.device = cell, torch.device(device)
        self.config, self.traffic = cell.config, cell.traffic
        self.ref = cell.reference
        self.cfg = {**self.config["config"],
                    "dynamics_prior": self.config["dynamics_prior"]}
        self.exp = self.cfg["exp_params"]
        s_arr, s_traffic, s_check = seed_streams(seed)
        gen = torch.Generator(device=self.device).manual_seed(
            torch_seed(s_arr))
        self.arrays = draw_arrays(self.cfg, gen, self.device)
        tr = self.traffic
        self.G, self.n_sc, self.C = tr["groups"], tr["n_sc"], tr["n_chains"]
        self.steps = tr["episode_steps"]
        self.B = self.G * self.C * self.n_sc
        self.sweep = MegakernelGroupSweep(self.adapter(
            copy.deepcopy(self.config["config"]),
            program_arrays(self.cfg, self.arrays)))
        self.rng = np.random.default_rng(s_traffic)
        self.check_rng = np.random.default_rng(s_check)
        # the traffic's parameters in their file's order, [G, n_sc] each
        self.params = {k: torch.tensor(v, dtype=torch.float32,
                                       device=self.device)
                       for k, v in grid_params(
                           self.rng, tr["true_params"],
                           (self.G, self.n_sc)).items()}
        # each call's seeds: group g of call i takes (s0 + i, s1 + 1000 g),
        # below 2^31 for every call a run can make
        s0, s1 = (int(v) for v in self.rng.integers(0, 2 ** 30, size=2))
        self.seed_base = np.stack(
            [np.full(self.G, s0), s1 + 1000 * np.arange(self.G)], axis=1)
        self.calls, self.plan, self.kept = 0, set(), None

    def seeds(self, i):
        s = self.seed_base.copy()
        s[:, 0] += i
        return torch.from_numpy(s).to(self.device)

    def episode_major(self, v):
        """A log field [G, (C,) steps, n_sc] -> [B, steps], episode
        b = (g * C + c) * n_sc + s."""
        v = v.reshape(self.G, self.C, self.steps, self.n_sc)
        return v.permute(0, 1, 3, 2).reshape(self.B, self.steps)

    def unit_call(self, record=False):
        i = self.calls
        t0 = time.perf_counter()
        out = self.sweep.run(self.seeds(i), *self.params.values())
        outcome = torch.stack([out[f] for f in self.OUTCOME]).cpu()
        dt = time.perf_counter() - t0
        self.calls += 1
        if record:
            self.kept = (i, out)
        return dt, outcome

    def judge(self, outcome):
        """(the call's outcomes are finite, its work)."""
        return bool(torch.isfinite(outcome).all()), self.work(outcome)

    def warm_up(self):
        """The traffic's warm-up calls. Returns the seconds of the
        quicker of the last two."""
        times = [self.unit_call()[0]
                 for _ in range(self.traffic["warm_up_calls"])]
        self.calls = 0
        return min(times[-2:])

    def plan_samples(self, seconds, unit_s):
        """One call whose answers the check compares, drawn from the seed
        among the first half of the calls the window is expected to
        make."""
        expected = max(1, int(seconds / max(unit_s, 1e-9)))
        self.plan = {int(self.check_rng.integers(max(1, expected // 2)))}

    # -- the check ---------------------------------------------------------

    def first_steps(self, control=False):
        """The kept call's first `check.steps` steps of every episode,
        (got, want, inputs): the program's logs (or, with `control`, the
        bfloat16 reference's) and the reference's, {field: [B, steps]},
        and the reference's episode inputs."""
        i, out = self.kept
        k = self.traffic["check"]["steps"]
        seeds = self.seeds(i)
        want, inputs = self.reference_run(seeds, k, torch.float32)
        if control:
            low, _ = self.reference_run(seeds, k, torch.bfloat16)
            got = {f: v.to(torch.float32) for f, v in low.items()}
        else:
            got = {f: self.episode_major(out[f])[:, :k]
                   for f in self.ref.LOG_FIELDS}
        return got, want, inputs

    def check(self, control=False):
        """The kept call's episodes against the reference: their first
        `check.steps` steps against the reference's own episodes (each
        number the `EPISODE_QUANTILE` of the episodes' widest gaps; the
        widest over all episodes kept in `self.widest`); every logged
        step's simulator, cost and termination re-done from the step
        before it (the program's 200 steps; the control's first steps);
        the MPF alone over all the program's logged steps (with
        `control`, in bfloat16)."""
        got, want, inputs = self.first_steps(control)
        worst = self.first_step_gaps(got, want, episode_gap)
        self.widest = self.first_step_gaps(got, want, gap)
        _, out = self.kept
        logs = {f: self.episode_major(out[f]) for f in self.ref.LOG_FIELDS}
        worst.update(self.physics(got if control else logs, inputs))
        worst.update(self.chain_gaps(logs, out, control))
        return worst
