"""`utils.profiling.span` and the port's spans, on the CPU at a tiny size.

The sweep call (`MegakernelGroupSweep.run` over both tasks' sweep
adapters: `sweep.run` around `sweep.inputs`, `sweep.launch`,
`sweep.outputs` and, with a mesh, `sweep.gather`) and the MPC step
(`PendulumSimulation.step_fn` and the loop of `particle_episode_fn`:
`svmpc.optimize`, `svmpc.forward`, `simulator.step`, `mpf.optimize`, and
inside the generic MPF's `mpf.condition`, `mpf.stein_steps`,
`mpf.prior_refresh`): no span is entered while no profiler records, the
names nest as documented under a CPU profiler, and the outputs are
bit-equal with the profiler on and off. `PhaseClock.summary` against the
arithmetic `chip_smoke._phase_clock` had inline, and that function's
printed line; `profile_main_path.profile` reports the step's spans."""

import copy
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from dust_tpu_torch.experiments import (
    PARTICLE_DEMO_CONFIG,
    PENDULUM_DEMO_CONFIG,
    build_particle_stack,
    build_pendulum_stack,
)
from dust_tpu_torch.ops import episode, particle_episode
from dust_tpu_torch.ops.phase_clock import PhaseClock
from dust_tpu_torch.parallel import MegakernelGroupSweep
from dust_tpu_torch.parallel import sweep as sweep_module
from dust_tpu_torch.simulation import (
    PendulumSimulation,
    megakernel_particle_sweep_fn,
    megakernel_pendulum_sweep_fn,
    particle_episode_fn,
)
from dust_tpu_torch.utils import profiling

TINY = dict(horizon=6, n_particles=2, action_samples=8, params_samples=2,
            mpf_n_particles=8, mpf_steps=3)
STEP = ("svmpc.optimize", "svmpc.forward", "simulator.step", "mpf.optimize")
MPF = ("mpf.condition", "mpf.stein_steps", "mpf.prior_refresh")
SWEEP = ("sweep.inputs", "sweep.launch", "sweep.outputs")
CASES = ["pendulum.sweep", "particle.sweep", "pendulum.step",
         "particle.step"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(base):
    cfg = copy.deepcopy(base)
    cfg["exp_params"].update(TINY)
    return cfg


def _pendulum_sweep(mesh=None):
    cfg = _config(PENDULUM_DEMO_CONFIG)
    stack = build_pendulum_stack(
        cfg, torch.Generator().manual_seed(1), device="cpu")
    sweep = MegakernelGroupSweep(megakernel_pendulum_sweep_fn(
        stack, cfg["exp_params"], steps=4, n_sc=2, n_chains=2), mesh=mesh)
    seeds = torch.tensor([[3, 5], [7, 11]])
    lens = torch.tensor([[0.9, 1.1], [1.0, 1.2]])
    mass = torch.tensor([[1.0, 0.95], [1.05, 1.1]])

    def run():
        return sweep.run(seeds, lens, mass)

    run.sweep = sweep
    return run


def _particle_sweep():
    cfg = _config(PARTICLE_DEMO_CONFIG)
    stack = build_particle_stack(
        cfg, torch.Generator().manual_seed(2), device="cpu")
    sweep = MegakernelGroupSweep(megakernel_particle_sweep_fn(
        stack, cfg["exp_params"], steps=4, n_sc=2, n_chains=2))
    seeds = torch.tensor([[3, 5], [7, 11]])
    mass = torch.tensor([[1.8, 2.0], [2.1, 2.3]])

    def run():
        return sweep.run(seeds, mass)

    run.sweep = sweep
    return run


def _pendulum_step():
    """Two steps of `step_fn` from a fresh carry."""
    cfg = _config(PENDULUM_DEMO_CONFIG)
    stack = build_pendulum_stack(
        cfg, torch.Generator().manual_seed(3), device="cpu")
    sim = PendulumSimulation(
        controller=stack.controller, svmpc=stack.svmpc, mpf=stack.mpf,
        model=stack.model, warm_up=0, mpf_bw=stack.mpf_bw,
        mpf_steps=stack.mpf_steps, device="cpu")
    step = sim.step_fn(stack.dynamics_prior)
    obs = stack.init_state.reshape(1, -1)
    true = {"length": torch.tensor(1.1), "mass": torch.tensor(0.9)}

    def run():
        carry = (torch.Generator().manual_seed(4), obs,
                 stack.controller.init_state(stack.init_policies),
                 stack.svmpc.init_state(stack.init_policies,
                                        stack.policies_prior),
                 stack.mpf.init_state(stack.mpf_init, obs[0], 1))
        logs = []
        for t in range(2):
            carry, log = step(carry, t, true)
            logs.append(log)
        return logs

    return run


def _particle_step():
    """Two steps of the particle episode's loop."""
    cfg = _config(PARTICLE_DEMO_CONFIG)
    stack = build_particle_stack(
        cfg, torch.Generator().manual_seed(5), device="cpu")
    ep = particle_episode_fn(
        stack.model, stack.controller, svmpc=stack.svmpc, mpf=stack.mpf,
        load=stack.load, steps=2, warm_up=0, mpf_bw=stack.mpf_bw,
        mpf_steps=stack.mpf_steps)

    def run():
        return ep(torch.Generator().manual_seed(6), stack.init_state,
                  stack.controller.init_state(),
                  stack.svmpc.init_state(stack.init_policies,
                                         stack.policies_prior),
                  stack.mpf.init_state(stack.mpf_init, stack.init_state, 2,
                                       bw=stack.mpf_init_bw), 2.0)

    return run


BUILD = {"pendulum.sweep": _pendulum_sweep, "particle.sweep": _particle_sweep,
         "pendulum.step": _pendulum_step, "particle.step": _particle_step}


def _spans(fn, tmp_path):
    """Run fn under a CPU profiler: (its result, the user-annotation
    spans [(start, end, name)] in start order)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events.get("traceEvents", events) if isinstance(
        events, dict) else events
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation")
    return out, spans


def _inside(spans, outer):
    s0, e0, _ = outer
    return [n for s, e, n in spans if s0 <= s and e <= e0 and (s, e) != (
        s0, e0)]


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if hasattr(tree, "__dataclass_fields__"):
        return [t for f in tree.__dataclass_fields__
                for t in _tensors(getattr(tree, f))]
    return [torch.tensor(tree)]


@pytest.mark.parametrize("case", CASES)
def test_no_span_entered_without_a_profiler(case, monkeypatch, tmp_path):
    """A counting patch on the helper's `record_function`: no entry while
    nothing records, entries under a profiler."""
    entered = []
    real = profiling.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "record_function", counting)
    fn = BUILD[case]()
    fn()
    assert entered == []
    _spans(fn, tmp_path)
    assert entered


@pytest.mark.parametrize("case", CASES)
def test_spans_nest_as_documented(case, tmp_path):
    _, spans = _spans(BUILD[case](), tmp_path)
    names = [n for _, _, n in spans]
    if case.endswith("sweep"):
        assert names == ["sweep.run", *SWEEP]
        assert _inside(spans, spans[0]) == list(SWEEP)
        # the three phases follow each other, none inside another
        ends = [e for _, e, _ in spans[1:]]
        starts = [s for s, _, _ in spans[1:]]
        assert all(e <= s for e, s in zip(ends, starts[1:]))
        return
    runs = [sp for sp in spans if sp[2] in STEP]
    assert [n for _, _, n in runs] == list(STEP) * 2
    for sp in runs:
        inner = _inside(spans, sp)
        assert inner == (list(MPF) if sp[2] == "mpf.optimize" else [])


def test_gather_span_with_a_mesh(monkeypatch, tmp_path):
    """With a mesh (a stand-in of one rank holding every group), the
    gather runs in `sweep.gather`, inside `sweep.run` after the adapter's
    spans."""
    monkeypatch.setattr(sweep_module, "check_axis", lambda mesh, axis: None)
    monkeypatch.setattr(sweep_module, "block",
                        lambda n, mesh, axis: slice(0, n))
    monkeypatch.setattr(sweep_module, "all_gather_rows",
                        lambda x, mesh, axis: x)
    fn = _pendulum_sweep(mesh=object())
    out, spans = _spans(fn, tmp_path)
    assert [n for _, _, n in spans] == ["sweep.run", *SWEEP, "sweep.gather"]
    assert _inside(spans, spans[0]) == [*SWEEP, "sweep.gather"]
    plain = _pendulum_sweep()()
    assert all(torch.equal(out[k], plain[k]) for k in plain)


@pytest.mark.parametrize("case", CASES)
def test_outputs_bit_equal_with_profiler_on_and_off(case, tmp_path):
    fn = BUILD[case]()
    off = _tensors(fn())
    on = _tensors(_spans(fn, tmp_path)[0])
    assert len(on) == len(off) > 0
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def _reference_summary(rows, phases, steps, per):
    """chip_smoke._phase_clock's arithmetic as it was written inline."""
    clk = torch.cat(rows).double().cpu()
    n = len(phases)
    ns_per_cycle = clk[:, n + 1] / clk[:, n]
    us = (clk[:, :n] * ns_per_cycle[:, None]).mean(0) / (1e3 * steps)
    loop_us = float(clk[:, n + 1].mean()) / (1e3 * steps)
    out = {k: {f"us_per_{per}": float(v),
               "share": float(clk[:, i].sum() / clk[:, :n].sum())}
           for i, (k, v) in enumerate(zip(phases, us))}
    return {"blocks": int(clk.shape[0]), f"loop_us_per_{per}": loop_us,
            "ns_per_cycle": float(ns_per_cycle.mean()), "phases": out}


def _synthetic_rows(n_phases, blocks, seed):
    """A launch's rows: cycles per phase, the loop's cycles (their sum and
    a tail), its nanoseconds at 0.5-0.6 ns a cycle."""
    g = torch.Generator().manual_seed(seed)
    cyc = torch.randint(1000, 90000, (blocks, n_phases), generator=g)
    loop = cyc.sum(1) + torch.randint(0, 500, (blocks,), generator=g)
    rate = 0.5 + 0.1 * torch.rand(blocks, generator=g, dtype=torch.float64)
    ns = (loop.double() * rate).round().to(torch.int64)
    return torch.cat([cyc, loop[:, None], ns[:, None]], 1)


@pytest.mark.parametrize("phases,per,steps", [
    (episode.CLOCK_PHASES, "step", 200),
    (particle_episode.CLOCK_PHASES, "step", 7),
    (("load", "rollouts", "store"), "call", 1),
])
def test_phase_clock_summary_is_chip_smokes_arithmetic(phases, per, steps):
    rows = [_synthetic_rows(len(phases), 5, 1), _synthetic_rows(
        len(phases), 3, 2)]
    got = PhaseClock(phases).summary(rows, steps, per=per)
    want = _reference_summary(rows, phases, steps, per)
    assert got == want
    loop = got[f"loop_us_per_{per}"]
    assert 0 < sum(v[f"us_per_{per}"] for v in got["phases"].values()) <= \
        loop * 1.0001


def test_chip_smoke_phase_clock_line(monkeypatch, capsys):
    """chip_smoke._phase_clock prints the line it printed before
    `PhaseClock.summary` took its arithmetic."""
    phases = ("a", "b")
    clock = PhaseClock(phases)
    rows = _synthetic_rows(2, 4, 3)

    def launch():
        clock.rows(4, "cpu").copy_(rows)

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    got = chip_smoke._phase_clock("K0 (test)", launch, clock, steps=10,
                                  calls=2, per="call")
    want = _reference_summary([rows, rows], phases, 10, "call")
    assert got == want
    p = want["phases"]
    line = (f"K0 (test) per-phase clock, us per call (mean of 8 blocks; "
            f"share): a {p['a']['us_per_call']:.2f} "
            f"({100 * p['a']['share']:.1f}%), b {p['b']['us_per_call']:.2f} "
            f"({100 * p['b']['share']:.1f}%); the loop "
            f"{want['loop_us_per_call']:.2f} us per call, "
            f"{want['ns_per_cycle']:.4f} ns per cycle")
    assert capsys.readouterr().out.strip() == line


def test_sweep_passes_its_kernels_clock_through():
    assert _pendulum_sweep().sweep.phase_clock is episode.phase_clock
    assert _particle_sweep().sweep.phase_clock is particle_episode.phase_clock


def test_profile_main_path_reports_the_step_spans(tmp_path):
    """The operator's tool on the published stack's own step (CPU, tiny):
    every step span and the MPF's three, once a step."""
    from dust_tpu_torch.profile_main_path import profile as profile_steps

    summary, _ = profile_steps(_config(PENDULUM_DEMO_CONFIG), 2, "cpu",
                               tmp_path)
    assert set(summary["spans"]) == set(STEP) | set(MPF)
    for name, v in summary["spans"].items():
        assert v["calls_per_step"] == 1.0 and v["host_ms_per_step"] > 0
    assert summary["window_ms_per_step"] > 0
