"""The benchmark's readers of the program's spans, phase clock and
counters (`perfbench/metrics/{sweep_prep_ms,idle_in_program_pct,
step_rollout_us,step_svmpc_us,step_mpf_us,sweep_inputs_hit_pct,
rollout_ns_per_traj_step,mpf_reg_loop_pct,rollout_fast_pct}.py`,
`perfbench/phases.py`): each reads None without a device trace, the
program's spans, clock rows or counters (a program without them, the
CPU), and the right value from a stub `Trace`, a stub runner whose
clocked calls write known rows and a stub runner whose sweep adapter
names a wrapper with known counters."""

from types import SimpleNamespace

import pytest
import torch

from dust_tpu_torch.ops import episode, particle_episode
from dust_tpu_torch.ops.phase_clock import PhaseClock
from perfbench.harness import load_cell
from perfbench.phases import GROUPS
from perfbench.trace import Trace

CELL = load_cell("pendulum.sweep")
SPAN_READERS = ("sweep_prep_ms", "idle_in_program_pct")
CLOCK_READERS = {"step_rollout_us": "rollout", "step_svmpc_us": "svmpc",
                 "step_mpf_us": "mpf"}


def _read(name, **ctx):
    return CELL.metric_reader(name).read(SimpleNamespace(**ctx))


def _trace(program_spans=True, device=True, card_early=0.0):
    """Two traced calls of 10 s: the program's call 1-8 s (the library's
    launch at 4.2 s, its `sweep.launch` ending at 4.25 s) and 11-18 s
    (14.6 s, 14.75 s), the kernels 4.2-9.5 s and 14.6-19.9 s, on the card's
    clock `card_early` seconds ahead of the host's."""
    host = [(0.5, 0.6, "aten::empty"), (3.5, 3.6, "cudaLaunchKernel"),
            (4.2, 4.21, "cudaLaunchKernelExC"),
            (14.6, 14.61, "cudaLaunchKernel")]
    if program_spans:
        host += [(1.0, 8.0, "sweep.run"), (1.5, 3.0, "sweep.inputs"),
                 (3.0, 4.25, "sweep.launch"), (4.25, 4.5, "sweep.outputs"),
                 (11.0, 18.0, "sweep.run"), (12.0, 14.75, "sweep.launch")]
    dev = [(3.6, 3.61, "cat", "kernel"),
           (4.2, 9.5, "episode_kernel", "kernel"),
           (14.6, 19.9, "episode_kernel", "kernel")] if device else []
    dev = [(s - card_early, e - card_early, n, c) for s, e, n, c in dev]
    return Trace(spans=[(0.0, 10.0), (10.0, 20.0)], device=dev, host=host)


@pytest.mark.parametrize("card_early", [0.0, 2.0, -0.1],
                         ids=["clocks agree", "card 2 s early",
                              "card 0.1 s late"])
@pytest.mark.parametrize("name,want", [("sweep_prep_ms", 3500.0),
                                       ("idle_in_program_pct", 33.95)])
def test_span_readers_on_a_stub_trace(name, want, card_early):
    """The idle inside the calls: 7 - (8 - 4.2) - 0.01 s and
    7 - (18 - 14.6) s of the 20 s slice; a card ahead of the host is set
    back at each call's launch; one behind it reads later kernels."""
    tr = _trace(card_early=card_early)
    if card_early < 0:
        want = {"sweep_prep_ms": 3500.0, "idle_in_program_pct": 34.95}[name]
    assert _read(name, trace=tr) == pytest.approx(want)
    assert _read("idle_in_program_pct", trace=tr) <= tr.idle_pct()


@pytest.mark.parametrize("name", SPAN_READERS)
@pytest.mark.parametrize("trace", [None, _trace(device=False),
                                   _trace(program_spans=False)],
                         ids=["no trace", "no device", "no program spans"])
def test_span_readers_read_none_without_their_spans(name, trace):
    assert _read(name, trace=trace) is None


def _rows(n_phases, blocks=3):
    cyc = torch.arange(1, blocks * n_phases + 1).reshape(blocks, n_phases)
    cyc = 1000 * cyc
    loop = cyc.sum(1) + 250
    ns = loop // 2 + 10 * torch.arange(blocks)
    return torch.cat([cyc, loop[:, None], ns[:, None]], 1)


class _Runner:
    """A sweep runner's stand-in: each call writes `rows` into the clock's
    open context (a launch on the card), or with `rows` None nothing (the
    plain version)."""

    steps = 10
    traffic = {"trace": {"warmup": 2}}

    def __init__(self, clock, rows):
        self.sweep = SimpleNamespace(phase_clock=clock) if clock else \
            SimpleNamespace()
        self.rows, self.calls = rows, 0

    def unit_call(self, record=False):
        if self.rows is not None:
            self.sweep.phase_clock.rows(len(self.rows), "cpu").copy_(
                self.rows)
        self.calls += 1
        return 0.0, None


@pytest.mark.parametrize("phases", [episode.CLOCK_PHASES,
                                    particle_episode.CLOCK_PHASES],
                         ids=["K5", "K10"])
def test_clock_readers_on_stub_rows(phases, capsys):
    clock, rows = PhaseClock(phases), _rows(len(phases))
    runner = _Runner(clock, rows)
    want = clock.summary([rows, rows], runner.steps)
    got = {name: _read(name, runner=runner, trace=_trace())
           for name in CLOCK_READERS}
    # the traffic's trace.warmup clocked calls, once for the three readers
    assert runner.calls == 2
    for name, group in CLOCK_READERS.items():
        assert got[name] == pytest.approx(sum(
            want["phases"][p]["us_per_step"] for p in GROUPS[group]))
    # the stderr line: the three and the remainder make the loop
    line = capsys.readouterr().err.strip().splitlines()[-1]
    loop = float(line.split("loop ")[1].split(";")[0])
    rest = float(line.split("remainder ")[1].split(" ")[0])
    assert loop == pytest.approx(want["loop_us_per_step"], abs=1e-3)
    assert sum(got.values()) + rest == pytest.approx(loop, abs=2e-3)
    assert "unclocked kernel 530000.000" in line


@pytest.mark.parametrize("clock", [None, PhaseClock(("a", "b"))],
                         ids=["program without a clock", "no rows"])
def test_clock_readers_read_none_without_rows(clock):
    runner = _Runner(clock, None)
    for name in CLOCK_READERS:
        assert _read(name, runner=runner, trace=None) is None
    assert runner.calls == (2 if clock else 0)


def _counting_runner(**counters):
    wrapper = SimpleNamespace(**counters)
    return SimpleNamespace(sweep=SimpleNamespace(
        sweep_fn=SimpleNamespace(wrapper=wrapper)))


@pytest.mark.parametrize("hits,builds,want", [(499, 1, 99.8), (2, 2, 50.0),
                                              (0, 3, 0.0)])
def test_inputs_hit_reader_on_a_stub_runner(hits, builds, want):
    runner = _counting_runner(input_hits=hits, input_builds=builds)
    got = _read("sweep_inputs_hit_pct", runner=runner, trace=None)
    assert got == pytest.approx(want)


@pytest.mark.parametrize("runner", [
    SimpleNamespace(),
    SimpleNamespace(sweep=SimpleNamespace(sweep_fn=SimpleNamespace())),
    _counting_runner(launches=3),
    _counting_runner(input_hits=0, input_builds=0),
], ids=["no sweep", "adapter without a wrapper", "wrapper without the "
        "counters", "no call"])
def test_inputs_hit_reader_reads_none_without_counters(runner):
    assert _read("sweep_inputs_hit_pct", runner=runner, trace=None) is None


def test_inputs_hit_reader_on_the_programs_adapter():
    """Through `MegakernelGroupSweep` over the pendulum's adapter on the
    CPU: the wrapper it names counts a build, then a hit."""
    import copy

    from dust_tpu_torch.experiments import (
        PENDULUM_DEMO_CONFIG,
        build_pendulum_stack,
    )
    from dust_tpu_torch.ops import sweep_episode
    from dust_tpu_torch.parallel import MegakernelGroupSweep
    from dust_tpu_torch.simulation import megakernel_pendulum_sweep_fn

    cfg = copy.deepcopy(PENDULUM_DEMO_CONFIG)
    cfg["exp_params"].update(horizon=4, n_particles=2, action_samples=8,
                             params_samples=2, mpf_n_particles=8,
                             mpf_steps=2)
    stack = build_pendulum_stack(cfg, torch.Generator().manual_seed(1),
                                 device="cpu")
    adapter = megakernel_pendulum_sweep_fn(stack, cfg["exp_params"],
                                           steps=2, n_sc=2)
    wrapper = sweep_episode.fused_pendulum_sweep_episode
    assert adapter.wrapper is wrapper
    runner = SimpleNamespace(sweep=MegakernelGroupSweep(adapter))
    lens, mass = torch.tensor([0.9, 1.1]), torch.tensor([1.0, 1.05])
    h0, b0 = wrapper.input_hits, wrapper.input_builds
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for i in range(2):
            runner.sweep.run(torch.tensor([[i, 7]]), lens, mass)
    finally:
        torch.set_num_threads(n)
    assert (wrapper.input_hits, wrapper.input_builds) == (h0 + 1, b0 + 1)
    got = _read("sweep_inputs_hit_pct", runner=runner, trace=None)
    total = wrapper.input_hits + wrapper.input_builds
    assert got == pytest.approx(100.0 * wrapper.input_hits / total)


@pytest.mark.parametrize("reg,smem,want", [(5, 0, 100.0), (3, 1, 75.0),
                                            (0, 2, 0.0)])
def test_mpf_reg_loop_reader_on_a_stub_runner(reg, smem, want):
    """`mpf_reg_loop_pct`: 100 x register-loop launches over all episode
    launches of the wrapper that the sweep adapter names."""
    runner = _counting_runner(mpf_reg_launches=reg, mpf_smem_launches=smem)
    got = _read("mpf_reg_loop_pct", runner=runner, trace=None)
    assert got == pytest.approx(want)


@pytest.mark.parametrize("runner", [
    SimpleNamespace(),
    SimpleNamespace(sweep=SimpleNamespace(sweep_fn=SimpleNamespace())),
    _counting_runner(launches=3),
    _counting_runner(mpf_reg_launches=4),
    _counting_runner(mpf_reg_launches=0, mpf_smem_launches=0),
], ids=["no sweep", "adapter without a wrapper", "wrapper without the "
        "counters", "one counter only", "no launch"])
def test_mpf_reg_loop_reader_reads_none_without_counters(runner):
    assert _read("mpf_reg_loop_pct", runner=runner, trace=None) is None


def test_mpf_reg_loop_counters_on_the_programs_wrappers(monkeypatch):
    """The episode wrappers that `run_episodes` counts carry both
    counters from import (K4, K5's sweep, K9, K10's sweep, K14's sweep);
    the particle sweep's wrapper, once it has made register-loop launches
    and no other, reads 100."""
    from dust_tpu_torch.ops import (
        cartpole_sweep_episode,
        particle_sweep_episode,
        sweep_episode,
    )

    wrapper = particle_sweep_episode.fused_particle_sweep_episode
    for w in (episode.fused_pendulum_episode,
              sweep_episode.fused_pendulum_sweep_episode,
              particle_episode.fused_particle_episode, wrapper,
              cartpole_sweep_episode.fused_cartpole_sweep_groups):
        assert isinstance(w.mpf_reg_launches, int)
        assert isinstance(w.mpf_smem_launches, int)
    monkeypatch.setattr(wrapper, "mpf_reg_launches", 7)
    monkeypatch.setattr(wrapper, "mpf_smem_launches", 0)
    runner = _counting_runner()
    runner.sweep.sweep_fn.wrapper = wrapper
    got = _read("mpf_reg_loop_pct", runner=runner, trace=None)
    assert got == pytest.approx(100.0)


@pytest.mark.parametrize("fast,fallback,want", [(100, 0, 100.0),
                                                 (3, 1, 75.0), (0, 7, 0.0),
                                                 (999, 1, 99.9)])
def test_rollout_fast_reader_on_a_stub_runner(fast, fallback, want):
    """`rollout_fast_pct`: 100 x the rollout chunk-steps that took the
    fast path over all of them, from the wrapper's `rollout_guard`."""
    guard = SimpleNamespace(fast=fast, fallback=fallback)
    runner = _counting_runner(rollout_guard=guard)
    got = _read("rollout_fast_pct", runner=runner, trace=None)
    assert got == pytest.approx(want)


@pytest.mark.parametrize("runner", [
    SimpleNamespace(),
    SimpleNamespace(sweep=SimpleNamespace(sweep_fn=SimpleNamespace())),
    _counting_runner(launches=3),
    _counting_runner(rollout_guard=SimpleNamespace(fast=4)),
    _counting_runner(rollout_guard=SimpleNamespace(fast=0, fallback=0)),
], ids=["no sweep", "adapter without a wrapper", "wrapper without the "
        "counts", "one count only", "no launch"])
def test_rollout_fast_reader_reads_none_without_counts(runner):
    assert _read("rollout_fast_pct", runner=runner, trace=None) is None


def test_rollout_fast_counts_on_the_programs_wrappers():
    """K14's sweep wrapper carries the rollouts' two counts from import,
    zero before any launch (the ones a fresh `GuardCounts` reads too); the
    pendulum's and the particle's sweep wrappers (K5, K10, whose rollouts
    take no such guard) carry none, so their cells read None."""
    from dust_tpu_torch.ops import (
        cartpole_sweep_episode,
        particle_sweep_episode,
        sweep_episode,
    )
    from dust_tpu_torch.ops.episode_kernel import GuardCounts

    fresh = GuardCounts()
    assert (fresh.fast, fresh.fallback, fresh.steps) == (0, 0, 0)
    guard = cartpole_sweep_episode.fused_cartpole_sweep_groups.rollout_guard
    assert isinstance(guard, GuardCounts)
    assert isinstance(guard.fast, int) and isinstance(guard.fallback, int)
    assert (guard.fast, guard.fallback) == (0, 0)
    for wrapper in (sweep_episode.fused_pendulum_sweep_episode,
                    particle_sweep_episode.fused_particle_sweep_episode):
        runner = _counting_runner()
        runner.sweep.sweep_fn.wrapper = wrapper
        assert _read("rollout_fast_pct", runner=runner, trace=None) is None


def test_rollout_guards_count_every_chunk_step():
    """K14's guarded chunk-steps per launch: each (particle, action
    sample) pair's chunks of CHAIN_DRAWS draws over the horizon's steps
    and the final cosine, every episode step of every episode."""
    from dust_tpu_torch.ops import cartpole_episode

    st = dict(steps=200, m=3, n_act=128, n_params=8, hz=30)
    chunks = -(-8 // cartpole_episode.CHAIN_DRAWS)
    assert cartpole_episode.rollout_guards(st, 256) == \
        256 * 200 * 3 * 128 * chunks * 31
    assert cartpole_episode.rollout_guards(dict(st, n_params=9), 1) == \
        200 * 3 * 128 * (chunks + 1) * 31
    assert cartpole_episode.KERNEL.rollout_guards is \
        cartpole_episode.rollout_guards


@pytest.mark.parametrize("phases", [episode.CLOCK_PHASES,
                                    particle_episode.CLOCK_PHASES],
                         ids=["K5 and K14", "K10"])
def test_rollout_ns_reader_on_stub_rows(phases):
    """`rollout_ns_per_traj_step`: the clock's `rollouts` phase, us per
    episode step x 1000, over params_samples x action_samples x
    n_particles x horizon; None without clock rows."""
    clock, rows = PhaseClock(phases), _rows(len(phases))
    runner = _Runner(clock, rows)
    runner.exp = {"params_samples": 8, "action_samples": 128,
                  "n_particles": 3, "horizon": 30}
    want = clock.summary([rows, rows], runner.steps)
    got = _read("rollout_ns_per_traj_step", runner=runner, trace=_trace())
    us = want["phases"]["rollouts"]["us_per_step"]
    assert got == pytest.approx(1e3 * us / (8 * 128 * 3 * 30))
    quiet = _Runner(PhaseClock(phases), None)
    quiet.exp = runner.exp
    assert _read("rollout_ns_per_traj_step", runner=quiet, trace=None) \
        is None
