#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`dust_tpu_torch`) on one NVIDIA
GPU: builds the hand-written kernels, holds each against its plain
PyTorch version, drives the pendulum and particle-navigation DuSt closed
loops through them at the demo configurations' full width, and times the
kernels.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. build the kernels from dust_tpu_torch/csrc with nvcc (sm_90a); print
     the build time and the card's name and power limit;
  2. K1 (rollout costs) against its plain version on the card, bit for
     bit, at the main-path shapes and at an odd shape near the speed
     clamp, on contiguous, stride-2 and default (number) draw columns,
     above the staged horizon and at 11 and 17 draws (the draws' rounds);
     its draw mean (the MultiDisco hook's launch) against costs.mean(0)
     at K1_MEAN_RTOL and bit for bit against draw_mean_plain;
  3. K2 (the MPF loop) against its plain version, m = 50, 20 steps,
     log_space off and on, near the speed clamp, and at m = 64 (the
     ceiling of its register path), 300 and 1024 (its general path);
  4. the main path: the `dust` stack from PENDULUM_DEMO_CONFIG with the
     fused rollout (K1) and FusedPendulumMPF (K2), 200 MPC steps of
     PendulumSimulation; every kernel must launch once per step (each
     MultiDisco hook call exactly one K1 launch), every
     cost, action and particle must be finite, and the pendulum must swing
     up (on every path: the lowest cost in steps 100-199 below 1; for the
     sweep, its median over episodes, and at most 1 in 64 episodes above);
  5. kernel path against plain path (rollout loop + autograd MPF) for
     10 steps from the same state and generator seed, re-synced per step;
  6. kernel and plain-version times at the main-path shapes, beside the
     bound: device time per call (20 calls in one CUDA graph, median of 7
     replays) and time per call as the main path pays it (CUDA events
     around one call, median of 100); plain, kernel, kernel, plain; path
     1's MultiDisco hook on stride-2 draw columns: its device operations
     per call (torch.profiler; it must be one, K1), device time and time
     per call; then 20 more hook and K2 calls under K1's and K2's clocked
     builds: the mean time per call of their phases (K1: load, rollouts,
     store; K2: load, prior score and drive summed over the iterations,
     store);
  7. K3 (the whole SVMPC solve, one thread-block cluster of a block per
     policy particle) against its plain version at the demo shapes, at an
     odd shape near the speed clamp and at m = 1 and 8;
  8. path 2: the `dust` stack with `fused_solve: true` (K3) and
     FusedPendulumMPF (K2), 200 MPC steps of PendulumSimulation; K3 and K2
     must launch once per step and K1 never;
  9. the K3 path against the plain path (rollout loop + autograd MPF) for
     10 steps from the same state and generator seed, re-synced per step;
 10. K4 (the whole episode) against its plain version in host-noise mode
     (1 and 3 steps) and in device-RNG mode (2 steps), and against the
     composition of the K3 and K2 kernels with the same noise;
 11. path 3: one 200-step episode of the demo stack in one K4 launch
     (`megakernel_pendulum_episode_fn`): ms per episode, swing-up, the
     same seed gives the same bits, another seed other results;
 12. K5 (the scenario sweep) against independent K4 launches, 16
     scenarios x 2 chains, bit for bit; a NaN in one scenario's true
     length or MPF particles leaves every other scenario's bits alone;
 13. path 4: bench.py's sweep shape, 256 episodes = 8 groups x 16
     scenarios x 2 chains x 200 steps, in one K5 launch through
     MegakernelGroupSweep: solves/s and the median over episodes of the
     lowest cost in steps 100-199. Before it, K5 at this layout against
     its plain version after 1 and 2 steps and against one launch per
     group (bit for bit); after it, the plain sweep on the same
     draws over 200 steps: where the episodes drift apart and how many
     fail to swing up on either side;
 14. K3, K4 and K5 times beside their bounds: K3 as in phase 6, then 20
     more K3 solves under its clocked build (load, rollouts, DISCO weights,
     delta, Stein step, outputs); K4 and K5 (one launch each, 20-70 ms)
     between CUDA events around single calls, their plain versions
     likewise (one call each: bound by the host launching their
     operations); then one more K4 and K5 call under the
     kernel's clocked build: the mean time per step of each phase of the
     step (noise, Silverman, parameter draws, rollouts, DISCO weights, DISCO
     delta, Stein step, commit and simulator, MPF bandwidth, MPF loop, log);
 15. K6 (particle rollout costs) against its plain version at the demo
     shapes (4 x 64 x 6, H 40) from a free start, inside an obstacle and
     inside a wall, and the kernels' occupancy test against occupancy_hit
     and the raster on every map cell (centers, edges, a hair either side)
     and beyond the map, exactly;
 16. K7 (the particle-mass MPF loop) against its plain version, m = 50,
     20 steps, log and linear space, both clip gates, a crashed start;
 17. path 5: `run_particle_episode` on the particle demo stack with the
     fused rollout (K6) and FusedParticleMPF (K7), 200 steps; K6 launches
     200 times, K7 once per step before termination; the outcome (crash,
     success, steps, minimum distance to the target, MPF mass estimate
     before and after the load at step 50), gated on finiteness and on
     getting 2 m nearer the target;
 18. the K6 path against the plain path for 10 re-synced steps;
 19. K8 (the whole particle solve, one thread-block cluster of a block per
     policy particle) against its plain version at the demo shapes, both
     likelihoods, free and crashed starts;
 20. path 6: `fused_solve: true` (K8) + K7, 200 steps; K6 stays wired and
     must not launch; then the K8 path against the plain path;
 21. K9 (the whole particle episode) against its plain version in
     host-noise mode (1 and 3 steps, warm_up 0 and 2; the Silverman MPF
     bandwidth, the unweighted prior and ExpectedCost over 2 steps) and
     device-RNG mode, and against the K8 + K7 kernel composition;
 22. path 7: one 200-step K9 episode (`megakernel_particle_episode_fn`,
     device RNG): ms per episode, the outcome, the same seed gives the
     same bits, another seed other results;
 23. K6-K9 times beside their bounds, as phases 6 and 14; then 20 more K8
     solves under its clocked build (the mean time per solve of its phases:
     load, rollouts, DISCO weights, delta, Stein step, outputs) and one more
     K9 episode under the kernel's clocked build: the mean time per step
     of each phase of the step (noise, Silverman, mass draws, rollouts,
     DISCO weights, DISCO delta, Stein step, commits and simulator, MPF
     bandwidth, MPF loop, cost and log);
 24. K10 (the particle scenario sweep) against independent K9 launches,
     8 scenarios x 4 chains, bit for bit (host noise: every episode;
     device RNG: scenario 0 of each chain); a NaN true mass or MPF
     particle in one scenario leaves every other scenario's bits alone;
     the device-RNG sweep and its final log-mix against the plain version;
 25. path 8: bench/bench_all.py's particle sweep, 256 episodes = 8 groups x
     8 scenarios x 4 chains x 200 steps, in one K10 launch through
     MegakernelGroupSweep: solves/s, crash and success shares, the mean
     minimum distance to the target; before it the layout against the
     plain version after 1 and 2 steps and against per-group launches,
     after it the plain sweep's outcome on the same draws;
 26. path 9: ParticleScenarioSweep over the K6 + K7 step loop, 8 scenarios
     (true masses 1.5-3.0) x 200 steps: crashed <=> inf cost, the masses
     move the trajectories, every scenario against run_particle_episode on
     the same generator seed;
 27. K11a-c (streamed SVGD direction), K12a-b (streamed GMM prior score)
     and K13 (the fused SVGD step) against their plain versions at m =
     2048 and 8192, the JAX tests' odd shapes (K11 and K12 at d = 60 on
     their general paths, K12 with m = k = 300 and m = 300, k = 130), far
     from the origin, bf16, m = 1, 33, 2049 and 8191 at d = 1, 2, 3 and 8
     (K12 with k != m; two calls bit-equal), and m = 32768 in four
     1024-row chunks;
 28. path 10: bench_all.py's particle_large stack (16 x 512 x 8 rollouts,
     2048 MPF particles) with FusedMPF (K11a + K12a, 20 launches each per
     step), 50 steps of run_particle_episode; the generic MPF on the same
     seed;
 29. path 11: FusedMPF.optimize in bench_mpf_large's form at m = 2048,
     8192, 32768 and with fuse_streams at 8192 and 32768: conditioned
     updates per second and the launches of each layout;
 30. K10-K13 times beside their bounds, as phases 6 and 14, and K10's
     per-phase clock as phase 23 takes K9's; K12b and K13 also at
     m = 32768; K12's yardstick, one scaled_dot_product_attention call
     (held once against the plain version), as its library time;
 31. path 12: the DuSt paper's other three pendulum cases at the demo
     width, 200 MPC steps of PendulumSimulation each (`dust` is path 1):
     `svmpc` (each MultiDisco hook call one K1 launch, once per step, K2
     never), `mppi` with the exact model and `disco_utf` (5 sigma points x
     128 samples; neither launches a kernel); finite costs, actions and
     states, and the swing-up check (dust_tpu's same cases swing up on the
     CPU: `python -m tests.test_torch_paper_cases`);
 32. path 13: ScenarioSweep over the `dust` stack with the K1 hook and
     FusedPendulumMPF (K2), 8 scenarios x 200 steps, true (length, mass)
     drawn from the dynamics prior: seconds per sweep, healthy share,
     mean_cost_healthy; scenario 0 bit-equal to one episode_fn run from its
     seed; a NaN true length leaves its scenario unhealthy and the other
     scenarios bit-equal;
 33. tests/test_cross_model.py's scenarios on the card: MultiDisco
     balances the cart-pole and drives the skid-steer robot to its
     waypoint, SVMPC on the cart-pole; no kernel launch.

Every path is driven with all launch counts set to 0 just before it and
read just after. The line before the last is the kernels' JSON summary;
the last line is
{"ok": true, "device": {...}}. A full report goes to
chiprun_out/chip_smoke_report.json. Without a CUDA device the script
prints no result and exits 2.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W): HBM bytes/s
# and float32 operations/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

MAIN_STEPS = 200
COMPARE_STEPS = 10
SEED = 0
K1_TOL = dict(rtol=1e-5, atol=1e-4)
# K1's draw mean against torch's costs.mean(0): the same sum in
# perhaps another order, scaled by the same 1 / n_params
K1_MEAN_RTOL = 1e-6
K2_TOL = dict(rtol=1e-4, atol=1e-5)
# K3 against its plain version: the same arithmetic, sums over samples
# and particles in another order; costs and weights at K1's tolerance,
# particles and plans (softmax-weighted sums) at K2's
K3_TOL = dict(rtol=1e-4, atol=1e-4)
# K4 against its plain version (tests/test_pallas_episode.py:137-157):
# after 3 steps the chaotic rollout amplifies ulp drift of the particles
K4_TOLS = dict(th=1e-5, om=1e-4, action=1e-4, cost=1e-3, bw_sv=1e-6,
               bw_mpf=1e-6, theta=1e-3, a_mat=5e-3, mpf_x=1e-5)
K4_FIELDS = ("th", "om", "action", "cost", "bw_sv", "bw_mpf")
SWEEP_GROUPS, SWEEP_SC, SWEEP_CHAINS = 8, 16, 2
# swing-up reached: the lowest cost in steps 100-199 stays below
# bench.py's sanity level (the cost is 0 upright at rest, 200 hanging)
SWINGUP_MAX_COST = 1.0
# the sweep: a fault in a minority of blocks must not hide behind the
# median, so at most 1 in 64 episodes may miss that level
SWEEP_MAX_FAIL_SHARE = 1 / 64
# the closed loop's tolerances (tests/test_equivalence_dual.py)
EARLY_TOL = dict(rtol=1e-3, atol=5e-4)
RUN_TOL = dict(rtol=5e-3, atol=1e-2)


def _nvidia_smi():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def _errors(got, want):
    diff = (got - want).abs()
    max_abs = diff.max().item()
    max_rel = (diff / want.abs().clamp(min=1e-30)).max().item()
    return max_abs, max_rel


def _check_close(name, got, want, rtol, atol):
    import torch

    max_abs, max_rel = _errors(got, want)
    ok = bool(torch.allclose(got, want, rtol=rtol, atol=atol))
    print(f"{name}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
          f"(rtol={rtol}, atol={atol}) {'ok' if ok else 'FAIL'}")
    if not ok or not torch.isfinite(got).all():
        raise AssertionError(f"{name} disagrees with its plain version")
    return max_abs


def _check_equal(name, got, want):
    """got and want bit for bit."""
    import torch

    same = bool(torch.equal(got, want))
    print(f"{name}: {'bit-equal' if same else 'FAIL: bits differ'}")
    if not same:
        raise AssertionError(f"{name} is not bit-equal to its plain version")


def _call_ms(fn, reps=100, warmup=10):
    """Median time of one call as the main path pays it: CUDA events
    around each call, so host work inside the call that keeps the device
    waiting is included."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _fmt(values):
    return " / ".join(f"{v:.4f}" for v in values)


def _device_ms(fn, calls=20, replays=7):
    """Device time of one call: `calls` calls captured in one CUDA graph,
    replayed between CUDA events (no host work between launches); the
    median over replays of the time per call."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


# -- inputs at the kernels' shapes -----------------------------------------

def _k1_inputs(n_params, n_act, n_pol, hz, state0, gen, dev):
    import torch

    # 2.5-sigma torques: many beyond the +-2 clamp
    actions = 2.5 * torch.randn((n_act, n_pol, hz, 1), generator=gen,
                                device=dev)
    lengths = 0.6 + 0.7 * torch.rand((n_params,), generator=gen, device=dev)
    masses = 0.6 + 0.7 * torch.rand((n_params,), generator=gen, device=dev)
    return (torch.tensor(state0, device=dev), actions, lengths, masses)


def _k2_inputs(m, past_obs, loc, action, gen, dev, log_space=False):
    import torch

    x = 0.6 + 0.7 * torch.rand((m, 2), generator=gen, device=dev)
    if log_space:
        x = torch.log(x)
    centers = x + 0.02 * torch.randn((m, 2), generator=gen, device=dev)
    return dict(
        x=x, prior_locs=centers,
        past_obs=torch.tensor(past_obs, device=dev),
        loc=torch.tensor(loc, device=dev),
        action=torch.tensor([action], device=dev),
        bw=torch.tensor(0.05, device=dev),
        prior_bw=torch.tensor(0.04, device=dev),
        lr=torch.tensor(1e-3, device=dev),
        obs_sigma=torch.tensor(0.1, device=dev),
    )


def _k1_bound(n_params, n_act, n_pol, hz, mean=False):
    """Least time for K1's work on the card: each input read once, each
    output written once (the costs, or with mean=True the draw mean in
    their place); per trajectory and step 19 float32 operations (cost 7:
    cos, -1, square, *50, om^2, 2 adds; dynamics 12: 2 clamps of 2, +pi,
    sin, 2 products, 2 adds, *dt, +), plus the terminal cost (7) and the
    per-thread coefficients (6); the mean adds one sum per trajectory and
    one product per (sample, policy)."""
    n = n_params * n_act * n_pol
    n_out = n_act * n_pol if mean else n
    nbytes = 4 * (2 + n_act * n_pol * hz + 2 * n_params + n_out)
    ops = n * (19 * hz + 7 + 6) + (n + n_act * n_pol if mean else 0)
    return _bound(nbytes, ops)


def _k2_bound(m, n_steps):
    """Least time for K2's work: inputs x, centers [m, 2] and 9 scalars
    read once, x [m, 2] written once; per iteration and particle pair 28
    float32 operations (prior score 15: distance 5, scale 2, max, shift,
    exp, sum, weighted center sums 4; RBF drive 13: distance 5, scale 2,
    exp, row sum, drive products and sums 4), and per particle 57 (the
    likelihood gradient ~45, normalisation and update ~12)."""
    nbytes = 4 * (2 * m + 2 * m + 9 + 2 * m)
    ops = n_steps * (28 * m * m + 57 * m)
    return _bound(nbytes, ops)


def _bound(nbytes, ops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops)


# -- phases -----------------------------------------------------------------

def phase_build():
    from dust_tpu_torch.ops import _build

    info = _build.build()
    _build.load_library()
    print(f"build: {'compiled' if info['built'] else 'up to date'} in "
          f"{info['seconds']:.1f} s -> {_build.LIB_PATH.relative_to(ROOT)}")
    for line in info["log"].splitlines():
        if "registers" in line or "==" in line or "spill" in line:
            print("  " + line.strip())
    return info


def _k1_columns(kind, lens, masses):
    """K1's length and mass arguments for one case of phase 2: contiguous
    [n_params] tensors, stride-2 columns of an [n_params, 2] draw array
    (as `MultiDisco._sample_params` builds them), or the model's default
    (1.0) as a number in place of one column or both."""
    import torch

    if kind == "contiguous":
        return lens, masses
    draws = torch.stack([lens, masses], dim=1)
    cols = draws[:, 0], draws[:, 1]
    return {"strided": cols, "default length": (1.0, cols[1]),
            "default mass": (cols[0], 1.0), "no draws": (1.0, 1.0)}[kind]


def phase_k1(dev):
    """K1 against its plain version, bit for bit: at the main-path shapes
    and an odd shape near the speed clamp, on contiguous, stride-2 and
    default (number) draw columns, above MAX_STAGED_HORIZON (the actions
    read from device memory), and at 11 and 17 draws (more than a block's
    8 at a time: the draws loop in rounds, the mean carried across them).
    Each case launches twice: the costs, then the draw mean alone (the
    launch the MultiDisco hook makes), held bit for bit against
    `draw_mean_plain` of the plain costs and against costs.mean(0) at
    K1_MEAN_RTOL; the stride-2 cases also through the hook itself."""
    import torch

    from dust_tpu_torch.ops import rollout

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    unstaged = 2 * rollout.MAX_STAGED_HORIZON
    errs, mean_bits = {}, {}
    for label, shape, state0, kind in (
            ("main 8x128x3 H30", (8, 128, 3, 30), (3.0, 0.0), "contiguous"),
            ("odd 3x7x3 H11", (3, 7, 3, 11), (0.2, 7.9), "contiguous"),
            ("strided 8x128x3 H30", (8, 128, 3, 30), (3.0, 0.0), "strided"),
            ("default length 8x128x3 H30", (8, 128, 3, 30), (3.0, 0.0),
             "default length"),
            ("default mass 3x7x3 H11", (3, 7, 3, 11), (0.2, 7.9),
             "default mass"),
            ("no draws 1x128x3 H30", (1, 128, 3, 30), (3.0, 0.0),
             "no draws"),
            (f"unstaged 2x5x3 H{unstaged}", (2, 5, 3, unstaged), (3.0, 0.0),
             "strided"),
            ("11 draws strided 11x128x3 H30", (11, 128, 3, 30), (3.0, 0.0),
             "strided"),
            ("17 draws strided 17x7x3 H11", (17, 7, 3, 11), (0.2, 7.9),
             "strided"),
            ("17 draws default mass 17x128x3 H30", (17, 128, 3, 30),
             (3.0, 0.0), "default mass"),
            (f"11 draws unstaged 11x5x3 H{unstaged}", (11, 5, 3, unstaged),
             (3.0, 0.0), "strided"),
            (f"17 draws unstaged 17x7x3 H{unstaged + 3}",
             (17, 7, 3, unstaged + 3), (0.2, 7.9), "strided")):
        s0, acts, lens0, masses0 = _k1_inputs(*shape, state0, gen, dev)
        lens, masses = _k1_columns(kind, lens0, masses0)
        got = rollout.fused_pendulum_rollout_costs(s0, acts, lens, masses)
        mean = rollout.fused_pendulum_rollout_cost_mean(s0, acts, lens,
                                                        masses)
        torch.cuda.synchronize()
        want = rollout.pendulum_rollout_costs_plain(s0, acts, lens, masses)
        errs[label] = _check_close(f"K1 {label}", got, want, **K1_TOL)
        _check_equal(f"K1 {label} costs", got, want)
        _check_close(f"K1 {label} draw mean against costs.mean(0)", mean,
                     want.mean(0), rtol=K1_MEAN_RTOL, atol=0.0)
        _check_equal(f"K1 {label} draw mean", mean,
                     rollout.draw_mean_plain(want))
        if kind == "strided":
            hooked = _k1_hook_call(s0, acts, lens0, masses0)()
            torch.cuda.synchronize()
            _check_equal(f"K1 {label} draw mean through the hook", hooked,
                         rollout.draw_mean_plain(want))
        mean_bits[label] = int((mean != want.mean(0)).sum().item())
    print("K1 draw mean, elements whose bits differ from torch's "
          f"costs.mean(0): {mean_bits}")
    return max(errs.values())


def phase_k2(dev):
    """K2 against its plain version (its sums in the kernel's order): m =
    50, log space off and on, near the speed clamp; the register path's
    ceiling (m = REGISTER_MAX) and the general path (m = 300, and m =
    MAX_PARTICLES)."""
    import torch

    from dust_tpu_torch.ops import mpf

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    errs = {}
    for label, m, log_space, past_obs, loc, action in (
            ("m50 log_space=False", 50, False, (2.9, 0.4), (2.95, 0.9), 1.3),
            ("m50 log_space=True", 50, True, (2.9, 0.4), (2.95, 0.9), -2.6),
            ("m50 near speed clamp", 50, False, (0.5, 7.9), (0.6, 8.0), 2.0),
            (f"m{mpf.REGISTER_MAX} register ceiling", mpf.REGISTER_MAX, True,
             (2.9, 0.4), (2.95, 0.9), -1.1),
            ("m300 general path", 300, True, (2.9, 0.4), (2.95, 0.9), 0.7),
            (f"m{mpf.MAX_PARTICLES} general path", mpf.MAX_PARTICLES, False,
             (2.9, 0.4), (2.95, 0.9), 1.3)):
        inp = _k2_inputs(m, past_obs, loc, action, gen, dev, log_space)
        got = mpf.fused_pendulum_mpf_optimize(**inp, n_steps=20,
                                              log_space=log_space)
        torch.cuda.synchronize()
        scal = mpf._scalars(inp["x"], inp["past_obs"], inp["loc"],
                            inp["action"], inp["bw"], inp["prior_bw"],
                            inp["lr"], inp["obs_sigma"])
        want = mpf.pendulum_mpf_optimize_plain(inp["x"], inp["prior_locs"],
                                               scal, n_steps=20,
                                               log_space=log_space,
                                               lanes=mpf.ROW_LANES)
        if (want - inp["x"]).abs().max().item() < 1e-4:
            raise AssertionError(f"K2 {label}: the particles did not move")
        errs[label] = _check_close(f"K2 {label}", got, want, **K2_TOL)
    return max(errs.values())


def _kernel_harness(config, arrays, dev, fused, steps, fused_solve=False):
    """A stack and harness on the kernel path (fused=True: K1 hook, or K3
    with fused_solve=True, + FusedPendulumMPF) or the plain path (rollout
    loop + autograd MPF), wired around the same initial arrays, as
    bench.py wires the JAX stack."""
    from dust_tpu_torch.experiments import assemble_stack
    from dust_tpu_torch.inference import FusedPendulumMPF
    from dust_tpu_torch.simulation import PendulumSimulation

    cfg = copy.deepcopy(config)
    cfg["exp_params"]["fused_rollout"] = fused
    cfg["exp_params"]["fused_solve"] = fused and fused_solve
    stack = assemble_stack(cfg, arrays, case="dust", device=dev)
    if fused:
        stack.mpf = FusedPendulumMPF.from_mpf(stack.mpf)
    harness = PendulumSimulation(
        controller=stack.controller, svmpc=stack.svmpc, mpf=stack.mpf,
        model=stack.model, steps=steps, warm_up=0, mpf_bw=stack.mpf_bw,
        mpf_steps=stack.mpf_steps, device=dev,
    )
    return stack, harness


def _wrappers():
    """name -> the wrapper whose `launches` counts its kernel's launches."""
    from dust_tpu_torch.ops import (
        episode,
        gmm,
        mpf,
        mpf_stream,
        particle_episode,
        particle_mpf,
        particle_rollout,
        particle_sweep_episode,
        rollout,
        solve,
        svgd,
        sweep_episode,
    )

    return {
        "pendulum_rollout_costs": rollout.fused_pendulum_rollout_costs,
        "pendulum_mpf_optimize": mpf.fused_pendulum_mpf_optimize,
        "pendulum_solve": solve.fused_pendulum_solve,
        "pendulum_episode": episode.fused_pendulum_episode,
        "pendulum_sweep_episode": sweep_episode.fused_pendulum_sweep_episode,
        "particle_rollout_costs":
            particle_rollout.fused_particle_rollout_costs,
        "particle_mpf_optimize": particle_mpf.fused_particle_mpf_optimize,
        "particle_solve": solve.fused_particle_solve,
        "particle_episode": particle_episode.fused_particle_episode,
        "particle_sweep_episode":
            particle_sweep_episode.fused_particle_sweep_episode,
        "svgd_phi": svgd.svgd_phi_streamed,
        "svgd_phi_packed": svgd.svgd_phi_streamed_packed,
        "svgd_phi_symm": svgd.svgd_phi_streamed_symm,
        "gmm_prior_score": gmm.gmm_prior_score_streamed,
        "gmm_prior_score_packed": gmm.gmm_prior_score_streamed_packed,
        "mpf_stream_step": mpf_stream.fused_mpf_stream_step,
    }


def _reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def _counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


def _check_counts(path, counts, want):
    """Every kernel named in `want` launched exactly that often; any other
    kernel not at all."""
    for name, n in counts.items():
        if n != want.get(name, 0):
            raise AssertionError(
                f"{path}: {name} launched {n} times, expected "
                f"{want.get(name, 0)}")


def phase_main_path(dev, config, fused_solve=False):
    """Path 1 (fused_solve=False): K1 hook + FusedPendulumMPF. Path 2
    (fused_solve=True): FusedPendulumSVMPC (K3) + FusedPendulumMPF; the
    K1 hook stays wired and must not launch."""
    import torch

    from dust_tpu_torch.experiments import build_pendulum_stack
    from dust_tpu_torch.inference import FusedPendulumMPF
    from dust_tpu_torch.ops import rollout
    from dust_tpu_torch.simulation import PendulumSimulation

    label = "path 2 (K3 + K2)" if fused_solve else "main path"
    cfg = copy.deepcopy(config)
    cfg["exp_params"]["fused_rollout"] = True
    cfg["exp_params"]["fused_solve"] = fused_solve
    gen = torch.Generator(device=dev).manual_seed(SEED)
    stack = build_pendulum_stack(cfg, gen, case="dust", device=dev)
    # bench.py's kernel path: the single-kernel MPF
    stack.mpf = FusedPendulumMPF.from_mpf(stack.mpf)
    true_params = [{"length": 1.0, "mass": 1.0}]

    def run(steps):
        harness = PendulumSimulation(
            controller=stack.controller, svmpc=stack.svmpc, mpf=stack.mpf,
            model=stack.model, steps=steps, warm_up=0, mpf_bw=stack.mpf_bw,
            mpf_steps=stack.mpf_steps, device=dev,
        )
        return harness.run(stack.generator, true_params, stack.init_state,
                           stack.init_policies, stack.policies_prior,
                           stack.dynamics_prior, stack.mpf_init)

    # each call of the MultiDisco hook must launch K1 once (path 1) or
    # never be called (path 2): the K1 launches of every call are kept
    hook = stack.controller.fused_state_costs
    hook_launches = []

    def counted_hook(*args):
        before = rollout.fused_pendulum_rollout_costs.launches
        out = hook(*args)
        hook_launches.append(
            rollout.fused_pendulum_rollout_costs.launches - before)
        return out

    stack.controller.fused_state_costs = counted_hook
    run(5)  # warm-up: library handles, allocator, first-call set-up

    _reset_counts()
    hook_launches.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cols = run(MAIN_STEPS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = _counts()
    want_calls = 0 if fused_solve else MAIN_STEPS
    if len(hook_launches) != want_calls or any(n != 1 for n in
                                               hook_launches):
        raise AssertionError(
            f"{label}: {len(hook_launches)} hook calls (expected "
            f"{want_calls}), K1 launches per call "
            f"{sorted(set(hook_launches))} (expected 1)")
    print(f"{label}: {len(hook_launches)} MultiDisco hook calls, each one "
          f"K1 launch")
    print(f"{label}: {MAIN_STEPS} MPC steps "
          f"(8 draws x 128 samples x 3 policies, H 30; 50 MPF particles x "
          f"20 steps) in {elapsed:.3f} s; launches {launches}")
    solve_kernel = "pendulum_solve" if fused_solve else \
        "pendulum_rollout_costs"
    _check_counts(label, launches, {solve_kernel: MAIN_STEPS,
                                    "pendulum_mpf_optimize": MAIN_STEPS})
    for name in ("Cost", "Actions", "DynParticles", "PolParticles",
                 "Position", "Speed"):
        if not np.isfinite(cols[name]).all():
            raise AssertionError(f"{label}: non-finite values in {name}")
    second_half_min = float(cols["Cost"][MAIN_STEPS // 2:].min())
    result = {
        "steps": MAIN_STEPS,
        "seconds": elapsed,
        "solves_per_s": MAIN_STEPS / elapsed,
        "ms_per_step": 1e3 * elapsed / MAIN_STEPS,
        "min_cost_second_half": second_half_min,
        "final_cost": float(cols["Cost"][-1]),
        "launches": launches,
        "hook_calls": len(hook_launches),
    }
    print(f"{label}: {result['solves_per_s']:.1f} solves/s, "
          f"{result['ms_per_step']:.3f} ms per MPC step, lowest cost in "
          f"steps {MAIN_STEPS // 2}-{MAIN_STEPS - 1}: {second_half_min:.4f}")
    _check_swingup(label, second_half_min)
    return result


def _check_swingup(label, low):
    if not low < SWINGUP_MAX_COST:
        raise AssertionError(f"{label}: no swing-up (lowest cost in the "
                             f"second half {low:.4f})")


def phase_kernel_vs_plain(dev, config):
    import torch

    from dust_tpu_torch.experiments import draw_stack_arrays
    from dust_tpu_torch.ops.bandwidth import silvermans_rule

    arrays = draw_stack_arrays(
        config, torch.Generator(device=dev).manual_seed(SEED + 3), "dust",
        dev)
    k_stack, k_harness = _kernel_harness(config, arrays, dev, True,
                                         COMPARE_STEPS)
    p_stack, p_harness = _kernel_harness(config, arrays, dev, False,
                                         COMPARE_STEPS)
    k_step = k_harness.step_fn(k_stack.dynamics_prior)
    p_step = p_harness.step_fn(p_stack.dynamics_prior)
    true = {"length": torch.tensor(1.0, device=dev),
            "mass": torch.tensor(1.0, device=dev)}

    obs = arrays["init_state"].reshape(1, -1)
    dstate = k_stack.controller.init_state(arrays["init_policies"])
    svstate = k_stack.svmpc.init_state(arrays["init_policies"],
                                       k_stack.policies_prior)
    # a scalar initial prior bandwidth: K2 reads an isotropic prior, the
    # autograd MPF the exact (possibly per-dim) one
    mstate = k_stack.mpf.init_state(arrays["mpf_init"], obs[0], 1,
                                    bw=silvermans_rule(arrays["mpf_init"]))
    k_gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    p_gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    k_carry = (k_gen, obs, dstate, svstate, mstate)
    actions, particles = [], []
    for t in range(COMPARE_STEPS):
        # the plain side starts every step from the kernel side's state
        p_carry = (p_gen,) + k_carry[1:]
        k_carry, k_log = k_step(k_carry, t, true)
        p_carry, p_log = p_step(p_carry, t, true)
        actions.append((k_log[1], p_log[1]))
        particles.append((k_log[5], p_log[5]))
    worst = 0.0
    for name, pairs in (("action", actions), ("MPF particles", particles)):
        got = torch.stack([p[0] for p in pairs])
        want = torch.stack([p[1] for p in pairs])
        worst = max(worst,
                    _check_close(f"kernel vs plain path, {name}, steps 0-4",
                                 got[:5], want[:5], **EARLY_TOL))
        worst = max(worst,
                    _check_close(f"kernel vs plain path, {name}, "
                                 f"{COMPARE_STEPS} steps", got, want,
                                 **RUN_TOL))
    return worst


def phase_timing(dev):
    import torch

    from dust_tpu_torch.ops import mpf, rollout

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    s0, acts, lens, masses = _k1_inputs(8, 128, 3, 30, (3.0, 0.0), gen, dev)
    inp = _k2_inputs(50, (2.9, 0.4), (2.95, 0.9), 1.3, gen, dev)
    scal = mpf._scalars(inp["x"], inp["past_obs"], inp["loc"],
                        inp["action"], inp["bw"], inp["prior_bw"],
                        inp["lr"], inp["obs_sigma"])
    k1 = lambda: rollout.fused_pendulum_rollout_costs(s0, acts, lens, masses)
    k1_plain = lambda: rollout.pendulum_rollout_costs_plain(s0, acts, lens,
                                                            masses)
    k2 = lambda: mpf.fused_pendulum_mpf_optimize(**inp, n_steps=20)
    k2_plain = lambda: mpf.pendulum_mpf_optimize_plain(
        inp["x"], inp["prior_locs"], scal, n_steps=20, lanes=mpf.ROW_LANES)
    out = {}
    # plain, kernel, kernel, plain: one card, one call
    for name, kern, plain, bound in (
            ("pendulum_rollout_costs", k1, k1_plain, _k1_bound(8, 128, 3, 30)),
            ("pendulum_mpf_optimize", k2, k2_plain, _k2_bound(50, 20))):
        runs = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            fn = kern if which == "kernel" else plain
            runs[which].append({"device_ms": _device_ms(fn),
                                "call_ms": _call_ms(fn)})
        k_dev = [r["device_ms"] for r in runs["kernel"]]
        p_dev = [r["device_ms"] for r in runs["plain"]]
        out[name] = {"ms": min(k_dev), "plain_ms": min(p_dev),
                     "runs": runs, "bound_ms": bound[0],
                     "bound_by": bound[1], "bound_bytes": bound[2],
                     "bound_ops": bound[3]}
        k_call = [r["call_ms"] for r in runs["kernel"]]
        p_call = [r["call_ms"] for r in runs["plain"]]
        print(f"time {name}: kernel device {_fmt(k_dev)} ms, per call "
              f"{_fmt(k_call)} ms; plain device {_fmt(p_dev)} ms, per call "
              f"{_fmt(p_call)} ms; bound {bound[0]:.2e} ms ({bound[1]})")
    out["pendulum_rollout_costs"]["hook"] = _k1_hook_timing(s0, acts, lens,
                                                            masses)
    # never on a timed path: the clock's marks add barriers
    out["pendulum_mpf_optimize"]["phase_clock"] = _phase_clock(
        "K2 (path 1)", k2, mpf.phase_clock, steps=1, calls=20, per="call")
    return out


def _k1_hook_call(s0, acts, lens, masses):
    """One call of path 1's MultiDisco hook
    (`make_fused_pendulum_state_costs`), as a thunk, on its arguments as
    `MultiDisco.forward` passes them: the state [1, 2],
    the actions, and the draws as stride-2 columns [n_params, 1, 1, 1] of
    an [n_params, 2] draw array (`MultiDisco._sample_params`)."""
    import torch

    from dust_tpu_torch.models import PendulumModel
    from dust_tpu_torch.ops import rollout

    draws = torch.stack([lens, masses], dim=1)
    n = draws.shape[0]
    params = {k: draws[:, i].reshape(n, 1, 1, 1)
              for i, k in enumerate(("length", "mass"))}
    hook = rollout.make_fused_pendulum_state_costs(PendulumModel())
    state = s0.reshape(1, 2)
    return lambda: hook(state, acts, params)


def _device_ops(fn, calls=20):
    """Device operations (kernels, copies, fills) per call of fn, counted
    by torch.profiler over `calls` calls: (ops per call, {name: per
    call})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ops = {e.key: e.count / calls for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)}
    return sum(ops.values()), ops


def _k1_hook_timing(s0, acts, lens, masses):
    """Path 1's MultiDisco hook at the main-path shapes: its device ms per
    call (20 calls in one CUDA graph), ms per call as the path pays it,
    its device operations per call (torch.profiler: one, K1), beside its
    bound (the draw mean in place of the costs); then 20 more calls under
    K1's clocked build."""
    from dust_tpu_torch.ops import rollout

    hook = _k1_hook_call(s0, acts, lens, masses)
    n_ops, names = _device_ops(hook)
    print(f"K1 hook (path 1) device operations per call: {n_ops:g} "
          f"{names}")
    if n_ops != 1:
        raise AssertionError(
            f"K1 hook: {n_ops:g} device operations per call, expected one")
    bound = _k1_bound(8, 128, 3, 30, mean=True)
    dev_ms = [_device_ms(hook) for _ in range(2)]
    call_ms = [_call_ms(hook) for _ in range(2)]
    print(f"time K1 hook (path 1): device {_fmt(dev_ms)} ms, per call "
          f"{_fmt(call_ms)} ms; bound {bound[0]:.2e} ms ({bound[1]})")
    return {"ms": min(dev_ms), "call_ms": min(call_ms),
            "device_ops_per_call": n_ops, "device_ops": names,
            "bound_ms": bound[0], "bound_by": bound[1],
            "phase_clock": _phase_clock("K1 (path 1)", hook,
                                        rollout.phase_clock, steps=1,
                                        calls=20, per="call")}


# -- slice 2: the whole solve (K3), the whole episode (K4), sweeps (K5) ------

def _solve_ops(n_params, m, n_act, hz, episode=False):
    """Float32 operations of one solve as K3's code does them: per
    trajectory and rollout step 34 (cost 6, dynamics 7, angle 1, the
    rotation polynomials 13, the rotation 6) plus 10 per trajectory
    (terminal cost 6, coefficients 4); per (particle, sample, step) the
    action clamp (2; 4 with the episode's theta + sigma eps) and the
    delta / likelihood sums (5; 4 in the episode's eps form); per
    (particle, sample) the param average and the softmaxes (n_params + 14);
    the Stein step and forward: 6 per particle pair and step for each of
    the three squared distances, 8 per pair and step for the score and
    kernel sums, 8 per particle and step."""
    ops = n_params * m * n_act * (34 * hz + 10)
    ops += m * n_act * hz * ((4 + 4) if episode else (2 + 5))
    ops += m * n_act * (n_params + 14)
    ops += 3 * m * m * hz * 6 + m * m * hz * 8 + m * hz * 8
    return ops


def _k3_bound(n_params, m, n_act, hz):
    """Inputs read once (scalars 8, theta/locs/a_mat, log_mix, a_seq, the
    actions, lengths/masses), outputs written once (theta_opt/theta_fwd/
    a_mat, a_mix, a_seq_sel, weights, costs); operations `_solve_ops`."""
    nbytes = 4 * (8 + 3 * m * hz + m + hz + n_act * m * hz + 2 * n_params
                  + 3 * m * hz + 2 * m + hz + n_act * m)
    return _bound(nbytes, _solve_ops(n_params, m, n_act, hz))


def _episode_ops(steps, n_params, m, n_act, hz, m_mpf, mpf_steps):
    """Float32 and integer operations of one device-RNG episode as K4's
    code does them, per step: the solve (`_solve_ops`, episode form); the
    noise, 48 per normal (two uniforms of two 8-op hashes and 4 more each,
    Box-Muller 8) for hz*m*n_act + 2*n_params normals and 20 per uniform
    for n_params; the two Silverman bandwidths, 2 compares per value pair
    (rank counts) and 4 per value; the MPF loop as `_k2_bound` counts it;
    the draws (8 per draw) and the simulator (20)."""
    n_sv, n_mpf = m * hz, 2 * m_mpf
    per_step = (_solve_ops(n_params, m, n_act, hz, episode=True)
                + 48 * (hz * m * n_act + 2 * n_params) + 20 * n_params
                + 2 * (n_sv * n_sv + n_mpf * n_mpf) + 4 * (n_sv + n_mpf)
                + mpf_steps * (28 * m_mpf * m_mpf + 57 * m_mpf)
                + 8 * n_params + 20)
    return steps * per_step


def _episodes_bound(episodes, steps, n_params, m, n_act, hz, m_mpf,
                    mpf_steps):
    """K4 (episodes = 1) and K5 in device-RNG mode: per episode the inputs
    read once (shared scalars 12, true parameters 2, seeds 3,
    theta0/locs0/a_mat0, the MPF particles) and the outputs written once
    (6 log values per step, theta/locs/a_mat, the MPF particles);
    operations `_episode_ops`. The per-step noise scratch is neither an
    input nor an output."""
    nbytes = 4 * episodes * (17 + 3 * m * hz + 2 * m_mpf
                             + 6 * steps + 3 * m * hz + 2 * m_mpf)
    ops = episodes * _episode_ops(steps, n_params, m, n_act, hz, m_mpf,
                                  mpf_steps)
    return _bound(nbytes, ops)


def _k3_inputs(hz, m, n_params, n_act, state0, gen, dev, alpha=1.0,
               temp=1.0):
    """K3's arguments, seeded: at alpha = temp = 1 the DISCO and likelihood
    weights are peaked (one sample dominates a row); alpha = 1e-3, temp =
    1e3 spread them over many samples."""
    import torch

    theta = 0.5 * torch.randn((m, hz), generator=gen, device=dev)
    return (
        torch.tensor(state0, device=dev), theta,
        theta + 0.1 * torch.randn((m, hz), generator=gen, device=dev),
        torch.full((m,), -float(np.log(m)), device=dev),
        torch.randn((m, hz), generator=gen, device=dev),
        0.1 * torch.randn((hz,), generator=gen, device=dev),
        # 2.5-sigma torques around the particles: many beyond the clamp
        theta[None] + 2.5 * torch.randn((n_act, m, hz), generator=gen,
                                        device=dev),
        0.6 + 0.7 * torch.rand((n_params,), generator=gen, device=dev),
        0.6 + 0.7 * torch.rand((n_params,), generator=gen, device=dev),
        # bw, lr, alpha, temp, ctrl_sigma, prior_sigma as device tensors
        # (a CUDA graph capture takes no host-to-device copy)
        *(torch.tensor(v, device=dev) for v in (0.3, 2.0, alpha, temp, 2.0,
                                                2.0)),
    )


def _k3_plain(args, **statics):
    from dust_tpu_torch.ops import solve

    (state0, theta, locs, log_mix, a_mat, a_seq, actions, lengths, masses,
     bw, lr, alpha, temp, ctrl_sigma, prior_sigma) = args
    scal = solve._solve_scal(state0, bw, lr, alpha, temp, ctrl_sigma,
                             prior_sigma, theta.device, dim_s=2)
    return solve.pendulum_solve_plain(
        scal, theta, locs, log_mix, a_mat, a_seq, actions, lengths, masses,
        dt=statics.get("dt", 0.05), g=statics.get("g", 9.8),
        exp_util=statics["exp_util"])


_K3_OUTS = ("theta_opt", "theta_fwd", "a_mat", "a_mix", "a_seq_sel",
            "weights", "costs")


def phase_k3(dev):
    """K3 against its plain version: the demo's shapes (both utilities),
    an odd shape near the speed clamp, the cluster's extremes (m = 1 and
    8), and soft weights at m = 3 and 8, where many samples carry weight
    in every lane's partial sum of the delta and the likelihood gradient."""
    import torch

    from dust_tpu_torch.ops import solve

    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    worst = 0.0
    peaked, soft = (1.0, 1.0), (1e-3, 1e3)
    for label, (hz, m, n_params, n_act), state0, exp_util, (alpha, temp) in (
            ("main 8x3x128 H30", (30, 3, 8, 128), (3.0, 0.0), True, peaked),
            ("main 8x3x128 H30 ExpectedCost", (30, 3, 8, 128), (3.0, 0.0),
             False, peaked),
            ("odd 3x2x7 H11 near speed clamp", (11, 2, 3, 7), (0.2, 7.9),
             True, peaked),
            # the cluster's extremes: one block, and eight
            ("m1 8x1x128 H30", (30, 1, 8, 128), (3.0, 0.0), True, peaked),
            ("m8 8x8x128 H30", (30, 8, 8, 128), (3.0, 0.0), True, peaked),
            ("m3 8x3x128 H30 soft weights", (30, 3, 8, 128), (3.0, 0.0),
             True, soft),
            ("m8 8x8x128 H30 soft weights", (30, 8, 8, 128), (3.0, 0.0),
             True, soft)):
        args = _k3_inputs(hz, m, n_params, n_act, state0, gen, dev,
                          alpha=alpha, temp=temp)
        statics = dict(hz=hz, m=m, n_params=n_params, n_act=n_act,
                       exp_util=exp_util)
        got = solve.fused_pendulum_solve(*args, **statics)
        torch.cuda.synchronize()
        want = _k3_plain(args, **statics)
        if (alpha, temp) == soft:
            omega, _, w_lik, _ = solve.disco_weights(
                want[6].T[None], 1.0 / temp, alpha, exp_util)
            top = max(omega.max().item(), w_lik.max().item())
            if not top < 0.5:
                raise AssertionError(
                    f"K3 {label}: the weights are peaked (max {top})")
        for name, g, w in zip(_K3_OUTS, got, want):
            worst = max(worst, _check_close(f"K3 {label} {name}", g, w,
                                            **K3_TOL))
    return worst


def phase_k3_vs_plain(dev, config):
    """The K3 path (FusedPendulumSVMPC + FusedPendulumMPF) against the
    plain path (SVMPC rollout loop + autograd MPF) for COMPARE_STEPS steps
    from the same arrays and generator seed; the plain side starts every
    step from the K3 side's state."""
    import torch

    from dust_tpu_torch.experiments import draw_stack_arrays
    from dust_tpu_torch.inference import SVMPCState
    from dust_tpu_torch.ops.bandwidth import silvermans_rule

    arrays = draw_stack_arrays(
        config, torch.Generator(device=dev).manual_seed(SEED + 7), "dust",
        dev)
    k_stack, k_harness = _kernel_harness(config, arrays, dev, True,
                                         COMPARE_STEPS, fused_solve=True)
    p_stack, p_harness = _kernel_harness(config, arrays, dev, False,
                                         COMPARE_STEPS)
    k_step = k_harness.step_fn(k_stack.dynamics_prior)
    p_step = p_harness.step_fn(p_stack.dynamics_prior)
    true = {"length": torch.tensor(1.0, device=dev),
            "mass": torch.tensor(1.0, device=dev)}
    obs = arrays["init_state"].reshape(1, -1)
    k_carry = (torch.Generator(device=dev).manual_seed(SEED + 8), obs,
               k_stack.controller.init_state(arrays["init_policies"]),
               k_stack.svmpc.init_state(arrays["init_policies"],
                                        k_stack.policies_prior),
               k_stack.mpf.init_state(arrays["mpf_init"], obs[0], 1,
                                      bw=silvermans_rule(arrays["mpf_init"])))
    p_gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    actions, particles = [], []
    for t in range(COMPARE_STEPS):
        sv = k_carry[3]
        p_carry = (p_gen, k_carry[1], k_carry[2],
                   SVMPCState(theta=sv.theta, prior=sv.prior,
                              prior_updated=t > 0), k_carry[4])
        k_carry, k_log = k_step(k_carry, t, true)
        p_carry, p_log = p_step(p_carry, t, true)
        actions.append((k_log[1], p_log[1]))
        particles.append((k_log[5], p_log[5]))
    worst = 0.0
    for name, pairs in (("action", actions), ("MPF particles", particles)):
        got = torch.stack([p[0] for p in pairs])
        want = torch.stack([p[1] for p in pairs])
        worst = max(worst, _check_close(
            f"K3 path vs plain path, {name}, steps 0-4", got[:5], want[:5],
            **EARLY_TOL))
        worst = max(worst, _check_close(
            f"K3 path vs plain path, {name}, {COMPARE_STEPS} steps", got,
            want, **RUN_TOL))
    return worst


# the demo configuration's episode shapes and scalars
_EP = dict(hz=30, m=3, n_params=8, n_act=128, m_mpf=50, mpf_steps=20)
# ctrl_sigma, lr, alpha, temp, prior_sigma, mpf_lr, mpf_sigma
_EP_SCALARS = (2.0, 2.0, 1.0, 1.0, 2.0, 1e-3, 0.1)
_PRIOR_BW0 = 0.05


def _episode_setup(steps, seed, dev, n_sc=None, chains=None):
    """Demo-width episode inputs from a numpy seed: theta0 [3, 30], MPF
    particles [50, 2], and host noise in the JAX layouts (single episode,
    or a sweep's [chains, steps, hz, smp, 128] / [chains, steps, n_sc, 8,
    128])."""
    import torch

    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    hz, m = _EP["hz"], _EP["m"]
    theta0 = t(0.3 * rng.normal(size=(m, hz)))
    mpfx0 = t(np.stack([1.0 + 0.1 * rng.normal(size=50),
                        1.0 + 0.1 * rng.normal(size=50)], 1))
    if n_sc is None:
        noise = (t(rng.normal(size=(steps, hz, 8, 128))),
                 t(rng.normal(size=(steps, 8, 128))),
                 t(rng.uniform(size=(steps, 8, 128))))
    else:
        smp = -(-n_sc * m // 8) * 8
        noise = (t(rng.normal(size=(chains, steps, hz, smp, 128))),
                 t(rng.normal(size=(chains, steps, n_sc, 8, 128))),
                 t(rng.uniform(size=(chains, steps, n_sc, 8, 128))))
    return theta0, mpfx0, noise


def _episode_args(theta0, mpfx0, dev, length=1.0, mass=1.0):
    import torch

    z = lambda *shape: torch.zeros(shape, device=dev)
    return (torch.tensor([np.pi, 0.0], device=dev), theta0, theta0,
            z(_EP["m"], _EP["hz"]), z(_EP["hz"]), mpfx0, _PRIOR_BW0, length,
            mass, *_EP_SCALARS)


def _stack_episode_args(stack):
    """The arguments the megakernel adapters pass for a built stack
    (`simulation.megakernel_pendulum_episode_fn`), true parameters 1.0."""
    mstate = stack.mpf.init_state(stack.mpf_init, stack.init_state, 1)
    dstate = stack.controller.init_state(stack.init_policies)
    return (stack.init_state, stack.init_policies[..., 0],
            stack.policies_prior.locs[..., 0], dstate.a_mat[..., 0],
            dstate.a_seq[..., 0], stack.mpf_init, mstate.prior_bw, 1.0, 1.0,
            *_EP_SCALARS)


def _check_episode(label, got, want, fields=None):
    worst = 0.0
    for k in fields or (K4_FIELDS + ("theta", "a_mat", "mpf_x")):
        tol = K4_TOLS.get(k, K4_TOLS["theta"])
        worst = max(worst, _check_close(f"{label} {k}", got[k], want[k],
                                        rtol=0.0, atol=tol))
    return worst


def _composition(theta0, mpfx0, noise, steps, dev):
    """The episode as a host loop over the K3 and K2 kernels with the same
    noise (`tests/test_pallas_episode.py:_reference_composition`)."""
    import torch

    from dust_tpu_torch.ops.bandwidth import silvermans_rule
    from dust_tpu_torch.ops.mpf import fused_pendulum_mpf_optimize
    from dust_tpu_torch.ops.solve import fused_pendulum_solve

    eps, pdz, pdu = noise
    hz, m, n_params, n_act, m_mpf = (_EP[k] for k in (
        "hz", "m", "n_params", "n_act", "m_mpf"))
    theta = locs = theta0
    amat = torch.zeros((m, hz), device=dev)
    aseq = torch.zeros(hz, device=dev)
    x, pbw = mpfx0, torch.tensor(_PRIOR_BW0, device=dev)
    obs = torch.tensor([np.pi, 0.0], device=dev)
    log_mix = torch.full((m,), -float(np.log(m)), device=dev)
    logs = {k: [] for k in K4_FIELDS}
    for t in range(steps):
        bw_sv = silvermans_rule(theta)
        actions = theta[None] + 2.0 * eps[t, :, :m, :n_act].permute(2, 1, 0)
        idx = torch.clamp(torch.floor(pdu[t, :n_params, 0] * m_mpf),
                          max=m_mpf - 1).long()
        draws = x[idx] + pbw * pdz[t, :n_params, 0:2]
        _, theta_fwd, amat, _, a_sel, _, _ = fused_pendulum_solve(
            obs, theta, locs, log_mix, amat, aseq, actions, draws[:, 0],
            draws[:, 1], bw_sv, 2.0, 1.0, 1.0, 2.0, 2.0, hz=hz, m=m,
            n_params=n_params, n_act=n_act)
        # warm_up 0: every step commits the forward pass
        theta, locs, action = theta_fwd, theta_fwd, a_sel[0]
        a_cl = torch.clamp(action, -2.0, 2.0)
        om2 = torch.clamp(obs[1] + (-15.0 * torch.sin(obs[0] + np.pi)
                                    + 3.0 * a_cl) * 0.05, -8.0, 8.0)
        th2 = obs[0] + om2 * 0.05
        new_obs = torch.stack([th2, om2])
        bw_mpf = silvermans_rule(x)
        x = fused_pendulum_mpf_optimize(x, x, obs, new_obs, action[None],
                                        bw_mpf, pbw, 1e-3, 0.1, n_steps=20)
        pbw, obs = bw_mpf, new_obs
        for k, v in zip(K4_FIELDS, (th2, om2, action,
                                    50.0 * (torch.cos(th2) - 1.0) ** 2
                                    + om2 * om2, bw_sv, bw_mpf)):
            logs[k].append(v)
    out = {k: torch.stack(v) for k, v in logs.items()}
    out.update(theta=theta, a_mat=amat, mpf_x=x)
    return out


def phase_k4(dev):
    import torch

    from dust_tpu_torch.ops import episode

    worst = 0.0
    for steps in (1, 3):
        theta0, mpfx0, noise = _episode_setup(steps, SEED + 9 + steps, dev)
        args = _episode_args(theta0, mpfx0, dev)
        nz = dict(host_eps=noise[0], host_pdz=noise[1], host_pdu=noise[2])
        got = episode.fused_pendulum_episode([0, 0], *args, steps=steps,
                                             **nz, **_EP)
        torch.cuda.synchronize()
        want = episode.plain_pendulum_episode([0, 0], *args, steps=steps,
                                              **nz, **_EP)
        worst = max(worst, _check_episode(
            f"K4 host noise {steps} steps", got, want))
        if steps == 3:
            _check_episode("K4 vs K3+K2 kernel composition", got,
                           _composition(theta0, mpfx0, noise, steps, dev))
            # the warm-up gate: 2 steps without a forward
            got = episode.fused_pendulum_episode(
                [0, 0], *args, steps=steps, warm_up=2, **nz, **_EP)
            want = episode.plain_pendulum_episode(
                [0, 0], *args, steps=steps, warm_up=2, **nz, **_EP)
            worst = max(worst, _check_episode(
                "K4 host noise 3 steps warm_up 2", got, want))
    theta0, mpfx0, _ = _episode_setup(2, SEED + 12, dev)
    args = _episode_args(theta0, mpfx0, dev)
    got = episode.fused_pendulum_episode([3, 7], *args, steps=2, **_EP)
    torch.cuda.synchronize()
    want = episode.plain_pendulum_episode([3, 7], *args, steps=2, **_EP)
    worst = max(worst, _check_episode("K4 device RNG 2 steps", got, want))
    return worst


def phase_episode_path(dev, config):
    """Path 3: one MAIN_STEPS-step episode of the demo stack in one K4
    launch, through `megakernel_pendulum_episode_fn`."""
    import torch

    from dust_tpu_torch.experiments import build_pendulum_stack
    from dust_tpu_torch.simulation import megakernel_pendulum_episode_fn

    cfg = copy.deepcopy(config)
    stack = build_pendulum_stack(
        cfg, torch.Generator(device=dev).manual_seed(SEED), case="dust",
        device=dev)
    episode = megakernel_pendulum_episode_fn(stack, cfg["exp_params"],
                                             steps=MAIN_STEPS)
    episode([SEED, 99])  # warm-up
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = episode([SEED, 1])
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = _counts()
    _check_counts("path 3 (K4 episode)", launches, {"pendulum_episode": 1})
    for k, v in out.items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"path 3: non-finite values in {k}")
    again = episode([SEED, 1])
    other = episode([SEED, 2])
    same = all(torch.equal(out[k], again[k]) for k in out)
    differs = not torch.equal(out["cost"], other["cost"])
    if not same or not differs:
        raise AssertionError(f"path 3: same seed gives the same bits: {same}"
                             f", another seed other results: {differs}")
    low = float(out["cost"][MAIN_STEPS // 2:].min())
    result = {"steps": MAIN_STEPS, "seconds": elapsed,
              "ms_per_episode": 1e3 * elapsed,
              "solves_per_s": MAIN_STEPS / elapsed,
              "min_cost_second_half": low, "launches": launches,
              "same_seed_same_bits": same, "other_seed_differs": differs}
    print(f"path 3 (K4 episode): {MAIN_STEPS} steps in one launch, "
          f"{result['ms_per_episode']:.3f} ms per episode "
          f"({result['solves_per_s']:.1f} solves/s), lowest cost in steps "
          f"{MAIN_STEPS // 2}-{MAIN_STEPS - 1}: {low:.4f}; launches "
          f"{launches}")
    _check_swingup("path 3 (K4 episode)", low)
    return result


def _sweep_call(fn, seed, theta0, mpfx0, lens, mass, dev, steps, n_sc,
                chains, noise=None, per_scenario_mpf=False):
    nz = {} if noise is None else dict(host_eps=noise[0], host_pdz=noise[1],
                                       host_pdu=noise[2])
    args = _episode_args(theta0, mpfx0, dev, lens, mass)
    args = args[:4] + args[5:]   # the sweep takes no a_seq
    return fn(seed, *args, n_sc=n_sc, steps=steps, n_chains=chains, **nz,
              **_EP)


def phase_k5(dev):
    """K5 against independent K4 launches (bit for bit), against its plain
    version in device-RNG mode, and scenario isolation under NaN."""
    import torch

    from dust_tpu_torch.ops import episode, sweep_episode

    n_sc, chains, steps = SWEEP_SC, SWEEP_CHAINS, 2
    theta0, mpfx0, noise = _episode_setup(steps, SEED + 13, dev, n_sc,
                                          chains)
    lens = torch.linspace(0.8, 1.2, n_sc, device=dev)
    mass = torch.linspace(0.9, 1.1, n_sc, device=dev)
    sweep = lambda **kw: _sweep_call(
        sweep_episode.fused_pendulum_sweep_episode, [1, 2], theta0,
        kw.get("mpfx0", mpfx0), kw.get("lens", lens), mass, dev, steps,
        n_sc, chains, noise)
    out = sweep()
    torch.cuda.synchronize()
    mismatches = 0
    for c in range(chains):
        for s in range(n_sc):
            eps_s = torch.zeros((steps, _EP["hz"], 8, 128), device=dev)
            eps_s[:, :, :_EP["m"]] = noise[0][c, :, :, 3 * s:3 * s + 3]
            ref = episode.fused_pendulum_episode(
                [0, 0], *_episode_args(theta0, mpfx0, dev, lens[s], mass[s]),
                steps=steps, host_eps=eps_s, host_pdz=noise[1][c, :, s],
                host_pdu=noise[2][c, :, s], **_EP)
            mismatches += sum(not torch.equal(out[k][c][:, s], ref[k])
                              for k in K4_FIELDS)
            mismatches += sum(not torch.equal(out[k][c][s], ref[k])
                              for k in ("theta", "locs", "a_mat", "mpf_x"))
    print(f"K5 vs {chains * n_sc} independent K4 launches ({n_sc} "
          f"scenarios x {chains} chains, {steps} steps): {mismatches} "
          f"fields differ in any bit")
    if mismatches:
        raise AssertionError("K5 differs from independent K4 launches")

    # NaN in one scenario's true length, then in its MPF particles
    others = [s for s in range(n_sc) if s != 1]
    lens_nan = lens.clone()
    lens_nan[1] = float("nan")
    per = mpfx0.expand(n_sc, -1, -1).clone()
    base_per = sweep(mpfx0=per)
    per_nan = per.clone()
    per_nan[1] = float("nan")
    for label, base, poisoned, field in (
            ("true length", out, sweep(lens=lens_nan), "th"),
            ("MPF particles", base_per, sweep(mpfx0=per_nan), "mpf_x")):
        leak = sum(
            not torch.equal(base[k][:, :, others] if k in K4_FIELDS
                            else base[k][:, others],
                            poisoned[k][:, :, others] if k in K4_FIELDS
                            else poisoned[k][:, others])
            for k in base)
        own = poisoned[field][:, :, 1] if field in K4_FIELDS \
            else poisoned[field][:, 1]
        print(f"K5 NaN in scenario 1's {label}: {leak} fields of the other "
              f"scenarios changed; scenario 1 finite: "
              f"{bool(torch.isfinite(own).all())}")
        if leak or torch.isfinite(own).all():
            raise AssertionError(f"K5 scenario isolation ({label})")

    # device-RNG mode against the plain version
    seeds = torch.tensor([[3, 7]], device=dev)
    got = _sweep_call(sweep_episode.fused_pendulum_sweep_groups, seeds,
                      theta0, mpfx0, lens, mass, dev, steps, n_sc, chains)
    torch.cuda.synchronize()
    want = _sweep_call(sweep_episode.plain_pendulum_sweep_groups, seeds,
                       theta0, mpfx0, lens, mass, dev, steps, n_sc, chains)
    return _check_episode(f"K5 device RNG {n_sc}x{chains} {steps} steps",
                          got, want)


def _bench_sweep(dev, config, steps=MAIN_STEPS):
    """bench.py's sweep on the demo stack: the MegakernelGroupSweep over
    `steps`-step episodes, the seeds of run i, the per-group true
    parameters, and plain(seeds): the sweep's plain version on the same
    inputs."""
    import torch

    from dust_tpu_torch.experiments import build_pendulum_stack
    from dust_tpu_torch.ops.sweep_episode import plain_pendulum_sweep_groups
    from dust_tpu_torch.parallel import MegakernelGroupSweep
    from dust_tpu_torch.simulation import megakernel_pendulum_sweep_fn

    cfg = copy.deepcopy(config)
    stack = build_pendulum_stack(
        cfg, torch.Generator(device=dev).manual_seed(SEED), case="dust",
        device=dev)
    sweep = megakernel_pendulum_sweep_fn(
        stack, cfg["exp_params"], steps=steps, n_sc=SWEEP_SC,
        n_chains=SWEEP_CHAINS)
    lens = torch.linspace(0.8, 1.2, SWEEP_SC, device=dev).expand(
        SWEEP_GROUPS, SWEEP_SC)
    mass = torch.linspace(0.9, 1.1, SWEEP_SC, device=dev).expand(
        SWEEP_GROUPS, SWEEP_SC)

    def seeds(i):   # bench.py:179-183
        return torch.stack([
            torch.full((SWEEP_GROUPS,), i, dtype=torch.int64, device=dev),
            torch.arange(SWEEP_GROUPS, device=dev) * 1000], dim=1)

    # the sweep adapter's arguments: no a_seq, per-group true parameters
    ep_args = _stack_episode_args(stack)
    sw_args = ep_args[:4] + ep_args[5:7] + (lens, mass) + ep_args[9:]

    def plain(seed_rows):
        return plain_pendulum_sweep_groups(
            seed_rows, *sw_args, n_sc=SWEEP_SC, steps=steps,
            n_chains=SWEEP_CHAINS, **_EP)

    return MegakernelGroupSweep(sweep), seeds, lens, mass, plain


def _sweep_layout_check(dev, config):
    """K5 at path 4's layout (G = 8 groups, per-group true parameters,
    chains derived from the seeds) against its plain version after 1 and
    2 steps, every field at K4's tolerances; and the 2-step launch against
    one G = 1 launch per group, bit for bit."""
    import torch

    label = f"K5 path-4 layout {SWEEP_GROUPS}x{SWEEP_SC}x{SWEEP_CHAINS}"
    worst = 0.0
    for steps in (1, 2):
        groups, seeds, lens, mass, plain = _bench_sweep(dev, config, steps)
        got = groups.run(seeds(1), lens, mass)
        torch.cuda.synchronize()
        worst = max(worst, _check_episode(
            f"{label} device RNG {steps} steps", got, plain(seeds(1))))
    mismatches = 0
    for g in range(SWEEP_GROUPS):
        one = groups.sweep_fn(seeds(1)[g], lens[g], mass[g])
        mismatches += sum(not torch.equal(got[k][g], one[k]) for k in got)
    print(f"{label} vs {SWEEP_GROUPS} launches of one group each (2 steps): "
          f"{mismatches} fields differ in any bit")
    if mismatches:
        raise AssertionError("K5 at G > 1 differs from per-group launches")
    return worst


def _sweep_vs_plain(low, out, want):
    """Path 4's episodes against the plain sweep on the same device-RNG
    draws over all MAIN_STEPS steps: where each pair drifts apart (the
    loop is chaotic, so ulp differences grow), how many episodes fail to
    swing up on either side, and the worst kernel episode's fate in the
    plain version."""
    import torch

    apart = (out["th"] - want["th"]).abs() > 1e-3      # [G, C, steps, n_sc]
    first = torch.where(apart.any(2), apart.int().argmax(2),
                        MAIN_STEPS).reshape(-1)
    low_plain = want["cost"][:, :, MAIN_STEPS // 2:].amin(dim=2).reshape(-1)
    w = int(low.argmax())
    g, c, s = np.unravel_index(w, (SWEEP_GROUPS, SWEEP_CHAINS, SWEEP_SC))
    return {
        "kernel_fail_swingup": int((low >= SWINGUP_MAX_COST).sum()),
        "plain_fail_swingup": int((low_plain >= SWINGUP_MAX_COST).sum()),
        "plain_median_min_cost_second_half": float(low_plain.median()),
        "first_step_apart_min": int(first.min()),
        "first_step_apart_median": float(first.float().median()),
        "episodes_apart_by_end": int((first < MAIN_STEPS).sum()),
        "worst": {"first_step_apart": int(first[w]),
                  "plain_min_cost_second_half": float(low_plain[w]),
                  "plain_final_cost": float(want["cost"][g, c, -1, s]),
                  "kernel_cost": out["cost"][g, c, :, s].tolist(),
                  "plain_cost": want["cost"][g, c, :, s].tolist()},
    }


def phase_sweep_path(dev, config):
    """Path 4: bench.py's sweep, 8 groups x 16 scenarios x 2 chains of
    MAIN_STEPS steps, in one K5 launch through MegakernelGroupSweep; then
    the same episodes in the plain version."""
    import torch

    layout_err = _sweep_layout_check(dev, config)
    groups, seeds, lens, mass, plain = _bench_sweep(dev, config)
    groups.run(seeds(0), lens, mass)  # warm-up
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = groups.run(seeds(1), lens, mass)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = _counts()
    _check_counts("path 4 (K5 sweep)", launches,
                  {"pendulum_sweep_episode": 1})
    episodes = SWEEP_GROUPS * SWEEP_SC * SWEEP_CHAINS
    cost = out["cost"]                       # [G, chains, steps, n_sc]
    if tuple(cost.shape) != (SWEEP_GROUPS, SWEEP_CHAINS, MAIN_STEPS,
                             SWEEP_SC):
        raise AssertionError(f"path 4: cost shape {tuple(cost.shape)}")
    for k, v in out.items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"path 4: non-finite values in {k}")
    low = cost[:, :, MAIN_STEPS // 2:].amin(dim=2).reshape(-1)
    # the episode that stays furthest from upright: (group, chain,
    # scenario) and its cost at the last step
    g, c, s = np.unravel_index(int(low.argmax()),
                               (SWEEP_GROUPS, SWEEP_CHAINS, SWEEP_SC))
    result = {"episodes": episodes, "steps": MAIN_STEPS, "seconds": elapsed,
              "solves_per_s": episodes * MAIN_STEPS / elapsed,
              "median_min_cost_second_half": float(low.median()),
              "max_min_cost_second_half": float(low.max()),
              "worst_episode": {"group": int(g), "chain": int(c),
                                "scenario": int(s),
                                "true_length": float(lens[g, s]),
                                "true_mass": float(mass[g, s]),
                                "final_cost": float(cost[g, c, -1, s])},
              "launches": launches, "layout_max_abs_err": layout_err}
    print(f"path 4 (K5 sweep): {episodes} episodes = {SWEEP_GROUPS} groups "
          f"x {SWEEP_SC} scenarios x {SWEEP_CHAINS} chains x {MAIN_STEPS} "
          f"steps in one launch, {elapsed:.4f} s, "
          f"{result['solves_per_s']:.1f} solves/s; median over episodes of "
          f"the lowest cost in steps {MAIN_STEPS // 2}-{MAIN_STEPS - 1}: "
          f"{result['median_min_cost_second_half']:.4f} (worst "
          f"{result['max_min_cost_second_half']:.4f}: {result['worst_episode']}"
          f"); launches {launches}")
    _check_swingup("path 4 (K5 sweep), median over episodes",
                   result["median_min_cost_second_half"])
    vs = _sweep_vs_plain(low, out, plain(seeds(1)))
    result["vs_plain"] = vs
    print(f"path 4 against the plain sweep on the same draws: episodes "
          f"failing swing-up (lowest cost in steps {MAIN_STEPS // 2}-"
          f"{MAIN_STEPS - 1} >= {SWINGUP_MAX_COST}) kernel "
          f"{vs['kernel_fail_swingup']}, plain {vs['plain_fail_swingup']} "
          f"of {episodes} (plain median "
          f"{vs['plain_median_min_cost_second_half']:.4f}); th drifts apart "
          f"by > 1e-3 first at step {vs['first_step_apart_min']} (median "
          f"{vs['first_step_apart_median']}, {vs['episodes_apart_by_end']} "
          f"episodes apart by the end); worst kernel episode: apart at step "
          f"{vs['worst']['first_step_apart']}, plain lowest cost "
          f"{vs['worst']['plain_min_cost_second_half']:.4f}, plain final "
          f"cost {vs['worst']['plain_final_cost']:.4f}")
    if vs["kernel_fail_swingup"] > episodes * SWEEP_MAX_FAIL_SHARE:
        raise AssertionError(
            f"path 4: {vs['kernel_fail_swingup']} of {episodes} episodes "
            f"fail to swing up (at most {SWEEP_MAX_FAIL_SHARE} of them may)")
    return result


def _event_ms(fn, reps):
    """Times of single calls between CUDA events (after one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def phase_timing_slice2(dev, config):
    """K3 as phase 6 times K1/K2; K4 and K5 (one launch per episode or
    sweep, tens of ms) as single calls between CUDA events, median of 3;
    their plain versions one call each (the device waits on the host
    issuing them). Plain, kernel, kernel, plain."""
    import torch

    from dust_tpu_torch.ops import episode, solve
    from dust_tpu_torch.simulation import megakernel_pendulum_episode_fn

    out = {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    args = _k3_inputs(30, 3, 8, 128, (3.0, 0.0), gen, dev)
    st = dict(hz=30, m=3, n_params=8, n_act=128, exp_util=True)
    k3 = lambda: solve.fused_pendulum_solve(*args, **st)
    k3_plain = lambda: _k3_plain(args, **st)
    runs = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        fn = k3 if which == "kernel" else k3_plain
        runs[which].append({"device_ms": _device_ms(fn),
                            "call_ms": _call_ms(fn)})
    bound = _k3_bound(8, 3, 128, 30)
    out["pendulum_solve"] = {
        "ms": min(r["device_ms"] for r in runs["kernel"]),
        "plain_ms": min(r["device_ms"] for r in runs["plain"]),
        "runs": runs, "bound_ms": bound[0], "bound_by": bound[1],
        "bound_bytes": bound[2], "bound_ops": bound[3],
        "timed_as": "device time per call, 20 calls in one CUDA graph",
        "phase_clock": _phase_clock("K3 (path 2)", k3,
                                    solve.pendulum_phase_clock, steps=1,
                                    calls=20, per="solve")}

    from dust_tpu_torch.experiments import build_pendulum_stack

    cfg = copy.deepcopy(config)
    stack = build_pendulum_stack(
        cfg, torch.Generator(device=dev).manual_seed(SEED), case="dust",
        device=dev)
    exp = cfg["exp_params"]
    ep_kernel = megakernel_pendulum_episode_fn(stack, exp, steps=MAIN_STEPS)
    ep_args = _stack_episode_args(stack)
    ep_plain = lambda: episode.plain_pendulum_episode(
        [SEED, 1], *ep_args, steps=MAIN_STEPS, **_EP)
    groups, seeds, lens, mass, sw_plain = _bench_sweep(dev, config)
    for name, label, kern, plain, bound in (
            ("pendulum_episode", "K4 (path 3)", lambda: ep_kernel([SEED, 1]),
             ep_plain, _episodes_bound(1, MAIN_STEPS, 8, 3, 128, 30, 50, 20)),
            ("pendulum_sweep_episode", "K5 (path 4)",
             lambda: groups.run(seeds(1), lens, mass),
             lambda: sw_plain(seeds(1)),
             _episodes_bound(SWEEP_GROUPS * SWEEP_SC * SWEEP_CHAINS,
                             MAIN_STEPS, 8, 3, 128, 30, 50, 20))):
        runs = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            if which == "kernel":
                runs[which].append(statistics.median(_event_ms(kern, 3)))
            else:
                runs[which].append(_event_ms(plain, 1)[0])
        out[name] = {"ms": min(runs["kernel"]),
                     "plain_ms": min(runs["plain"]), "runs": runs,
                     "bound_ms": bound[0], "bound_by": bound[1],
                     "bound_bytes": bound[2], "bound_ops": bound[3],
                     "timed_as": "one call between CUDA events",
                     "phase_clock": _phase_clock(label, kern,
                                                 episode.phase_clock)}
    for name, t in out.items():
        print(f"time {name}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms ({t['timed_as']}); bound "
              f"{t['bound_ms']:.2e} ms ({t['bound_by']})")
    return out


# -- slice 3: the particle-navigation task (K6, K7, K8, K9) -----------------

# the CPU tests' tolerances (tests/test_torch_particle_*.py): costs and
# weights at K1's, the MPF loop at K2's, the solve's particles and plans
# at K3's, the episode per field as tests/test_pallas_particle_episode.py
K6_TOL = K1_TOL
K7_TOL = K2_TOL
K8_COST_TOL = dict(rtol=1e-5, atol=1e-4)
K8_TOL = K3_TOL
K9_TOLS = {"state": dict(rtol=0.0, atol=1e-5),
           "action": dict(rtol=0.0, atol=1e-5),
           "cost": dict(rtol=1e-5, atol=0.0),
           "cum": dict(rtol=1e-5, atol=0.0),
           "bw_sv": dict(rtol=0.0, atol=1e-6),
           "bw_mpf": dict(rtol=0.0, atol=1e-6),
           "theta": dict(rtol=0.0, atol=1e-4),
           "a_mat": dict(rtol=0.0, atol=1e-3),
           "mpf_x": dict(rtol=0.0, atol=1e-5)}
# the demo's start (-9, -9) and target (9, 9): the start's distance
START_DIST = float(np.hypot(18.0, 18.0))
# a stalled solve fails: the particle must get this much nearer the
# target before any termination
MIN_ADVANCE_M = 2.0


def _particle_stack(dev, **exp_over):
    import torch

    from dust_tpu_torch.experiments import (
        PARTICLE_DEMO_CONFIG,
        build_particle_stack,
    )

    cfg = copy.deepcopy(PARTICLE_DEMO_CONFIG)
    cfg["exp_params"].update(exp_over)
    stack = build_particle_stack(
        cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    return cfg, stack


def _pkw(model):
    """A Particle model's kernel configuration: dt, limits, statics."""
    from dust_tpu_torch.ops.particle_rollout import particle_kernel_statics

    return dict(dt=float(model.dt), max_acc=model.max_acc,
                max_speed=model.max_speed,
                **particle_kernel_statics(model))


def _particle_step_ops():
    """Float32 and integer operations of one trajectory step as
    particle.cuh does it: occupancy 20 (two scaled floors, four clamp
    compares, two NaN tests, the cell index, the bit lookup); the state
    cost 17, the control cost 6, the accelerations 6, the freeze factor 2,
    the position 4, the velocity 8. The terminal cost: occupancy and 17."""
    return 63, 37


def _k6_bound(n_params, n_act, n_pol, hz, n_model):
    """Inputs read once (the model array of n_model floats, state0, the
    actions, masses), costs written once; operations `_particle_step_ops`
    per trajectory step and the terminal cost, 1/mass per draw."""
    n = n_params * n_act * n_pol
    step, term = _particle_step_ops()
    nbytes = 4 * (n_model + 4 + n_act * n_pol * hz * 2 + n_params + n)
    return _bound(nbytes, n * (hz * step + term) + n_params)


def _k7_ops(m, n_steps):
    """Per iteration: per particle the likelihood gradient (~36 with the
    log-space exp and factor) and the update (~8); per particle pair the
    prior score 14 (distance and scale twice, max, shift, exp, two sums)
    and the RBF drive 8."""
    return n_steps * (22 * m * m + 44 * m)


def _k7_bound(m, n_steps):
    """x and centers [m] and 11 scalars read once, x [m] written once."""
    return _bound(4 * (3 * m + 11), _k7_ops(m, n_steps))


def _particle_solve_ops(n_params, m, n_act, hz, episode=False):
    """One particle solve as K8's code does it: every rollout
    (`_particle_step_ops`), the param average and the softmaxes
    (n_params + 14 per pair), the delta and likelihood sums (5 per
    (particle, sample, value); 7 in the episode, which forms each action
    from theta + sigma eps), the Stein step and forward as `_solve_ops`
    counts them on rows of hz * 2 values."""
    ev = 2 * hz
    step, term = _particle_step_ops()
    ops = n_params * m * n_act * (hz * step + term)
    ops += m * n_act * (n_params + 14)
    ops += m * n_act * ev * (7 if episode else 5)
    ops += 3 * m * m * ev * 6 + m * m * ev * 8 + m * ev * 8
    return ops


def _k8_bound(n_params, m, n_act, hz, n_model):
    """Inputs read once (model, 10 scalars, theta/locs/a_mat, log_mix,
    a_seq, the actions, masses), outputs written once (theta_opt,
    theta_fwd, a_mat, a_mix, a_seq_sel, weights, costs)."""
    ev = 2 * hz
    nbytes = 4 * (n_model + 10 + 3 * m * ev + m + ev + n_act * m * ev
                  + n_params + 3 * m * ev + 2 * m + ev + n_act * m)
    return _bound(nbytes, _particle_solve_ops(n_params, m, n_act, hz))


def _k9_bound(steps, mpf_updates, n_params, m, n_act, hz, m_mpf, mpf_steps,
              n_model, episodes=1, log_mix=False):
    """`episodes` device-RNG episodes: per episode and step the solve
    (episode form), the noise (48 per normal for 2 hz m n_act + n_params
    normals, 20 per uniform), the Silverman rank count over the m hz 2
    policy values (2 compares per value pair, 4 per value), the draws (8
    each), the simulator, cost and termination (~80); the MPF loop on the
    `mpf_updates` steps that ran it, over all episodes (`_k7_ops`). Bytes:
    per episode the inputs read once (model, 15 scalars, base mass, seeds,
    log-weights, theta/locs/a_mat, a_seq, the MPF particles) and the
    outputs written once (12 log values per step, theta/locs/a_mat, the
    MPF particles, with `log_mix` the final log-weights)."""
    ev = 2 * hz
    n_sv = m * ev
    n_normals = 2 * hz * m * n_act + n_params
    per_step = (_particle_solve_ops(n_params, m, n_act, hz, episode=True)
                + 48 * n_normals + 20 * n_params
                + 2 * n_sv * n_sv + 4 * n_sv + 8 * n_params + 80)
    ops = (episodes * steps * per_step
           + mpf_updates * _k7_ops(m_mpf, mpf_steps))
    nbytes = episodes * 4 * (n_model + 15 + 1 + 3 + m + 3 * m * ev + ev
                             + m_mpf + 12 * steps + 3 * m * ev + m_mpf
                             + (m if log_mix else 0))
    return _bound(nbytes, ops)


def phase_k6(dev):
    """K6 against its plain version, bit for bit, at the demo shapes from a
    free start, a start inside an obstacle and one inside a wall, and at a
    shape with a part-filled block and more draws than a block takes; and
    the kernels' occupancy test against `occupancy_hit` on every cell of the clamped
    domain (cell centers, cell edges, a hair either side), and against the
    raster, exactly."""
    import torch

    from dust_tpu_torch.ops import particle_rollout as pr

    _, stack = _particle_stack(dev)
    model = stack.model
    kw = _pkw(model)
    om = model.obst_map
    nx, ny = om.map.shape
    xi, yi = torch.meshgrid(torch.arange(nx, dtype=torch.float32, device=dev),
                            torch.arange(ny, dtype=torch.float32, device=dev),
                            indexing="ij")
    cells = torch.stack([xi, yi], -1).reshape(-1, 2)
    off = torch.tensor(om.c_offset, device=dev)
    edges = (cells - off) * om.cell_size
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    outside = 15.0 * (2.0 * torch.rand((4096, 2), generator=gen,
                                       device=dev) - 1.0)
    centers = (cells + 0.5 - off) * om.cell_size
    pts = torch.cat([centers, edges, edges + 1e-6, edges - 1e-6, outside])
    got = pr.particle_occupancy_probe(pts, rects=kw["rects"], grid=kw["grid"])
    torch.cuda.synchronize()
    want = pr.occupancy(pts[:, 0], pts[:, 1], kw["rects"], kw["grid"])
    mismatches = int((got != want).sum())
    raster = torch.tensor(om.map, device=dev).reshape(-1)
    raster_mismatches = int((got[:nx * ny] != raster).sum())
    print(f"K6 occupancy: {pts.shape[0]} points ({nx}x{ny} cells: centers, "
          f"edges, +-1e-6; 4096 beyond the map), {len(kw['rects'])} "
          f"rectangles: {mismatches} differ from occupancy_hit, "
          f"{raster_mismatches} cell centers differ from the raster; "
          f"{int(got.sum())} occupied")
    if mismatches or raster_mismatches:
        raise AssertionError("K6's occupancy test is not exact")
    errs = {}
    for label, start, (n_params, n_act, n_pol, hz) in (
            ("free start", (-9.0, -9.0), (4, 64, 6, 40)),
            ("start inside an obstacle", (2.0, 2.0), (4, 64, 6, 40)),
            ("start inside a wall", (10.95, 0.3), (4, 64, 6, 40)),
            # a part-filled block and draws over two grid rows
            ("free start, 9 draws", (-9.0, -9.0), (9, 7, 5, 13))):
        s0 = torch.tensor([*start, 0.8, 1.2], device=dev)
        actions = 12.0 * torch.randn((n_act, n_pol, hz, 2), generator=gen,
                                     device=dev)
        masses = 1.5 + 1.5 * torch.rand((n_params,), generator=gen,
                                        device=dev)
        got = pr.fused_particle_rollout_costs(s0, actions, masses, **kw)
        torch.cuda.synchronize()
        want = pr.particle_rollout_costs_plain(s0, actions, masses, **kw)
        name = f"K6 {n_params}x{n_act}x{n_pol} H{hz} {label}"
        errs[label] = _check_close(name, got, want, **K6_TOL)
        # the same arithmetic in the same order (--fmad=false): the bits
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: not bit-equal to plain")
        print(f"{name}: bit-equal to plain")
    return max(errs.values()), {"points": int(pts.shape[0]),
                                "mismatches": mismatches,
                                "raster_mismatches": raster_mismatches}


def _k7_inputs(gen, dev, log_space, v0, action, scale, m=50):
    import torch

    x = 1.6 + 0.8 * torch.rand((m, 1), generator=gen, device=dev)
    if log_space:
        x = torch.log(x)
    past = torch.tensor([-9.0, -9.0, *v0], device=dev)
    t = lambda v: torch.tensor(v, device=dev)
    return dict(
        x=x, prior_locs=x + 0.02 * torch.randn((m, 1), generator=gen,
                                               device=dev),
        past_obs=past, loc=past + t([0.01, -0.01, 0.1, -0.15]),
        action=t(action), scale=t(scale), bw=t(0.5), prior_bw=t(0.5),
        lr=t(1e-2), obs_sigma=t(0.1))


def _k7_plain(inp, log_space):
    from dust_tpu_torch.ops import particle_mpf as pm

    scal = pm.mpf_scalars(inp["x"], inp["past_obs"], inp["loc"],
                          inp["action"], inp["scale"], inp["bw"],
                          inp["prior_bw"], inp["lr"], inp["obs_sigma"])
    return pm.particle_mpf_optimize_plain(inp["x"], inp["prior_locs"], scal,
                                          n_steps=20, log_space=log_space)


def phase_k7(dev):
    """K7 against its plain version (sums in its order, a quad of lanes
    per row) at the demo's m = 50 (the register path) and at m = 200 (the
    general path): log and linear space, both clip gates, a crashed
    start, and lr and sigma given as Python numbers (path 5's way: read
    as values, the rest through their device addresses)."""
    import torch

    from dust_tpu_torch.ops import particle_mpf as pm

    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    errs = {}
    for m in (50, 200):
        for label, log_space, v0, action, scale in (
                ("log space", True, (0.4, -0.2), (3.0, -5.0), 0.015),
                ("linear", False, (0.4, -0.2), (3.0, -5.0), 0.015),
                ("acceleration clip", True, (0.4, -0.2), (25.0, -2.0),
                 0.015),
                ("speed clip", True, (4.96, -4.96), (9.0, -9.0), 0.015),
                ("crashed start", True, (0.4, -0.2), (3.0, -5.0), 0.0),
                ("numbers", True, (0.4, -0.2), (3.0, -5.0), 0.015)):
            inp = _k7_inputs(gen, dev, log_space, v0, action, scale, m=m)
            if label == "numbers":
                inp.update(lr=1e-2, obs_sigma=0.1)
            got = pm.fused_particle_mpf_optimize(**inp, n_steps=20,
                                                 log_space=log_space)
            torch.cuda.synchronize()
            want = _k7_plain(inp, log_space)
            if (want - inp["x"]).abs().max().item() < 1e-4:
                raise AssertionError(
                    f"K7 m{m} {label}: the particles did not move")
            errs[f"m{m} {label}"] = _check_close(
                f"K7 m{m} 20 steps {label}", got, want, **K7_TOL)
    return max(errs.values())


def _k8_inputs(gen, dev, start, hz=40, m=6, n_params=4, n_act=64):
    import torch

    r = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    theta = 3.0 * r(m, hz, 2)
    logits = r(m)
    return (
        torch.tensor([*start, 0.3, -0.2], device=dev), theta,
        theta + 0.5 * r(m, hz, 2), torch.log_softmax(logits, 0),
        r(m, hz, 2), 0.1 * r(hz, 2), theta[None] + 5.0 * r(n_act, m, hz, 2),
        1.7 + 0.7 * torch.rand((n_params,), generator=gen, device=dev),
        # bw, lr, alpha, temp, ctrl_sigma, prior_sigma as device tensors
        # (a CUDA graph capture takes no host-to-device copy)
        *(torch.tensor(v, device=dev) for v in (1.3, 100.0, 1.0, 1.0, 5.0,
                                                5.0)),
    )


_K8_STATICS = dict(hz=40, m=6, n_params=4, n_act=64)


def phase_k8(dev):
    import torch

    from dust_tpu_torch.ops import solve

    _, stack = _particle_stack(dev)
    kw = _pkw(stack.model)
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    worst = 0.0
    for label, start, exp_util in (
            ("free start", (-9.0, -9.0), True),
            ("free start ExpectedCost", (-9.0, -9.0), False),
            ("start inside an obstacle", (2.0, 2.0), True)):
        args = _k8_inputs(gen, dev, start)
        st = dict(_K8_STATICS, exp_util=exp_util, **kw)
        got = solve.fused_particle_solve(*args, **st)
        torch.cuda.synchronize()
        want = solve.plain_particle_solve(*args, **st)
        for name, g, w in zip(_K3_OUTS, got, want):
            tol = K8_COST_TOL if name in ("costs", "weights") else K8_TOL
            worst = max(worst, _check_close(
                f"K8 4x6x64 H40 {label} {name}", g, w, **tol))
    return worst


def _particle_noise(steps, seed, dev):
    """Host noise in the JAX layouts: eps [steps, 2, hz, 8, 128], pdz and
    pdu [steps, 8, 128], from a numpy seed."""
    import torch

    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    return (t(rng.normal(size=(steps, 2, 40, 8, 128))),
            t(rng.normal(size=(steps, 8, 128))),
            t(rng.uniform(size=(steps, 8, 128))))


def _particle_episode(fn, cfg, stack, steps, seed=(0, 0), noise=None,
                      warm_up=0, change_at=100, success_dist=1.0,
                      base_mass=None, **over):
    """`fn` (the K9 wrapper or its plain version) with the arguments the
    megakernel adapter passes for `stack`; `over` replaces its settings."""
    import torch

    exp = cfg["exp_params"]
    model = stack.model
    mstate = stack.mpf.init_state(stack.mpf_init, stack.init_state, 2,
                                  bw=stack.mpf_init_bw)
    dstate = stack.controller.init_state()
    nz = {} if noise is None else dict(host_eps=noise[0], host_pdz=noise[1],
                                       host_pdu=noise[2])
    settings = dict(
        success_dist=success_dist, exp_util=True,
        weighted_prior=exp["weighted_prior"],
        mpf_log_space=exp["mpf_log_space"], use_fixed_mpf_bw=True,
        mpf_bw_scale=exp["mpf_bandwidth_scaling"])
    settings.update(over)
    return fn(
        list(seed), stack.init_state, stack.init_policies,
        stack.policies_prior.locs,
        torch.log_softmax(stack.policies_prior.logits, 0), dstate.a_mat,
        dstate.a_seq, stack.mpf_init, mstate.prior_bw,
        model.params_dict["mass"] if base_mass is None else base_mass,
        stack.load, exp["ctrl_sigma"],
        exp["learning_rate"], exp["alpha"], 1.0 / exp["alpha"],
        exp["prior_sigma"], exp["mpf_learning_rate"], exp["mpf_obs_std"],
        stack.mpf_bw, steps=steps, warm_up=warm_up, hz=exp["horizon"],
        m=exp["n_particles"], n_params=exp["params_samples"],
        n_act=exp["action_samples"], m_mpf=exp["mpf_n_particles"],
        mpf_steps=exp["mpf_steps"], change_at=change_at, **settings, **nz,
        **_pkw(model))


def _check_particle_episode(label, got, want):
    worst = 0.0
    for k, tol in K9_TOLS.items():
        worst = max(worst, _check_close(f"{label} {k}", got[k], want[k],
                                        **tol))
    for k in ("done", "crashed"):
        if not bool((got[k] == want[k]).all()):
            raise AssertionError(f"{label} {k}: {got[k].tolist()} != "
                                 f"{want[k].tolist()}")
    return worst


def _particle_composition(cfg, stack, steps, noise, warm_up=0,
                          change_at=100):
    """The episode as a host loop over the K8 and K7 kernels with the
    same noise, the simulator, the termination masks and the
    weighted-prior refresh between them
    (`tests/test_pallas_particle_episode.py:_reference_composition`)."""
    import torch

    from dust_tpu_torch.ops.bandwidth import silvermans_rule
    from dust_tpu_torch.ops.particle_mpf import fused_particle_mpf_optimize
    from dust_tpu_torch.ops.solve import fused_particle_solve

    exp = cfg["exp_params"]
    eps, pdz, pdu = noise
    m, hz = exp["n_particles"], exp["horizon"]
    n_act, n_par, mm = (exp["action_samples"], exp["params_samples"],
                        exp["mpf_n_particles"])
    sig = float(exp["ctrl_sigma"])
    model = stack.model
    kw = _pkw(model)
    dev = stack.init_state.device
    mstate = stack.mpf.init_state(stack.mpf_init, stack.init_state, 2,
                                  bw=stack.mpf_init_bw)
    theta, locs = stack.init_policies, stack.policies_prior.locs
    logits = stack.policies_prior.logits
    dstate = stack.controller.init_state()
    amat, aseq = dstate.a_mat, dstate.a_seq
    x, pbw = stack.mpf_init, mstate.prior_bw
    lik_loc = state = stack.init_state
    done = False
    mass0 = float(model.params_dict["mass"])
    logs = {k: [] for k in ("state", "action", "cost", "bw_sv")}
    for t in range(steps):
        bw_sv = silvermans_rule(theta)
        acts = torch.stack([eps[t, c, :, :m, :n_act].permute(2, 1, 0)
                            for c in (0, 1)], dim=-1)
        idx = torch.clamp(torch.floor(pdu[t, :n_par, 0] * mm),
                          max=mm - 1).long()
        masses = torch.exp(x[idx, 0] + pbw * pdz[t, :n_par, 0])
        theta_opt, theta_fwd, amat, _, a_sel, w, _ = fused_particle_solve(
            state, theta, locs, torch.log_softmax(logits, 0), amat, aseq,
            theta[None] + sig * acts, masses, bw_sv, exp["learning_rate"],
            exp["alpha"], 1.0 / exp["alpha"], sig, exp["prior_sigma"],
            hz=hz, m=m, n_params=n_par, n_act=n_act, **kw)
        if t >= warm_up:
            action, theta, locs = a_sel[0], theta_fwd, theta_fwd
            logits = torch.log(torch.clamp(w, min=1e-37))
        else:
            action, theta = torch.zeros(2, device=dev), theta_opt
        mass = mass0 + stack.load if t >= change_at else mass0
        new_state = model.step(state[None], action[None],
                               {"mass": torch.tensor(mass, device=dev)})[0]
        state = state if done else new_state
        if t >= warm_up and not done:
            coll = model.obst_map.get_collisions(lik_loc[0:2])
            x = fused_particle_mpf_optimize(
                x, x, lik_loc, state, action, model.dt * (1.0 - coll),
                torch.tensor(stack.mpf_bw, device=dev), pbw,
                exp["mpf_learning_rate"], exp["mpf_obs_std"],
                n_steps=exp["mpf_steps"], max_acc=model.max_acc,
                max_speed=model.max_speed, log_space=exp["mpf_log_space"])
            pbw, lik_loc = torch.tensor(stack.mpf_bw, device=dev), state
        crash = bool(model.obst_map.get_collisions(state[0:2]) > 0)
        done = done or crash or bool(torch.linalg.norm(model.target - state)
                                     <= 1.0)
        for k, v in zip(logs, (state, action,
                               model.default_inst_cost(state[None])[0],
                               bw_sv)):
            logs[k].append(v)
    out = {k: torch.stack(v) for k, v in logs.items()}
    out.update(theta=theta, a_mat=amat, mpf_x=x)
    return out


def phase_k9(dev):
    """K9 against its plain version in host-noise mode (1 and 3 steps,
    warm_up 0 and 2) and in device-RNG mode (2 steps), and against the K8
    + K7 kernel composition with the same noise."""
    import torch

    from dust_tpu_torch.ops import particle_episode as pe

    cfg, stack = _particle_stack(dev)
    worst = 0.0
    for steps, warm_up in ((1, 0), (3, 0), (3, 2)):
        noise = _particle_noise(steps, SEED + 30 + steps + warm_up, dev)
        got = _particle_episode(pe.fused_particle_episode, cfg, stack, steps,
                                noise=noise, warm_up=warm_up)
        torch.cuda.synchronize()
        want = _particle_episode(pe.plain_particle_episode, cfg, stack,
                                 steps, noise=noise, warm_up=warm_up)
        label = f"K9 host noise {steps} steps warm_up {warm_up}"
        worst = max(worst, _check_particle_episode(label, got, want))
        if steps == 3:
            comp = _particle_composition(cfg, stack, steps, noise,
                                         warm_up=warm_up)
            for k in ("state", "action", "cost", "bw_sv", "theta", "a_mat",
                      "mpf_x"):
                worst = max(worst, _check_close(
                    f"K9 vs K8+K7 kernel composition warm_up {warm_up} {k}",
                    got[k], comp[k], **K9_TOLS[k]))
    got = _particle_episode(pe.fused_particle_episode, cfg, stack, 2,
                            seed=(3, 7))
    torch.cuda.synchronize()
    want = _particle_episode(pe.plain_particle_episode, cfg, stack, 2,
                             seed=(3, 7))
    worst = max(worst, _check_particle_episode("K9 device RNG 2 steps", got,
                                               want))
    # the kernel's other settings: the Silverman MPF bandwidth, the
    # unweighted prior, ExpectedCost
    noise = _particle_noise(2, SEED + 35, dev)
    for option in (dict(use_fixed_mpf_bw=False, mpf_bw_scale=1.3),
                   dict(weighted_prior=False), dict(exp_util=False)):
        got = _particle_episode(pe.fused_particle_episode, cfg, stack, 2,
                                noise=noise, **option)
        torch.cuda.synchronize()
        want = _particle_episode(pe.plain_particle_episode, cfg, stack, 2,
                                 noise=noise, **option)
        worst = max(worst, _check_particle_episode(
            f"K9 host noise 2 steps {option}", got, want))
    return worst


def _particle_outcome(label, states, dyn, crashed, success, n_steps,
                      mass_before, mass_after, load_step=MAIN_STEPS // 4,
                      min_advance=MIN_ADVANCE_M):
    """The task outcome of a particle path; gates finiteness and the
    movement towards the target before any termination."""
    states = np.asarray(states)
    for name, v in (("states", states), ("MPF particles", dyn)):
        if not np.isfinite(np.asarray(v)).all():
            raise AssertionError(f"{label}: non-finite {name}")
    dist = np.hypot(states[:, 0] - 9.0, states[:, 1] - 9.0)
    out = {"crashed": bool(crashed), "success": bool(success),
           "steps_run": int(n_steps), "start_distance_m": START_DIST,
           "min_distance_m": float(dist.min()),
           "final_distance_m": float(dist[-1]),
           "mpf_mass_before_load": mass_before,
           "mpf_mass_after_load": mass_after}
    print(f"{label}: crashed {out['crashed']}, success {out['success']}, "
          f"{n_steps} steps run, distance to the target {START_DIST:.2f} m "
          f"at the start, min {out['min_distance_m']:.3f} m, last "
          f"{out['final_distance_m']:.3f} m; MPF mass estimate (mean of "
          f"exp(x)) {mass_before} before the load at step {load_step}, "
          f"{mass_after} after (true 2.0, then 3.0)")
    if not START_DIST - out["min_distance_m"] >= min_advance:
        raise AssertionError(f"{label}: the particle did not get "
                             f"{min_advance} m nearer the target")
    return out


def _mass_estimate(x):
    return float(np.exp(np.asarray(x, np.float64)).mean())


def phase_particle_path(dev, fused_solve=False):
    """Path 5 (fused_solve=False): `run_particle_episode` on the stack
    with the K6 hook and FusedParticleMPF (K7), 200 steps. Path 6
    (fused_solve=True): FusedParticleSVMPC (K8) + K7; the K6 hook stays
    wired and must not launch."""
    import torch

    from dust_tpu_torch.inference import FusedParticleMPF
    from dust_tpu_torch.simulation import run_particle_episode

    label = "path 6 (K8 + K7)" if fused_solve else "path 5 (K6 + K7)"
    cfg, stack = _particle_stack(dev, fused_rollout=True,
                                 fused_solve=fused_solve)
    # bench/bench_all.py's particle kernel path: the single-kernel MPF
    stack.mpf = FusedParticleMPF.from_mpf(stack.mpf)

    def run(steps, seed):
        svstate = stack.svmpc.init_state(stack.init_policies,
                                         stack.policies_prior)
        mstate = stack.mpf.init_state(stack.mpf_init, stack.init_state, 2,
                                      bw=stack.mpf_init_bw)
        return run_particle_episode(
            torch.Generator(device=dev).manual_seed(seed), stack.model,
            stack.controller, stack.svmpc, svstate, stack.mpf, mstate,
            stack.dynamics_prior, load=stack.load, steps=steps, warm_up=0,
            mpf_bw=stack.mpf_bw, mpf_steps=stack.mpf_steps)

    run(5, SEED + 99)  # warm-up: library handles, allocator, set-up
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run(MAIN_STEPS, SEED)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = _counts()
    n = out["steps"]
    solve_kernel = "particle_solve" if fused_solve else \
        "particle_rollout_costs"
    _check_counts(label, launches, {solve_kernel: MAIN_STEPS,
                                    "particle_mpf_optimize": n})
    dyn = out["dyn_particles"]
    result = {"steps": MAIN_STEPS, "seconds": elapsed,
              "solves_per_s": MAIN_STEPS / elapsed,
              "ms_per_step": 1e3 * elapsed / MAIN_STEPS,
              "launches": launches}
    print(f"{label}: {MAIN_STEPS} MPC steps (4 mass draws x 64 samples x 6 "
          f"policies, H 40; 50 MPF particles x 20 steps) in {elapsed:.3f} "
          f"s, {result['ms_per_step']:.3f} ms per step; launches "
          f"{launches}")
    result["outcome"] = _particle_outcome(
        label, out["trajectory"], dyn, out["crashed"], out["success"], n,
        _mass_estimate(dyn[min(49, n - 1)]), _mass_estimate(dyn[-1]))
    for name in ("actions", "costs"):
        if not np.isfinite(out[name]).all():
            raise AssertionError(f"{label}: non-finite {name}")
    return result


def _particle_step(stack, generator, state, dstate, svstate, mstate, t):
    """One MPC step as `particle_episode_fn` runs it before termination
    (warm_up 0): solve, forward, simulator with the mass of step t, MPF."""
    import torch

    svstate, dstate, costs = stack.svmpc.optimize(
        svstate, dstate, state[None], mstate.prior, generator)
    svstate, a_seq, _ = stack.svmpc.forward(svstate, costs,
                                            generator=generator)
    action = a_seq[0]
    mass = float(stack.model.params_dict["mass"])
    if t >= MAIN_STEPS // 4:
        mass += stack.load
    state = stack.model.step(state[None], action[None],
                             {"mass": torch.tensor(mass,
                                                   device=state.device)})[0]
    mstate, _, _ = stack.mpf.optimize(mstate, action, state, bw=stack.mpf_bw,
                                      n_steps=stack.mpf_steps)
    return state, dstate, svstate, mstate, action


def phase_particle_kernel_vs_plain(dev, fused_solve=False):
    """The kernel path (path 5: K6 hook + K7; path 6: K8 + K7) against the
    plain path (SVMPC rollout loop + autograd MPF) for COMPARE_STEPS steps
    from the same arrays and generator seed; the plain side starts every
    step from the kernel side's state."""
    import torch

    from dust_tpu_torch.experiments import (
        PARTICLE_DEMO_CONFIG,
        assemble_particle_stack,
        draw_particle_stack_arrays,
    )
    from dust_tpu_torch.inference import FusedParticleMPF, SVMPCState

    label = "K8 path" if fused_solve else "K6 path"
    cfg = copy.deepcopy(PARTICLE_DEMO_CONFIG)
    arrays = draw_particle_stack_arrays(
        cfg, torch.Generator(device=dev).manual_seed(SEED + 40), dev)
    k_cfg = copy.deepcopy(cfg)
    k_cfg["exp_params"].update(fused_rollout=True, fused_solve=fused_solve)
    k_stack = assemble_particle_stack(k_cfg, arrays, device=dev)
    k_stack.mpf = FusedParticleMPF.from_mpf(k_stack.mpf)
    p_stack = assemble_particle_stack(cfg, arrays, device=dev)
    state = arrays["init_state"]
    dstate = k_stack.controller.init_state()
    svstate = k_stack.svmpc.init_state(arrays["init_policies"],
                                       k_stack.policies_prior)
    mstate = k_stack.mpf.init_state(arrays["mpf_init"], state, 2,
                                    bw=k_stack.mpf_init_bw)
    k_gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    p_gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    actions, particles = [], []
    for t in range(COMPARE_STEPS):
        p_sv = (SVMPCState(theta=svstate.theta, prior=svstate.prior,
                           prior_updated=t > 0) if fused_solve else svstate)
        p_out = _particle_step(p_stack, p_gen, state, dstate, p_sv, mstate, t)
        state, dstate, svstate, mstate, action = _particle_step(
            k_stack, k_gen, state, dstate, svstate, mstate, t)
        actions.append((action, p_out[4]))
        particles.append((mstate.x, p_out[3].x))
    worst = 0.0
    for name, pairs in (("action", actions), ("MPF particles", particles)):
        got = torch.stack([p[0] for p in pairs])
        want = torch.stack([p[1] for p in pairs])
        worst = max(worst, _check_close(
            f"{label} vs plain path, {name}, steps 0-4", got[:5], want[:5],
            **EARLY_TOL))
        worst = max(worst, _check_close(
            f"{label} vs plain path, {name}, {COMPARE_STEPS} steps", got,
            want, **RUN_TOL))
    return worst


def phase_particle_episode_path(dev):
    """Path 7: one 200-step episode of the demo stack in one K9 launch,
    through `megakernel_particle_episode_fn`, device-RNG noise."""
    import torch

    from dust_tpu_torch.ops import particle_episode as pe
    from dust_tpu_torch.simulation import megakernel_particle_episode_fn

    cfg, stack = _particle_stack(dev)
    episode = megakernel_particle_episode_fn(stack, cfg["exp_params"],
                                             steps=MAIN_STEPS)
    episode([SEED, 99])  # warm-up
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = episode([SEED, 1])
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = _counts()
    _check_counts("path 7 (K9 episode)", launches, {"particle_episode": 1})
    for k, v in out.items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"path 7: non-finite values in {k}")
    again = episode([SEED, 1])
    other = episode([SEED, 2])
    same = all(torch.equal(out[k], again[k]) for k in out)
    differs = not torch.equal(out["action"], other["action"])
    if not same or not differs:
        raise AssertionError(f"path 7: same seed gives the same bits: {same}"
                             f", another seed other results: {differs}")
    done = out["done"].cpu().numpy()
    n = int(done.argmax() + 1) if done.any() else MAIN_STEPS
    # the MPF particles before the load change: the same seed's first 50
    # steps (the noise is keyed by step)
    first = _particle_episode(pe.fused_particle_episode, cfg, stack,
                              MAIN_STEPS // 4, seed=(SEED, 1),
                              change_at=MAIN_STEPS // 4)
    if not torch.equal(first["state"], out["state"][:MAIN_STEPS // 4]):
        raise AssertionError("path 7: a 50-step episode differs from the "
                             "first 50 steps of the 200-step one")
    result = {"steps": MAIN_STEPS, "seconds": elapsed,
              "ms_per_episode": 1e3 * elapsed,
              "solves_per_s": MAIN_STEPS / elapsed, "launches": launches,
              "mpf_updates": int(min(n, MAIN_STEPS)),
              "same_seed_same_bits": same, "other_seed_differs": differs}
    print(f"path 7 (K9 episode): {MAIN_STEPS} steps in one launch, "
          f"{result['ms_per_episode']:.3f} ms per episode "
          f"({result['solves_per_s']:.1f} solves/s); launches {launches}")
    result["outcome"] = _particle_outcome(
        "path 7 (K9 episode)", out["state"][:n].cpu().numpy(),
        out["mpf_x"].cpu().numpy(), bool(out["crashed"][-1] > 0.5),
        bool(out["done"][-1] > 0.5) and not bool(out["crashed"][-1] > 0.5),
        n, _mass_estimate(first["mpf_x"].cpu()),
        _mass_estimate(out["mpf_x"].cpu()))
    return result


def _phase_clock(label, fn, clock, steps=MAIN_STEPS, calls=1, per="step"):
    """`calls` more calls of fn (a K2, K3, K4/K5, K6, K7, K8 or K9/K10 launch) under the
    kernel's clocked build (`clock`, an `ops/phase_clock.PhaseClock`):
    thread 0 of every block stamps clock64 at the block barriers that
    close the phases of a step. Prints, on one line, each phase's mean time
    per step (`steps` per call) over the blocks and calls (cycles at the
    block's own cycles-to-%globaltimer rate) and its share of the loop;
    returns them."""
    import torch

    with clock() as rows:
        for _ in range(calls):
            fn()
    torch.cuda.synchronize()
    clk = torch.cat(rows).double().cpu()        # [blocks, phases + 2]
    n = len(clock.phases)
    ns_per_cycle = clk[:, n + 1] / clk[:, n]    # per block
    us = (clk[:, :n] * ns_per_cycle[:, None]).mean(0) / (1e3 * steps)
    loop_us = float(clk[:, n + 1].mean()) / (1e3 * steps)
    phases = {k: {f"us_per_{per}": float(v),
                  "share": float(clk[:, i].sum() / clk[:, :n].sum())}
              for i, (k, v) in enumerate(zip(clock.phases, us))}
    print(f"{label} per-phase clock, us per {per} (mean of {clk.shape[0]} "
          f"blocks; share): " + ", ".join(
              f"{k} {v[f'us_per_{per}']:.2f} ({100 * v['share']:.1f}%)"
              for k, v in phases.items())
          + f"; the loop {loop_us:.2f} us per {per}, "
          f"{float(ns_per_cycle.mean()):.4f} ns per cycle")
    return {"blocks": int(clk.shape[0]), f"loop_us_per_{per}": loop_us,
            "ns_per_cycle": float(ns_per_cycle.mean()), "phases": phases}


def phase_timing_slice3(dev, path7):
    """K6, K7 and K8 as phase 6 times K1/K2 (device time per call, 20
    calls in one CUDA graph; plain, kernel, kernel, plain), with the
    per-phase clocks of K8, K6 and K7; K9 one 200-step episode between
    CUDA events (median of 3), its plain version one call, and its
    clock."""
    import torch

    from dust_tpu_torch.ops import particle_episode as pe
    from dust_tpu_torch.ops import particle_mpf as pm
    from dust_tpu_torch.ops import particle_rollout as pr
    from dust_tpu_torch.ops import solve
    from dust_tpu_torch.simulation import megakernel_particle_episode_fn

    cfg, stack = _particle_stack(dev)
    model = stack.model
    kw = _pkw(model)
    # floats of the model array the kernels read (header and map bits)
    n_model = pr.model_tensor(kw, model.dt, model.max_acc, model.max_speed,
                              dev).numel()
    gen = torch.Generator(device=dev).manual_seed(SEED + 50)
    s0 = torch.tensor([-9.0, -9.0, 0.0, 0.0], device=dev)
    acts = 5.0 * torch.randn((64, 6, 40, 2), generator=gen, device=dev)
    masses = 1.7 + 0.7 * torch.rand((4,), generator=gen, device=dev)
    inp = _k7_inputs(gen, dev, True, (0.4, -0.2), (3.0, -5.0), 0.015)
    k8_args = _k8_inputs(gen, dev, (-9.0, -9.0))
    k8_st = dict(_K8_STATICS, exp_util=True, **kw)
    out = {}
    for name, kern, plain, bound in (
            ("particle_rollout_costs",
             lambda: pr.fused_particle_rollout_costs(s0, acts, masses, **kw),
             lambda: pr.particle_rollout_costs_plain(s0, acts, masses, **kw),
             _k6_bound(4, 64, 6, 40, n_model)),
            ("particle_mpf_optimize",
             lambda: pm.fused_particle_mpf_optimize(**inp, n_steps=20),
             lambda: _k7_plain(inp, True), _k7_bound(50, 20)),
            ("particle_solve",
             lambda: solve.fused_particle_solve(*k8_args, **k8_st),
             lambda: solve.plain_particle_solve(*k8_args, **k8_st),
             _k8_bound(4, 6, 64, 40, n_model))):
        runs = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            fn = kern if which == "kernel" else plain
            runs[which].append({"device_ms": _device_ms(fn),
                                "call_ms": _call_ms(fn)})
        out[name] = {
            "ms": min(r["device_ms"] for r in runs["kernel"]),
            "plain_ms": min(r["device_ms"] for r in runs["plain"]),
            "runs": runs, "bound_ms": bound[0], "bound_by": bound[1],
            "bound_bytes": bound[2], "bound_ops": bound[3],
            "timed_as": "device time per call, 20 calls in one CUDA graph"}
    out["particle_solve"]["phase_clock"] = _phase_clock(
        "K8 (path 6)", lambda: solve.fused_particle_solve(*k8_args, **k8_st),
        solve.phase_clock, steps=1, calls=20, per="solve")
    out["particle_rollout_costs"]["phase_clock"] = _phase_clock(
        "K6 (path 5)",
        lambda: pr.fused_particle_rollout_costs(s0, acts, masses, **kw),
        pr.phase_clock, steps=1, calls=20, per="call")
    out["particle_mpf_optimize"]["phase_clock"] = _phase_clock(
        "K7 (path 5)",
        lambda: pm.fused_particle_mpf_optimize(**inp, n_steps=20),
        pm.phase_clock, steps=1, calls=20, per="call")

    episode = megakernel_particle_episode_fn(stack, cfg["exp_params"],
                                             steps=MAIN_STEPS)
    ep_kern = lambda: episode([SEED, 1])
    ep_plain = lambda: _particle_episode(pe.plain_particle_episode, cfg,
                                         stack, MAIN_STEPS, seed=(SEED, 1),
                                         change_at=MAIN_STEPS // 4)
    bound = _k9_bound(MAIN_STEPS, path7["mpf_updates"], 4, 6, 64, 40, 50, 20,
                      n_model)
    runs = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        if which == "kernel":
            runs[which].append(statistics.median(_event_ms(ep_kern, 3)))
        else:
            runs[which].append(_event_ms(ep_plain, 1)[0])
    out["particle_episode"] = {
        "ms": min(runs["kernel"]), "plain_ms": min(runs["plain"]),
        "runs": runs, "bound_ms": bound[0], "bound_by": bound[1],
        "bound_bytes": bound[2], "bound_ops": bound[3],
        "timed_as": "one call between CUDA events",
        "phase_clock": _phase_clock("K9 (path 7)", ep_kern,
                                    pe.phase_clock)}
    for name, t in out.items():
        print(f"time {name}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms ({t['timed_as']}); bound "
              f"{t['bound_ms']:.2e} ms ({t['bound_by']})")
    return out


# -- slice 4: the particle sweep (K10), the streamed MPF kernels (K11-K13) --

# bench/bench_all.py:444-484: 8 scenarios x 4 chains per program
PSWEEP_GROUPS, PSWEEP_SC, PSWEEP_CHAINS = 8, 8, 4
PSWEEP_LOGS = ("px", "py", "vx", "vy", "a_x", "a_y", "cost", "done",
               "crashed", "cum", "bw_sv", "bw_mpf")
# the sweep against its plain version at the CPU tests' tolerances
# (tests/test_torch_particle_sweep.py, from
# tests/test_pallas_particle_sweep.py:67-72, :126-169; a_mat at theta's):
# over path 8's 256 episodes K9's bw_sv atol of 1e-6 is ~8 ulp of a ~1.2
# bandwidth, and its a_mat atol of 1e-3 was 1.5e-3 after 2 steps (the
# DISCO weights amplify one-ulp cost differences, as in the pendulum)
_K10_STATE = dict(rtol=1e-4, atol=1e-3)
_K10_ACTION = dict(rtol=1e-3, atol=1e-3)
_K10_COST = dict(rtol=2e-3, atol=1.0)
_K10_BW = dict(rtol=1e-4, atol=1e-6)
K10_TOLS = {"px": _K10_STATE, "py": _K10_STATE, "vx": _K10_STATE,
            "vy": _K10_STATE, "a_x": _K10_ACTION, "a_y": _K10_ACTION,
            "cost": _K10_COST, "cum": _K10_COST, "bw_sv": _K10_BW,
            "bw_mpf": _K10_BW, "theta": dict(rtol=1e-3, atol=5e-3),
            "a_mat": dict(rtol=1e-3, atol=5e-3),
            "mpf_x": dict(rtol=1e-4, atol=1e-5)}
# the final prior weights exp(log_mix): the log of a weight near the
# 1e-37 floor moves by O(1) for an ulp of the weight, the weight does not
K10_WEIGHT_TOL = dict(rtol=0.0, atol=1e-5)
_K9_SOURCE = {"px": ("state", 0), "py": ("state", 1), "vx": ("state", 2),
              "vy": ("state", 3), "a_x": ("action", 0), "a_y": ("action", 1)}
# path 8: a kernel fault crashes many episodes; the chaotic loop moves a
# few between the kernel and its plain version
PSWEEP_MAX_EXTRA_CRASHES = 16
# the CPU tests' tolerances (tests/test_torch_svgd_stream.py,
# tests/test_torch_gmm_stream.py, tests/test_torch_fused_mpf.py)
K11_TOL = dict(rtol=2e-4, atol=2e-5)
K12_TOL = dict(rtol=1e-4, atol=1e-4)
K13_X_TOL = dict(rtol=1e-4, atol=1e-5)
K11_BF16_ATOL = 5e-3      # times the largest |phi|
K12_BF16_ATOL = 1.4e-2    # times the largest |score|
STREAM_KERNELS = ("svgd_phi", "svgd_phi_packed", "svgd_phi_symm",
                  "gmm_prior_score", "gmm_prior_score_packed",
                  "mpf_stream_step")
# path 10 runs 50 steps: the particle is still speeding up
PATH10_STEPS, PATH10_MIN_ADVANCE_M = 50, 0.5
# path 10's FusedMPF against the generic MPF on the same seed: the log-mass
# particles after the first update, the relative mass estimate at every
# step, and the positions (m) over the first PATH10_DRIFT_STEPS steps
PATH10_DRIFT = {"mpf_particles_step0": 1e-4, "mass_estimate_rel": 1e-3,
                "trajectory_m": 1e-2}
PATH10_DRIFT_STEPS = 10
# phase 27's particle counts: the packed threshold's side and the largest
# count bench_mpf_large runs (plain versions there in 1024-row chunks); and
# counts on no row-tile, slice or cluster boundary of K12/K13's split walk
STREAM_M, STREAM_LARGE_M = 8192, 32768
STREAM_RAGGED_M = (1, 33, 2049, 8191)
# path 11 (bench/bench_all.py:169-206): label, m, conditioned updates,
# FusedMPF options, the kernels launched once per update (or per SVGD
# step) and once per SVGD step
_FUSE = dict(fuse_streams=True, fused_lr=1e-3)
PATH11_CASES = (
    ("m=2048", 2048, 10, dict(lr=1e-3), ("gmm_prior_score", "svgd_phi")),
    ("m=8192", 8192, 10, dict(lr=1e-3),
     ("gmm_prior_score_packed", "svgd_phi_packed")),
    ("m=32768", 32768, 5, dict(lr=1e-3),
     ("gmm_prior_score_packed", "svgd_phi_packed")),
    ("m=8192 fuse_streams", 8192, 10, _FUSE,
     ("gmm_prior_score_packed", "mpf_stream_step")),
    ("m=32768 fuse_streams", 32768, 5, _FUSE,
     ("gmm_prior_score_packed", "mpf_stream_step")),
)


def _psweep_noise(n_sc, chains, steps, seed, dev):
    """Sweep host noise in the JAX layout with a chain axis: eps
    [chains, steps, hz, 2, smp, 128], pdz/pdu [chains, steps, n_sc, 8,
    128], from a numpy seed."""
    import torch

    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    smp = -(-n_sc * 6 // 8) * 8
    return (t(rng.normal(size=(chains, steps, 40, 2, smp, 128))),
            t(rng.normal(size=(chains, steps, n_sc, 8, 128))),
            t(rng.uniform(size=(chains, steps, n_sc, 8, 128))))


def _psweep_call(fn, cfg, stack, seeds, masses, steps, n_sc, chains,
                 mpfx0=None, noise=None):
    """`fn` (`fused_particle_sweep_groups` or its plain version) with the
    arguments `megakernel_particle_sweep_fn` passes for `stack`: seeds
    [G, 2], masses [G, n_sc] or [n_sc], per-scenario MPF particles or None
    (the stack's), host noise with a leading G axis or None."""
    import torch

    exp = cfg["exp_params"]
    mstate = stack.mpf.init_state(stack.mpf_init, stack.init_state, 2,
                                  bw=stack.mpf_init_bw)
    dstate = stack.controller.init_state()
    nz = {} if noise is None else dict(host_eps=noise[0], host_pdz=noise[1],
                                       host_pdu=noise[2])
    return fn(
        seeds, stack.init_state, stack.init_policies,
        stack.policies_prior.locs,
        torch.log_softmax(stack.policies_prior.logits, 0), dstate.a_mat,
        stack.mpf_init if mpfx0 is None else mpfx0, mstate.prior_bw, masses,
        stack.load, exp["ctrl_sigma"], exp["learning_rate"], exp["alpha"],
        1.0 / exp["alpha"], exp["prior_sigma"], exp["mpf_learning_rate"],
        exp["mpf_obs_std"], stack.mpf_bw, n_sc=n_sc, steps=steps,
        hz=exp["horizon"], m=exp["n_particles"],
        n_params=exp["params_samples"], n_act=exp["action_samples"],
        m_mpf=exp["mpf_n_particles"], mpf_steps=exp["mpf_steps"],
        change_at=steps // 4, weighted_prior=exp["weighted_prior"],
        mpf_log_space=exp["mpf_log_space"],
        mpf_bw_scale=exp["mpf_bandwidth_scaling"], n_chains=chains, **nz,
        **_pkw(stack.model))


def _k10_mismatches(out, c, s, ref):
    """Fields of chain c, scenario s of a sweep `out` ([chains, ...])
    that differ in any bit from the single episode `ref`."""
    import torch

    n = 0
    for k in PSWEEP_LOGS:
        src, i = _K9_SOURCE.get(k, (k, None))
        want = ref[src] if i is None else ref[src][:, i]
        n += not torch.equal(out[k][c][:, s], want)
    return n + sum(not torch.equal(out[k][c][s], ref[k])
                   for k in ("theta", "locs", "a_mat", "mpf_x"))


def _check_psweep(label, got, want):
    """A sweep against its plain version: every field at K9's tolerance,
    done and crashed equal, the final prior weights at K10_WEIGHT_TOL."""
    import torch

    worst = 0.0
    for k, tol in K10_TOLS.items():
        worst = max(worst, _check_close(f"{label} {k}", got[k], want[k],
                                        **tol))
    for k in ("done", "crashed"):
        if not torch.equal(got[k], want[k]):
            raise AssertionError(f"{label} {k} differs from plain")
    worst = max(worst, _check_close(
        f"{label} final prior weights", torch.exp(got["log_mix"]),
        torch.exp(want["log_mix"]), **K10_WEIGHT_TOL))
    return worst


def phase_k10(dev):
    """K10 against independent K9 launches, bit for bit: 8 scenarios x 4
    chains, 2 steps, with host noise (every episode) and device RNG
    (scenario 0 of each chain, whose draws K9 keys alike); NaN isolation;
    the device-RNG sweep and its final log-mix against the plain
    version."""
    import torch

    from dust_tpu_torch.ops import particle_episode as pe
    from dust_tpu_torch.ops import particle_sweep_episode as pse

    cfg, stack = _particle_stack(dev)
    n_sc, chains, steps = PSWEEP_SC, PSWEEP_CHAINS, 2
    masses = torch.linspace(1.6, 2.4, n_sc, device=dev)
    noise = _psweep_noise(n_sc, chains, steps, SEED + 60, dev)
    lead = lambda nz: tuple(v[None] for v in nz)

    def sweep(seed, ms=masses, mpfx0=None, nz=noise):
        out = _psweep_call(pse.fused_particle_sweep_groups, cfg, stack,
                           torch.tensor([seed], device=dev), ms, steps, n_sc,
                           chains, mpfx0=mpfx0,
                           noise=None if nz is None else lead(nz))
        return {k: v[0] for k, v in out.items()}

    out = sweep([1, 2])
    torch.cuda.synchronize()
    mismatches = 0
    for c in range(chains):
        for s in range(n_sc):
            eps_s = torch.zeros((steps, 2, 40, 8, 128), device=dev)
            eps_s[:, :, :, :6] = noise[0][c, :, :, :, 6 * s:6 * s + 6] \
                .transpose(1, 2)
            ref = _particle_episode(
                pe.fused_particle_episode, cfg, stack, steps,
                noise=(eps_s, noise[1][c, :, s], noise[2][c, :, s]),
                change_at=steps // 4, base_mass=masses[s])
            mismatches += _k10_mismatches(out, c, s, ref)
    rng_out = sweep([5, 9], nz=None)
    for c in range(chains):
        ref = _particle_episode(pe.fused_particle_episode, cfg, stack, steps,
                                seed=(5, 9 + 4099 * c), change_at=steps // 4,
                                base_mass=masses[0])
        mismatches += _k10_mismatches(rng_out, c, 0, ref)
    print(f"K10 vs {chains * n_sc} independent K9 launches (host noise) and "
          f"{chains} (device RNG, scenario 0), {n_sc} scenarios x {chains} "
          f"chains, {steps} steps: {mismatches} fields differ in any bit")
    if mismatches:
        raise AssertionError("K10 differs from independent K9 launches")

    # NaN in one scenario's true mass, then in its MPF particles
    others = [s for s in range(n_sc) if s != 1]
    bad = masses.clone()
    bad[1] = float("nan")
    per = stack.mpf_init.expand(n_sc, -1, -1).clone()
    per_nan = per.clone()
    per_nan[1] = float("nan")
    for label, base, poisoned, field in (
            ("true mass", out, sweep([1, 2], ms=bad), "vx"),
            ("MPF particles", sweep([1, 2], mpfx0=per),
             sweep([1, 2], mpfx0=per_nan), "mpf_x")):
        leak = sum(
            not torch.equal(base[k][:, :, others] if k in PSWEEP_LOGS
                            else base[k][:, others],
                            poisoned[k][:, :, others] if k in PSWEEP_LOGS
                            else poisoned[k][:, others])
            for k in base)
        own = poisoned[field][:, :, 1] if field in PSWEEP_LOGS \
            else poisoned[field][:, 1]
        print(f"K10 NaN in scenario 1's {label}: {leak} fields of the "
              f"other scenarios changed; scenario 1 finite: "
              f"{bool(torch.isfinite(own).all())}")
        if leak or torch.isfinite(own).all():
            raise AssertionError(f"K10 scenario isolation ({label})")

    want = _psweep_call(pse.plain_particle_sweep_groups, cfg, stack,
                        torch.tensor([[5, 9]], device=dev), masses, steps,
                        n_sc, chains)
    return _check_psweep(f"K10 device RNG {n_sc}x{chains} {steps} steps",
                         rng_out, {k: v[0] for k, v in want.items()})


def _bench_particle_sweep(dev, steps):
    """bench/bench_all.py:444-484's particle sweep on the demo stack: the
    MegakernelGroupSweep over 8 groups of 8 scenarios x 4 chains, the
    seeds of run i, the masses, and plain(seeds): the sweep's plain
    version on the same inputs."""
    import torch

    from dust_tpu_torch.ops.particle_sweep_episode import (
        plain_particle_sweep_groups,
    )
    from dust_tpu_torch.parallel import MegakernelGroupSweep
    from dust_tpu_torch.simulation import megakernel_particle_sweep_fn

    cfg, stack = _particle_stack(dev)
    sweep = megakernel_particle_sweep_fn(stack, cfg["exp_params"],
                                         steps=steps, n_sc=PSWEEP_SC,
                                         n_chains=PSWEEP_CHAINS)
    masses = torch.linspace(1.6, 2.4, PSWEEP_SC, device=dev).expand(
        PSWEEP_GROUPS, PSWEEP_SC)

    def seeds(i):   # bench/bench_all.py:479-483
        return torch.stack([
            torch.full((PSWEEP_GROUPS,), i, dtype=torch.int64, device=dev),
            torch.arange(PSWEEP_GROUPS, device=dev) * 1000], dim=1)

    def plain(seed_rows):
        return _psweep_call(plain_particle_sweep_groups, cfg, stack,
                            seed_rows, masses, steps, PSWEEP_SC,
                            PSWEEP_CHAINS)

    return MegakernelGroupSweep(sweep), seeds, masses, plain


def _psweep_outcome(out):
    """Per episode: crashed, success, the minimum distance to the target
    (9, 9) over the steps, and the MPF updates run (steps before the done
    flag was set; warm_up 0)."""
    import torch

    crashed = out["crashed"][..., -1, :] > 0.5
    done = out["done"][..., -1, :] > 0.5
    dist = torch.hypot(out["px"] - 9.0, out["py"] - 9.0).amin(dim=-2)
    updates = out["done"].shape[-2] - (out["done"][..., :-1, :] > 0.5).sum(
        dim=-2)
    return (crashed.reshape(-1), (done & ~crashed).reshape(-1),
            dist.reshape(-1), int(updates.sum()))


def phase_particle_sweep_path(dev):
    """Path 8: bench_all.py's particle sweep, 256 episodes = 8 groups x 8
    scenarios x 4 chains x MAIN_STEPS steps, in one K10 launch through
    MegakernelGroupSweep; before it, the layout against the plain version
    after 1 and 2 steps and against per-group launches; after it, the
    plain sweep on the same draws."""
    import torch

    label = "path 8 (K10 sweep)"
    worst = 0.0
    for steps in (1, 2):
        groups, seeds, masses, plain = _bench_particle_sweep(dev, steps)
        got = groups.run(seeds(1), masses)
        torch.cuda.synchronize()
        worst = max(worst, _check_psweep(
            f"K10 path-8 layout {PSWEEP_GROUPS}x{PSWEEP_SC}x{PSWEEP_CHAINS} "
            f"device RNG {steps} steps", got, plain(seeds(1))))
    mismatches = 0
    for g in range(PSWEEP_GROUPS):
        one = groups.sweep_fn(seeds(1)[g], masses[g])
        mismatches += sum(not torch.equal(got[k][g], one[k]) for k in got)
    print(f"K10 path-8 layout vs {PSWEEP_GROUPS} launches of one group each "
          f"(2 steps): {mismatches} fields differ in any bit")
    if mismatches:
        raise AssertionError("K10 at G > 1 differs from per-group launches")

    groups, seeds, masses, plain = _bench_particle_sweep(dev, MAIN_STEPS)
    groups.run(seeds(0), masses)  # warm-up
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = groups.run(seeds(1), masses)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = _counts()
    _check_counts(label, launches, {"particle_sweep_episode": 1})
    episodes = PSWEEP_GROUPS * PSWEEP_SC * PSWEEP_CHAINS
    shape = (PSWEEP_GROUPS, PSWEEP_CHAINS, MAIN_STEPS, PSWEEP_SC)
    if tuple(out["px"].shape) != shape:
        raise AssertionError(f"{label}: px shape {tuple(out['px'].shape)}")
    for k, v in out.items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"{label}: non-finite values in {k}")
    crashed, success, dist, updates = _psweep_outcome(out)

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = plain(seeds(1))
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    p_crashed, p_success, p_dist, _ = _psweep_outcome(want)
    apart = (out["px"] - want["px"]).abs() > 1e-3   # [G, C, steps, n_sc]
    first = torch.where(apart.any(2), apart.int().argmax(2),
                        MAIN_STEPS).reshape(-1)
    result = {
        "episodes": episodes, "steps": MAIN_STEPS, "seconds": elapsed,
        "solves_per_s": episodes * MAIN_STEPS / elapsed,
        "launches": launches, "mpf_updates": updates,
        "crash_share": float(crashed.float().mean()),
        "success_share": float(success.float().mean()),
        "mean_min_distance_m": float(dist.mean()),
        "median_min_distance_m": float(dist.median()),
        "plain_ms": plain_ms,
        "plain_crash_share": float(p_crashed.float().mean()),
        "plain_success_share": float(p_success.float().mean()),
        "plain_mean_min_distance_m": float(p_dist.mean()),
        "first_step_apart_min": int(first.min()),
        "first_step_apart_median": float(first.float().median()),
        "layout_max_abs_err": worst,
    }
    print(f"{label}: {episodes} episodes = {PSWEEP_GROUPS} groups x "
          f"{PSWEEP_SC} scenarios x {PSWEEP_CHAINS} chains x {MAIN_STEPS} "
          f"steps in one launch, {elapsed:.4f} s, "
          f"{result['solves_per_s']:.1f} solves/s; crash share "
          f"{result['crash_share']:.4f}, success share "
          f"{result['success_share']:.4f}, mean minimum distance to the "
          f"target {result['mean_min_distance_m']:.3f} m (start "
          f"{START_DIST:.2f} m); launches {launches}")
    print(f"{label} against the plain sweep on the same draws "
          f"({plain_ms:.1f} ms): crash share plain "
          f"{result['plain_crash_share']:.4f}, success share plain "
          f"{result['plain_success_share']:.4f}, mean minimum distance "
          f"plain {result['plain_mean_min_distance_m']:.3f} m; px drifts "
          f"apart by > 1e-3 first at step {result['first_step_apart_min']} "
          f"(median {result['first_step_apart_median']})")
    if not START_DIST - result["median_min_distance_m"] >= MIN_ADVANCE_M:
        raise AssertionError(f"{label}: the median episode did not get "
                             f"{MIN_ADVANCE_M} m nearer the target")
    if int(crashed.sum()) > int(p_crashed.sum()) + PSWEEP_MAX_EXTRA_CRASHES:
        raise AssertionError(f"{label}: {int(crashed.sum())} crashes, plain "
                             f"{int(p_crashed.sum())}")
    return result


def phase_particle_scenario_path(dev):
    """Path 9: ParticleScenarioSweep over `particle_episode_fn` with the
    K6 hook and FusedParticleMPF (K7), 8 scenarios, true masses
    linspace(1.5, 3.0, 8) (bench/bench_all.py:307-357), MAIN_STEPS
    steps; every scenario against `run_particle_episode` on the same
    generator seed."""
    import torch

    from dust_tpu_torch.inference import FusedParticleMPF
    from dust_tpu_torch.parallel import (
        ParticleScenarioSweep,
        broadcast_scenarios,
    )
    from dust_tpu_torch.simulation import (
        particle_episode_fn,
        run_particle_episode,
    )

    label = "path 9 (ParticleScenarioSweep, K6 + K7)"
    cfg, stack = _particle_stack(dev, fused_rollout=True)
    stack.mpf = FusedParticleMPF.from_mpf(stack.mpf)
    kw = dict(load=stack.load, steps=MAIN_STEPS, warm_up=0,
              mpf_bw=stack.mpf_bw, mpf_steps=stack.mpf_steps)
    episode = particle_episode_fn(stack.model, stack.controller,
                                  svmpc=stack.svmpc, mpf=stack.mpf,
                                  dyn_dist=stack.dynamics_prior, **kw)
    n = 8
    masses = torch.linspace(1.5, 3.0, n, device=dev)
    seeds = [SEED + 300 + i for i in range(n)]
    svstate = stack.svmpc.init_state(stack.init_policies,
                                     stack.policies_prior)
    mstate = stack.mpf.init_state(stack.mpf_init, stack.init_state, 2,
                                  bw=stack.mpf_init_bw)
    args = (seeds, stack.init_state.expand(n, 4),
            broadcast_scenarios(stack.controller.init_state(), n),
            broadcast_scenarios(svstate, n), broadcast_scenarios(mstate, n),
            masses)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ParticleScenarioSweep(episode).run(*args)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = _counts()
    k7 = launches["particle_mpf_optimize"]
    any_done = bool((out["success"] | out["crashed"]).any())
    k7_ok = (n <= k7 <= n * MAIN_STEPS) if any_done else k7 == n * MAIN_STEPS
    _check_counts(label, launches, {"particle_rollout_costs": n * MAIN_STEPS,
                                    "particle_mpf_optimize": k7})
    if not k7_ok:
        raise AssertionError(f"{label}: K7 launched {k7} times")
    final = out["final_state"]
    if not torch.isfinite(final).all():
        raise AssertionError(f"{label}: non-finite final states")
    crashed = out["crashed"]
    inf_rule = bool(torch.equal(torch.isinf(out["cum_cost"]), crashed))
    differ = not torch.equal(final[0], final[-1])
    singles = []
    for i in range(n):
        saved = stack.model.params_dict["mass"]
        stack.model.params_dict["mass"] = float(masses[i])
        try:
            one = run_particle_episode(
                torch.Generator(device=dev).manual_seed(seeds[i]),
                stack.model, stack.controller, stack.svmpc, svstate,
                stack.mpf, mstate, stack.dynamics_prior,
                init_state=stack.init_state, **kw)
        finally:
            stack.model.params_dict["mass"] = saved
        got = final[i].cpu().numpy()
        singles.append({
            "scenario": i, "bit_equal": bool(np.array_equal(
                got, one["final_state"])),
            "max_abs_diff": float(np.abs(got - one["final_state"]).max()),
            "cum_cost": float(out["cum_cost"][i]),
            "single_cum_cost": one["cum_cost"]})
    dist = torch.hypot(final[:, 0] - 9.0, final[:, 1] - 9.0)
    result = {"scenarios": n, "steps": MAIN_STEPS, "seconds": elapsed,
              "solves_per_s": n * MAIN_STEPS / elapsed,
              "launches": launches,
              "crash_rate": float(out["crash_rate"]),
              "success_rate": float(out["success_rate"]),
              "final_distance_m": dist.tolist(),
              "crashed_iff_inf_cost": inf_rule,
              "trajectories_differ": differ, "vs_single": singles}
    print(f"{label}: {n} scenarios x {MAIN_STEPS} steps in {elapsed:.3f} s "
          f"({result['solves_per_s']:.1f} solves/s); crash rate "
          f"{result['crash_rate']}, success rate {result['success_rate']}; "
          f"final distance to the target "
          f"{_fmt(result['final_distance_m'])} m; crashed <=> inf cost "
          f"{inf_rule}; masses move the trajectory {differ}; final states "
          f"bit-equal to run_particle_episode on the same seed in "
          f"{sum(o['bit_equal'] for o in singles)} of {n} scenarios (max "
          f"difference {max(o['max_abs_diff'] for o in singles):.3e}); "
          f"launches {launches}")
    if not inf_rule or not differ:
        raise AssertionError(f"{label}: crash rule {inf_rule}, masses move "
                             f"the trajectory {differ}")
    for one in singles:
        if one["max_abs_diff"] > RUN_TOL["atol"]:
            raise AssertionError(f"{label}: scenario {one['scenario']} "
                                 f"differs from run_particle_episode")
    return result


def _stream_inputs(m, d, gen, dev):
    """MPF-like inputs: particles uniform(0.6, 1.3), likelihood scores
    ~50 (sigma 0.1), prior centers 0.02 from the particles."""
    import torch

    x = 0.6 + 0.7 * torch.rand((m, d), generator=gen, device=dev)
    score = 50.0 * torch.randn((m, d), generator=gen, device=dev)
    centers = x + 0.02 * torch.randn((m, d), generator=gen, device=dev)
    return x, score, centers


def _ragged_k(m):
    """K12's center count beside m rows in phase 27's ragged checks."""
    return 2 * m // 3 + 5


def _chunks(m):
    """Four 1024-row slices spread over m rows."""
    return [slice(r, r + 1024) for r in (0, m // 3, 2 * m // 3, m - 1024)]


def phase_stream_kernels(dev):
    """K11a-c, K12a-b and K13 against their plain versions: m = 2048
    (d = 1, 2) and 8192 (d = 2); the JAX tests' odd shapes; far from the
    origin; bf16; K12 and K13 at STREAM_RAGGED_M and d = 1, 2, 3, 8, each
    twice with the same bits; m = 32768 in four 1024-row chunks of the
    plain formula against all columns."""
    import torch

    from dust_tpu_torch.ops import gmm, mpf_stream, svgd

    gen = torch.Generator(device=dev).manual_seed(SEED + 70)
    errs = dict.fromkeys(STREAM_KERNELS, 0.0)
    dt = lambda v: torch.tensor(v, device=dev)
    bw, pbw, lr = dt(0.3), dt(0.2), dt(1e-3)

    def chk(name, label, got, want, tol):
        errs[name] = max(errs[name], _check_close(
            f"{name} {label}", got, want, **tol))

    def bf16_chk(name, kernel, plain, jax_atol, f32_atol):
        """use_bf16 against the bf16 plain version, within the smaller of
        the JAX test's bf16 tolerance (jax_atol x the largest value) and
        the rounding's own effect on the plain version (bf16 against f32
        plain); and the rounding must move the kernel's output by more
        than the f32 check's atol, so a kernel that ignores use_bf16
        fails."""
        got, f32_got = kernel(True), kernel(False)
        want, f32_want = plain(True), plain(False)
        effect = (want - f32_want).abs().max().item()
        atol = min(jax_atol * want.abs().max().item(), effect)
        chk(name, f"bf16 m={STREAM_M}", got, want, dict(rtol=0, atol=atol))
        moved = (got - f32_got).abs().max().item()
        print(f"{name} bf16 m={STREAM_M}: the rounding moves the kernel's "
              f"output by {moved:.3e}, the plain version's by {effect:.3e} "
              f"(must exceed {f32_atol})")
        if not moved > f32_atol:
            raise AssertionError(f"{name}: use_bf16 leaves the kernel's "
                                 f"output within f32 noise")

    def same_bits(name, label, fn):
        """fn's result, after a second call gave the same bits."""
        first, second = fn(), fn()
        torch.cuda.synchronize()
        pairs = zip(first, second) if isinstance(first, tuple) else \
            [(first, second)]
        if not all(torch.equal(a, b) for a, b in pairs):
            raise AssertionError(f"{name} {label}: two calls with the same "
                                 f"inputs differ")
        return first

    def normal(m, d, scale=1.0, offset=0.0):
        return offset + scale * torch.randn((m, d), generator=gen,
                                            device=dev)

    fns = {"svgd_phi": svgd.svgd_phi_streamed,
           "svgd_phi_packed": svgd.svgd_phi_streamed_packed,
           "svgd_phi_symm": svgd.svgd_phi_streamed_symm}
    for name, m, d in (("svgd_phi", 2048, 1), ("svgd_phi", 2048, 2),
                       ("svgd_phi", STREAM_M, 2),
                       ("svgd_phi_packed", STREAM_M, 2),
                       ("svgd_phi_symm", STREAM_M, 2)):
        x, s, _ = _stream_inputs(m, d, gen, dev)
        got = fns[name](x, s, bw)
        torch.cuda.synchronize()
        chk(name, f"m={m} d={d}", got, svgd.svgd_phi_plain(x, s, bw),
            K11_TOL)
    # tests/test_pallas.py's shapes and inputs
    for name, m, d, b in (("svgd_phi", 137, 5, 1.3), ("svgd_phi", 300, 60, 0.7),
                          ("svgd_phi_packed", 137, 5, 0.7),
                          ("svgd_phi_symm", 700, 2, 0.7)):
        x, s = normal(m, d, offset=1.5), normal(m, d, 5.0)
        chk(name, f"m={m} d={d}", fns[name](x, s, dt(b)),
            svgd.svgd_phi_plain(x, s, dt(b)), K11_TOL)
    # the dispatcher launches the kernel on the card below JAX's m = 512
    before = svgd.svgd_phi_streamed.launches
    x, s = normal(100, 2, offset=1.5), normal(100, 2, 5.0)
    got = svgd.fused_svgd_phi(x, s, dt(0.7))
    if svgd.svgd_phi_streamed.launches != before + 1:
        raise AssertionError("fused_svgd_phi did not launch svgd_phi")
    chk("svgd_phi", "fused_svgd_phi m=100", got,
        svgd.svgd_phi_plain(x, s, dt(0.7)), K11_TOL)
    x, s = normal(256, 3, 0.2), normal(256, 3)
    near = svgd.svgd_phi_streamed(x, s, dt(0.5))
    far = svgd.svgd_phi_streamed(x + 2000.0, s, dt(0.5))
    chk("svgd_phi", "far from the origin", far,
        svgd.svgd_phi_plain(x + 2000.0, s, dt(0.5)), K11_TOL)
    # tests/test_pallas.py:37-52: the inputs' float32 quantization at 2000
    # bounds this, not the kernel, so it stays out of the kernel's error
    _check_close("svgd_phi far against near", far, near, rtol=0, atol=2e-3)
    x, s, c = _stream_inputs(STREAM_M, 2, gen, dev)
    bf16_chk("svgd_phi_packed",
             lambda b: svgd.svgd_phi_streamed_packed(x, s, bw, use_bf16=b),
             lambda b: svgd.svgd_phi_plain(x, s, bw, use_bf16=b),
             K11_BF16_ATOL, K11_TOL["atol"])

    gfns = {"gmm_prior_score": gmm.gmm_prior_score_streamed,
            "gmm_prior_score_packed": gmm.gmm_prior_score_streamed_packed}
    for name, m, d in (("gmm_prior_score", 2048, 1),
                       ("gmm_prior_score", 2048, 2),
                       ("gmm_prior_score", STREAM_M, 2),
                       ("gmm_prior_score_packed", STREAM_M, 2)):
        x, _, c = _stream_inputs(m, d, gen, dev)
        got = gfns[name](x, c, pbw)
        torch.cuda.synchronize()
        chk(name, f"m={m} d={d}", got, gmm.gmm_prior_score_plain(x, c, pbw),
            K12_TOL)
    # tests/test_pallas_gmm.py's shapes and inputs; d = 60 takes the
    # general path (stream_tiles.cuh:gmm_sums), two calls bit-equal
    for name, m, k, d in (("gmm_prior_score", 200, 130, 3),
                          ("gmm_prior_score", 300, 300, 5),
                          ("gmm_prior_score_packed", 300, 300, 1),
                          ("gmm_prior_score", 300, 300, 60),
                          ("gmm_prior_score", 300, 130, 60)):
        x, c = normal(m, d, offset=0.8), normal(k, d)
        label = f"m={m} k={k} d={d}"
        chk(name, label, same_bits(name, label,
                                   lambda: gfns[name](x, c, dt(0.4))),
            gmm.gmm_prior_score_plain(x, c, dt(0.4)), K12_TOL)
    x, c = normal(192, 2, 0.3), normal(192, 2, 0.3)
    near = gmm.gmm_prior_score_streamed(x, c, dt(0.4))
    far = gmm.gmm_prior_score_streamed(x + 3000.0, c + 3000.0, dt(0.4))
    chk("gmm_prior_score", "far from the origin", far,
        gmm.gmm_prior_score_plain(x + 3000.0, c + 3000.0, dt(0.4)), K12_TOL)
    _check_close("gmm_prior_score far against near", far, near, rtol=0,
                 atol=5e-3)
    x, _, c = _stream_inputs(STREAM_M, 2, gen, dev)
    bf16_chk("gmm_prior_score_packed",
             lambda b: gmm.gmm_prior_score_streamed_packed(x, c, pbw,
                                                           use_bf16=b),
             lambda b: gmm.gmm_prior_score_plain(x, c, pbw, use_bf16=b),
             K12_BF16_ATOL, K12_TOL["atol"])

    for m in (200, STREAM_M):
        x, s, c = _stream_inputs(m, 2, gen, dev)
        gx, gg = mpf_stream.fused_mpf_stream_step(x, s, c, bw, pbw, lr)
        torch.cuda.synchronize()
        wx, wg = mpf_stream.mpf_stream_step_plain(x, s, c, bw, pbw, lr)
        chk("mpf_stream_step", f"x_new m={m}", gx, wx, K13_X_TOL)
        chk("mpf_stream_step", f"gp_new m={m}", gg, wg, K12_TOL)

    # the split walk's edges: m on no tile, slice or cluster boundary (K12
    # with k != m), d = 1, 2, 3 and 8; two calls give the same bits (the
    # merge order is fixed)
    for m in STREAM_RAGGED_M:
        for d in (1, 2, 3, 8):
            x, s, c = _stream_inputs(m, d, gen, dev)
            ck = _stream_inputs(_ragged_k(m), d, gen, dev)[2]
            label = f"m={m} k={ck.shape[0]} d={d}"
            want = svgd.svgd_phi_plain(x, s, bw)
            for name in ("svgd_phi", "svgd_phi_packed", "svgd_phi_symm"):
                chk(name, f"m={m} d={d}", same_bits(
                    name, f"m={m} d={d}", lambda: fns[name](x, s, bw)),
                    want, K11_TOL)
            for name in ("gmm_prior_score", "gmm_prior_score_packed"):
                chk(name, label, same_bits(name, label,
                                           lambda: gfns[name](x, ck, pbw)),
                    gmm.gmm_prior_score_plain(x, ck, pbw), K12_TOL)
            gx, gg = same_bits("mpf_stream_step", f"m={m} d={d}",
                               lambda: mpf_stream.fused_mpf_stream_step(
                                   x, s, c, bw, pbw, lr))
            wx, wg = mpf_stream.mpf_stream_step_plain(x, s, c, bw, pbw, lr)
            chk("mpf_stream_step", f"x_new m={m} d={d}", gx, wx, K13_X_TOL)
            chk("mpf_stream_step", f"gp_new m={m} d={d}", gg, wg, K12_TOL)
    print(f"K11a-c, K12a, K12b and K13 at m = {STREAM_RAGGED_M}, d = 1, 2, "
          f"3, 8: two calls bit-equal")

    # m = 32768: the plain [m, m] matrices would take 4 GB each
    m = STREAM_LARGE_M
    x, s, c = _stream_inputs(m, 2, gen, dev)
    phi = svgd.svgd_phi_streamed_packed(x, s, bw)
    score = gmm.gmm_prior_score_streamed_packed(x, c, pbw)
    gx, gg = mpf_stream.fused_mpf_stream_step(x, s, c, bw, pbw, lr)
    torch.cuda.synchronize()
    for rows in _chunks(m):
        label = f"m={m} rows {rows.start}-{rows.stop - 1}"
        want_phi = svgd.svgd_phi_plain(x, s, bw, rows=rows)
        chk("svgd_phi_packed", label, phi[rows], want_phi, K11_TOL)
        chk("gmm_prior_score_packed", label, score[rows],
            gmm.gmm_prior_score_plain(x[rows], c, pbw), K12_TOL)
        want_x = x[rows] + lr * want_phi
        chk("mpf_stream_step", f"x_new {label}", gx[rows], want_x,
            K13_X_TOL)
        chk("mpf_stream_step", f"gp_new {label}", gg[rows],
            gmm.gmm_prior_score_plain(want_x, c, pbw), K12_TOL)
    return errs


def phase_particle_large_path(dev):
    """Path 10: bench/bench_all.py:209-245's particle_large stack (16
    policies x 512 samples x 8 mass draws, 2048 MPF particles x 20 steps)
    with FusedMPF at the demo's fixed MPF bandwidth (K11a + K12a, the gram
    entries at m = 2048), rollouts by the plain MultiDisco, PATH10_STEPS
    steps of run_particle_episode; then the generic MPF on the same
    generator seed."""
    import torch

    from dust_tpu_torch.inference import FusedMPF
    from dust_tpu_torch.simulation import run_particle_episode

    label = "path 10 (particle_large, FusedMPF K11a + K12a)"
    cfg, stack = _particle_stack(dev, n_particles=16, action_samples=512,
                                 params_samples=8, mpf_n_particles=2048,
                                 mpf_steps=20)
    exp = cfg["exp_params"]
    fused = FusedMPF(stack.mpf.likelihood, lr=exp["mpf_learning_rate"],
                     n_steps=20)

    def run(mpf, seed, steps=PATH10_STEPS):
        return run_particle_episode(
            torch.Generator(device=dev).manual_seed(seed), stack.model,
            stack.controller, stack.svmpc,
            stack.svmpc.init_state(stack.init_policies,
                                   stack.policies_prior),
            mpf, mpf.init_state(stack.mpf_init, stack.init_state, 2,
                                bw=stack.mpf_init_bw),
            stack.dynamics_prior, load=stack.load, steps=steps, warm_up=0,
            mpf_bw=stack.mpf_bw, mpf_steps=20)

    run(fused, SEED + 99, 2)  # warm-up
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run(fused, SEED + 400)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = _counts()
    n = out["steps"]
    _check_counts(label, launches, {"svgd_phi": 20 * n,
                                    "gmm_prior_score": 20 * n})
    load_step = PATH10_STEPS // 4
    dyn = out["dyn_particles"]
    result = {"steps": PATH10_STEPS, "seconds": elapsed,
              "solves_per_s": PATH10_STEPS / elapsed,
              "ms_per_step": 1e3 * elapsed / PATH10_STEPS,
              "launches": launches}
    print(f"{label}: {PATH10_STEPS} MPC steps (8 mass draws x 512 samples x "
          f"16 policies, H 40; 2048 MPF particles x 20 steps) in "
          f"{elapsed:.3f} s, {result['ms_per_step']:.3f} ms per step; "
          f"launches {launches}")
    result["outcome"] = _particle_outcome(
        label, out["trajectory"], dyn, out["crashed"], out["success"], n,
        _mass_estimate(dyn[min(load_step - 1, n - 1)]),
        _mass_estimate(dyn[-1]), load_step=load_step,
        min_advance=PATH10_MIN_ADVANCE_M)
    t0 = time.perf_counter()
    ref = run(stack.mpf, SEED + 400)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    rdyn = ref["dyn_particles"]
    result["generic_mpf"] = {
        "seconds": plain_s, "crashed": ref["crashed"],
        "success": ref["success"], "steps_run": ref["steps"],
        "min_distance_m": float(np.hypot(ref["trajectory"][:, 0] - 9.0,
                                         ref["trajectory"][:, 1] - 9.0).min()),
        "mpf_mass_before_load": _mass_estimate(
            rdyn[min(load_step - 1, ref["steps"] - 1)]),
        "mpf_mass_after_load": _mass_estimate(rdyn[-1])}
    # the two posteriors differ only by the streamed kernels' reassociation:
    # the MPF particles after the first update, the mass estimate of every
    # step and the first steps' trajectory are held within PATH10_DRIFT
    n_both = min(n, ref["steps"])
    drift = {
        "mpf_particles_step0": float(np.abs(dyn[0] - rdyn[0]).max()),
        "mass_estimate_rel": float(np.max(np.abs(
            np.exp(dyn[:n_both].astype(np.float64)).mean(axis=(1, 2))
            / np.exp(rdyn[:n_both].astype(np.float64)).mean(axis=(1, 2))
            - 1.0))),
        "trajectory_m": float(np.abs(
            out["trajectory"][:PATH10_DRIFT_STEPS]
            - ref["trajectory"][:PATH10_DRIFT_STEPS]).max())}
    result["generic_mpf"]["drift"] = drift
    print(f"{label}, the generic MPF on the same seed: {plain_s:.3f} s, "
          f"{result['generic_mpf']} (limits {PATH10_DRIFT})")
    if (ref["crashed"], ref["success"]) != (out["crashed"], out["success"]):
        raise AssertionError(f"{label}: the generic MPF's outcome differs")
    for key, limit in PATH10_DRIFT.items():
        if not drift[key] <= limit:
            raise AssertionError(f"{label}: {key} drift {drift[key]:.3e} "
                                 f"from the generic MPF exceeds {limit}")
    return result


def phase_fused_mpf_path(dev):
    """Path 11: FusedMPF.optimize as bench/bench_all.py:169-206 runs it:
    the pendulum GaussianLikelihood(obs_std=0.1) over (length, mass),
    particles uniform(0.6, 1.3), obs0 (3, 0), initial bandwidth 0.2,
    conditioned updates (a random action and a noisy observation) at
    bw 0.3 x 20 SVGD steps; m = 2048 (gram), 8192 and 32768 (packed),
    and fuse_streams at 8192 and 32768."""
    import torch

    from dust_tpu_torch.inference import FusedMPF, GaussianLikelihood
    from dust_tpu_torch.models import PendulumModel

    lik = GaussianLikelihood(
        obs_std=0.1, model=PendulumModel(uncertain_params=("length",
                                                           "mass")))
    obs0 = torch.tensor([3.0, 0.0], device=dev)
    out = {}
    for label, m, updates, kw, kernels in PATH11_CASES:
        gen = torch.Generator(device=dev).manual_seed(SEED + 500)
        mpf = FusedMPF(lik, **kw)
        x0 = 0.6 + 0.7 * torch.rand((m, 2), generator=gen, device=dev)
        ms0 = mpf.init_state(x0, obs0, dim_a=1, bw=0.2)
        acts = -2.0 + 4.0 * torch.rand((updates + 1, 1), generator=gen,
                                       device=dev)
        obs = obs0 + 0.1 * torch.randn((updates + 1, 2), generator=gen,
                                       device=dev)

        def run(ms, rows):
            for i in rows:
                ms, _, _ = mpf.optimize(ms, acts[i], obs[i], bw=0.3,
                                        n_steps=20)
            return ms

        run(ms0, [updates])  # warm-up
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ms = run(ms0, range(updates))
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = _counts()
        first, per_step = kernels
        want = {first: updates * (1 if "fuse" in label else 20),
                per_step: 20 * updates}
        _check_counts(f"path 11 {label}", launches, want)
        if not torch.isfinite(ms.x).all() or \
                (ms.x - x0).abs().max().item() < 1e-4:
            raise AssertionError(f"path 11 {label}: non-finite or unmoved "
                                 f"particles")
        out[label] = {"m": m, "updates": updates, "seconds": elapsed,
                      "updates_per_s": updates / elapsed,
                      "launches": launches,
                      "posterior_mean": ms.x.mean(0).tolist()}
        print(f"path 11 (FusedMPF {label}): {updates} conditioned updates x "
              f"20 SVGD steps in {elapsed:.4f} s, "
              f"{out[label]['updates_per_s']:.2f} updates/s; posterior mean "
              f"(length, mass) {_fmt(out[label]['posterior_mean'])}; "
              f"launches {launches}")
    return out


def _k11_bound(m, d):
    """Per particle pair 7d + 2 float32 operations of the float32 form (the
    distance 3d, the scale, exp, two multiply-adds per dimension); x and
    score read once, phi written once."""
    return _bound(4 * (3 * m * d + 1), m * m * (7 * d + 2))


def _k12_ops(m, k, d):
    """Per (row, center) pair 5d + 4 (the distance 3d, the scale, the max
    test, exp, the normalizer, a multiply-add per dimension)."""
    return m * k * (5 * d + 4)


def _k12_bound(m, k, d):
    return _bound(4 * (2 * m * d + k * d + 1), _k12_ops(m, k, d))


def _k13_bound(m, d):
    """K11's and K12's operations at k == m and the SGD step; x, score and
    centers read once, x_new and gp_new written once."""
    return _bound(4 * (5 * m * d + 3),
                  m * m * (7 * d + 3) + _k12_ops(m, m, d) + 2 * m * d)


SDPA_BACKENDS = ("EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "FLASH_ATTENTION", "MATH")


def _sdpa_k12(x, centers, bw):
    """K12's function as one scaled_dot_product_attention call, the
    yardstick of `library_ms` (the port never calls it): softmax over k of
    q.k_k / bw^2 - |k_k|^2 / (2 bw^2), queries x - c_0, keys and values
    c - c_0 (the row term |x - c_0|^2 / (2 bw^2) cancels in the softmax),
    the head dimension zero-padded to 8; then (out - (x - c_0)) / bw^2.
    Returns the call and the name of the first backend of SDPA_BACKENDS
    that runs it."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    m, d = x.shape
    b2 = float(bw) ** 2
    q = x - centers[0]
    kv = centers - centers[0]
    qp = F.pad(q, (0, 8 - d))[None, None]
    kp = F.pad(kv, (0, 8 - d))[None, None]
    bias = (-(kv * kv).sum(dim=1) * (0.5 / b2)).view(1, 1, 1, -1)
    mask = bias.expand(1, 1, m, kv.shape[0])
    for name in SDPA_BACKENDS:
        def call(backend=getattr(SDPBackend, name)):
            with sdpa_kernel(backend):
                out = F.scaled_dot_product_attention(qp, kp, kp,
                                                     attn_mask=mask,
                                                     scale=1.0 / b2)
            return (out[0, 0, :, :d] - q) / b2
        try:
            call()
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return call, name
    raise RuntimeError("no scaled_dot_product_attention backend runs K12")


def phase_timing_slice4(dev, path8):
    """K10: path 8's 200-step sweep between CUDA events (median of 3), its
    plain version the one call path 8 timed; K11-K13 as phase 6 times
    K1/K2, at path 10's shape (K11a, K12a: m = 2048, d = 1) and path 11's
    (K11b, K11c, K12b, K13: m = 8192, d = 2); K12b and K13 also at
    m = 32768; K12's SDPA yardstick at K12a's and K12b's shapes."""
    import torch

    from dust_tpu_torch.ops import gmm, mpf_stream, svgd
    from dust_tpu_torch.ops import particle_episode as pe

    out = {}
    groups, seeds, masses, _ = _bench_particle_sweep(dev, MAIN_STEPS)
    bound = _k9_bound(MAIN_STEPS, path8["mpf_updates"], 4, 6, 64, 40, 50, 20,
                      _n_model(dev), episodes=path8["episodes"],
                      log_mix=True)
    out["particle_sweep_episode"] = {
        "ms": statistics.median(_event_ms(
            lambda: groups.run(seeds(1), masses), 3)),
        "plain_ms": path8["plain_ms"], "bound_ms": bound[0],
        "bound_by": bound[1], "bound_bytes": bound[2], "bound_ops": bound[3],
        "timed_as": "one call between CUDA events",
        "phase_clock": _phase_clock("K10 (path 8)",
                                    lambda: groups.run(seeds(1), masses),
                                    pe.phase_clock)}
    gen = torch.Generator(device=dev).manual_seed(SEED + 80)
    dt = lambda v: torch.tensor(v, device=dev)
    bw, pbw, lr = dt(0.3), dt(0.2), dt(1e-3)
    x1, s1, c1 = _stream_inputs(2048, 1, gen, dev)
    x2, s2, c2 = _stream_inputs(STREAM_M, 2, gen, dev)
    for name, kern, plain, bound in (
            ("svgd_phi", lambda: svgd.svgd_phi_streamed(x1, s1, bw),
             lambda: svgd.svgd_phi_plain(x1, s1, bw), _k11_bound(2048, 1)),
            ("gmm_prior_score",
             lambda: gmm.gmm_prior_score_streamed(x1, c1, pbw),
             lambda: gmm.gmm_prior_score_plain(x1, c1, pbw),
             _k12_bound(2048, 2048, 1)),
            ("svgd_phi_packed",
             lambda: svgd.svgd_phi_streamed_packed(x2, s2, bw),
             lambda: svgd.svgd_phi_plain(x2, s2, bw),
             _k11_bound(STREAM_M, 2)),
            ("svgd_phi_symm",
             lambda: svgd.svgd_phi_streamed_symm(x2, s2, bw),
             lambda: svgd.svgd_phi_plain(x2, s2, bw),
             _k11_bound(STREAM_M, 2)),
            ("gmm_prior_score_packed",
             lambda: gmm.gmm_prior_score_streamed_packed(x2, c2, pbw),
             lambda: gmm.gmm_prior_score_plain(x2, c2, pbw),
             _k12_bound(STREAM_M, STREAM_M, 2)),
            ("mpf_stream_step",
             lambda: mpf_stream.fused_mpf_stream_step(x2, s2, c2, bw, pbw,
                                                      lr),
             lambda: mpf_stream.mpf_stream_step_plain(x2, s2, c2, bw, pbw,
                                                      lr),
             _k13_bound(STREAM_M, 2))):
        runs = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            fn = kern if which == "kernel" else plain
            runs[which].append({"device_ms": _device_ms(fn),
                                "call_ms": _call_ms(fn, reps=30)})
        out[name] = {
            "ms": min(r["device_ms"] for r in runs["kernel"]),
            "plain_ms": min(r["device_ms"] for r in runs["plain"]),
            "runs": runs, "bound_ms": bound[0], "bound_by": bound[1],
            "bound_bytes": bound[2], "bound_ops": bound[3],
            "timed_as": "device time per call, 20 calls in one CUDA graph"}
    # K12's yardstick: one SDPA call at K12a's and K12b's shapes, held once
    # against the plain version
    for name, x, c in (("gmm_prior_score", x1, c1),
                       ("gmm_prior_score_packed", x2, c2)):
        call, backend = _sdpa_k12(x, c, pbw)
        _check_close(f"{name} SDPA yardstick ({backend})", call(),
                     gmm.gmm_prior_score_plain(x, c, pbw), **K12_TOL)
        out[name]["library_ms"] = _device_ms(call)
        out[name]["library"] = f"scaled_dot_product_attention, {backend}"
    # path 11's m = 32768 (fuse_streams spends most of its update in K13
    # there): the kernels alone, the plain [m, m] versions not timed
    x3, s3, c3 = _stream_inputs(STREAM_LARGE_M, 2, gen, dev)
    for name, fn, bound in (
            ("gmm_prior_score_packed",
             lambda: gmm.gmm_prior_score_streamed_packed(x3, c3, pbw),
             _k12_bound(STREAM_LARGE_M, STREAM_LARGE_M, 2)),
            ("mpf_stream_step",
             lambda: mpf_stream.fused_mpf_stream_step(x3, s3, c3, bw, pbw,
                                                      lr),
             _k13_bound(STREAM_LARGE_M, 2))):
        out[name]["m32768"] = {
            "ms": min(_device_ms(fn) for _ in range(2)),
            "bound_ms": bound[0], "bound_by": bound[1],
            "bound_bytes": bound[2], "bound_ops": bound[3]}
    for name, t in out.items():
        lib = (f", library {t['library_ms']:.4f} ms ({t['library']})"
               if "library_ms" in t else "")
        print(f"time {name}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms ({t['timed_as']}); bound "
              f"{t['bound_ms']:.2e} ms ({t['bound_by']}){lib}")
        if "m32768" in t:
            big = t["m32768"]
            print(f"time {name} m={STREAM_LARGE_M}: kernel {big['ms']:.4f} "
                  f"ms; bound {big['bound_ms']:.2e} ms ({big['bound_by']})")
    return out


# -- the paper's four pendulum cases, ScenarioSweep, the other models -----

PATH13_SCENARIOS = 8
# tests/test_cross_model.py's outcome checks: the pole within 0.1 rad of
# upright after 60 steps; the robot at most half its start distance from
# the waypoint after 200
CARTPOLE_MAX_THETA = 0.1
SKID_MAX_SHARE = 0.5


def phase_paper_cases(dev, config):
    """Path 12: the `svmpc`, `mppi` (exact model) and `disco_utf` cases of
    `build_pendulum_stack` at the demo width, MAIN_STEPS steps of
    PendulumSimulation each (`dust` is path 1). svmpc: each MultiDisco
    hook call one K1 launch, once per step, K2 never; mppi and disco_utf
    (5 sigma points x 128 samples): no kernel launch."""
    import torch

    from dust_tpu_torch.experiments import build_pendulum_stack
    from dust_tpu_torch.ops import rollout
    from dust_tpu_torch.simulation import PendulumSimulation

    cfg = copy.deepcopy(config)
    cfg["exp_params"]["fused_rollout"] = True
    true_params = [{"length": 1.0, "mass": 1.0}]
    out = {}
    for case in ("svmpc", "mppi", "disco_utf"):
        label = f"path 12 ({case})"
        gen = torch.Generator(device=dev).manual_seed(SEED)
        stack = build_pendulum_stack(cfg, gen, case=case, device=dev)
        ctrl = stack.controller
        if case == "disco_utf" and (ctrl._tf.pts, ctrl.n_actions,
                                    ctrl.n_pol) != (5, 128, 1):
            raise AssertionError(f"{label}: {ctrl._tf.pts} sigma points x "
                                 f"{ctrl.n_actions} samples x {ctrl.n_pol}")
        if (ctrl.fused_state_costs is None) != (case != "svmpc"):
            raise AssertionError(f"{label}: hook wired "
                                 f"{ctrl.fused_state_costs is not None}")
        hook_launches = []
        if case == "svmpc":
            hook = ctrl.fused_state_costs

            def counted_hook(*args, hook=hook):
                before = rollout.fused_pendulum_rollout_costs.launches
                res = hook(*args)
                hook_launches.append(
                    rollout.fused_pendulum_rollout_costs.launches - before)
                return res

            ctrl.fused_state_costs = counted_hook

        def run(steps):
            harness = PendulumSimulation(
                controller=ctrl, svmpc=stack.svmpc, mpf=stack.mpf,
                model=stack.model, steps=steps, warm_up=0,
                use_svmpc=stack.svmpc is not None, mpf_bw=stack.mpf_bw,
                mpf_steps=stack.mpf_steps,
                use_exact_model=(case == "mppi"), device=dev)
            return harness.run(stack.generator, true_params,
                               stack.init_state, stack.init_policies,
                               stack.policies_prior, stack.dynamics_prior,
                               stack.mpf_init)

        run(5)  # warm-up
        _reset_counts()
        hook_launches.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cols = run(MAIN_STEPS)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = _counts()
        want = {"pendulum_rollout_costs": MAIN_STEPS} \
            if case == "svmpc" else {}
        _check_counts(label, launches, want)
        want_calls = MAIN_STEPS if case == "svmpc" else 0
        if len(hook_launches) != want_calls or any(n != 1 for n in
                                                   hook_launches):
            raise AssertionError(
                f"{label}: {len(hook_launches)} hook calls, K1 launches "
                f"per call {sorted(set(hook_launches))}")
        for name in ("Cost", "Actions", "Position", "Speed"):
            if not np.isfinite(cols[name]).all():
                raise AssertionError(f"{label}: non-finite values in {name}")
        low = float(cols["Cost"][MAIN_STEPS // 2:].min())
        out[case] = {"steps": MAIN_STEPS, "seconds": elapsed,
                     "ms_per_step": 1e3 * elapsed / MAIN_STEPS,
                     "min_cost_second_half": low,
                     "final_cost": float(cols["Cost"][-1]),
                     "launches": launches, "hook_calls": len(hook_launches)}
        print(f"{label}: {MAIN_STEPS} MPC steps in {elapsed:.3f} s "
              f"({out[case]['ms_per_step']:.3f} ms per step); lowest cost "
              f"in steps {MAIN_STEPS // 2}-{MAIN_STEPS - 1}: {low:.6f}; "
              + (f"{len(hook_launches)} hook calls, each one K1 launch; "
                 if case == "svmpc" else "no hook call; ")
              + f"launches {launches}")
        # dust_tpu's same case swings up on the CPU at this width (the
        # lowest cost in steps 100-199 below SWINGUP_MAX_COST at seeds 0-2,
        # `python -m tests.test_torch_paper_cases`), so the port's must
        _check_swingup(label, low)
    return out


def phase_scenario_sweep_path(dev, config):
    """Path 13: ScenarioSweep over the `dust` stack on the kernel path (K1
    hook + FusedPendulumMPF, K2), PATH13_SCENARIOS scenarios x MAIN_STEPS
    steps, true (length, mass) drawn from the dynamics prior with a numpy
    seed. Scenario 0 must be bit-equal to one episode_fn run from its
    seed; a NaN true length must leave its scenario unhealthy and the
    others' bits alone."""
    import torch

    from dust_tpu_torch.experiments import build_pendulum_stack
    from dust_tpu_torch.inference import FusedPendulumMPF
    from dust_tpu_torch.parallel import ScenarioSweep, broadcast_scenarios
    from dust_tpu_torch.simulation import PendulumSimulation

    label = "path 13 (ScenarioSweep, K1 + K2)"
    cfg = copy.deepcopy(config)
    cfg["exp_params"]["fused_rollout"] = True
    gen = torch.Generator(device=dev).manual_seed(SEED)
    stack = build_pendulum_stack(cfg, gen, case="dust", device=dev)
    stack.mpf = FusedPendulumMPF.from_mpf(stack.mpf)
    harness = PendulumSimulation(
        controller=stack.controller, svmpc=stack.svmpc, mpf=stack.mpf,
        model=stack.model, steps=MAIN_STEPS, warm_up=0, mpf_bw=stack.mpf_bw,
        mpf_steps=stack.mpf_steps, device=dev)
    n = PATH13_SCENARIOS
    # the dynamics prior, Uniform(0.6, 1.3) over (length, mass)
    true = np.random.default_rng(SEED + 13).uniform(
        0.6, 1.3, size=(n, 2)).astype(np.float32)
    seeds = [SEED + 1300 + i for i in range(n)]
    init_obs = stack.init_state.reshape(1, -1)
    states = (stack.controller.init_state(stack.init_policies),
              stack.svmpc.init_state(stack.init_policies,
                                     stack.policies_prior),
              stack.mpf.init_state(stack.mpf_init, init_obs[0], 1))
    sweep = ScenarioSweep(harness, device=dev)

    def run(rows, lengths):
        k = len(rows)
        return sweep.run(
            [seeds[i] for i in rows],
            {"length": torch.tensor(lengths, device=dev),
             "mass": torch.tensor(true[rows, 1], device=dev)},
            init_obs.expand(k, 1, 2),
            *(broadcast_scenarios(st, k) for st in states))

    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run(list(range(n)), true[:, 0])
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = _counts()
    _check_counts(label, launches,
                  {"pendulum_rollout_costs": n * MAIN_STEPS,
                   "pendulum_mpf_optimize": n * MAIN_STEPS})
    healthy = out["healthy"].cpu().numpy()
    low = out["costs"][:, MAIN_STEPS // 2:].min(dim=1).values.cpu().numpy()
    result = {"scenarios": n, "steps": MAIN_STEPS, "seconds": elapsed,
              "solves_per_s": n * MAIN_STEPS / elapsed,
              "true_length_mass": true.tolist(), "launches": launches,
              "healthy_share": float(healthy.mean()),
              "mean_cost_healthy": float(out["mean_cost_healthy"]),
              "min_cost_second_half": low.tolist()}
    print(f"{label}: {n} scenarios x {MAIN_STEPS} steps in {elapsed:.3f} s "
          f"per sweep ({result['solves_per_s']:.1f} solves/s); healthy "
          f"share {result['healthy_share']}; mean_cost_healthy "
          f"{result['mean_cost_healthy']:.6f}; lowest cost in steps "
          f"{MAIN_STEPS // 2}-{MAIN_STEPS - 1} per scenario {_fmt(low)}; "
          f"launches {launches}")
    if not healthy.all():
        raise AssertionError(f"{label}: unhealthy scenarios {healthy}")
    for name in ("costs", "states", "actions"):
        if not torch.isfinite(out[name]).all():
            raise AssertionError(f"{label}: non-finite {name}")

    _, logs = harness.episode_fn(None)(
        torch.Generator(device=dev).manual_seed(seeds[0]),
        {"length": torch.tensor(true[0, 0], device=dev),
         "mass": torch.tensor(true[0, 1], device=dev)},
        init_obs, *states)
    for name, j in (("states", 0), ("actions", 1), ("costs", 2)):
        _check_equal(f"{label} scenario 0 {name} vs episode_fn",
                     out[name][0], logs[j])

    # NaN isolation: scenarios 0, 1 and 2 again, scenario 1's true length
    # NaN
    rows = [0, 1, 2]
    nan_out = run(rows, [true[0, 0], np.nan, true[2, 0]])
    nan_healthy = nan_out["healthy"].tolist()
    if nan_healthy != [True, False, True]:
        raise AssertionError(f"{label}: NaN run healthy {nan_healthy}")
    for k, i in ((0, 0), (2, 2)):
        for name in ("states", "actions", "costs"):
            _check_equal(f"{label} NaN run, scenario {i} {name}",
                         nan_out[name][k], out[name][i])
    result["nan_run_healthy"] = nan_healthy
    print(f"{label}: NaN true length in scenario 1: healthy {nan_healthy}, "
          f"scenarios 0 and 2 bit-equal to the first sweep")
    return result


def phase_cross_model(dev):
    """tests/test_cross_model.py's three scenarios on the card: MultiDisco
    balances the cart-pole (60 steps) and drives the skid-steer robot to
    its waypoint (200 steps, uncertain ICR offset), SVMPC composes with
    the cart-pole (one solve); no kernel launches."""
    import torch

    from dust_tpu_torch.controllers import MultiDisco
    from dust_tpu_torch.distributions import GMM, Uniform
    from dust_tpu_torch.inference import SVMPC, ExponentiatedUtility
    from dust_tpu_torch.models import CartPoleModel, SkidSteerRobot
    from dust_tpu_torch.spaces import Box

    label = "cross-model phase"
    _reset_counts()
    t0 = time.perf_counter()
    model = CartPoleModel(dt=0.02, device=dev)

    def pole_cost(s, a=None, **_):
        return 10.0 * s[..., 2] ** 2 + 0.1 * s[..., 0] ** 2 \
            + 0.1 * s[..., 3] ** 2

    ctrl = MultiDisco(
        observation_space=Box(dim=4), action_space=Box(dim=1, low=-1.0,
                                                        high=1.0),
        hz_len=20, n_policies=1, action_samples=128,
        a_cov=0.25 * torch.eye(1), inst_cost_fn=pole_cost,
        term_cost_fn=pole_cost, params_sampling="none", device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    dstate = ctrl.init_state()
    obs = torch.tensor([[0.0, 0.0, 0.15, 0.0]], device=dev)
    for _ in range(60):
        dstate, *_ = ctrl.forward(dstate, obs, model, generator=gen)
        dstate, act = ctrl.step(dstate, strategy="average")
        obs = model.step(obs, act[0][None])
    theta = float(obs[0, 2])
    pole_finite = bool(torch.isfinite(obs).all())

    robot = SkidSteerRobot(delta_t=0.1, uncertain_params=("x_icr",),
                           device=dev)
    target = torch.tensor([1.0, 0.5], device=dev)

    def goal_cost(s, a=None, **_):
        return ((s[..., :2] - target) ** 2).sum(dim=-1)

    ctrl = MultiDisco(
        observation_space=Box(dim=5), action_space=Box(dim=2, low=-0.5,
                                                        high=0.5),
        hz_len=15, n_policies=1, action_samples=64, params_samples=4,
        a_cov=0.04 * torch.eye(2), inst_cost_fn=goal_cost,
        term_cost_fn=goal_cost, params_sampling=True, device=dev)
    icr = Uniform(torch.tensor([0.1], device=dev),
                  torch.tensor([0.3], device=dev), event_ndims=1)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    dstate = ctrl.init_state()
    obs = torch.zeros((1, 5), device=dev)
    sim_icr = {"x_icr": torch.full((1, 1), 0.2, device=dev)}
    d0 = float(torch.linalg.norm(obs[0, :2] - target))
    for _ in range(200):
        dstate, *_ = ctrl.forward(dstate, obs, robot, icr, gen)
        dstate, act = ctrl.step(dstate, strategy="average")
        obs = robot.step(obs, act[0][None], sim_icr)
    d1 = float(torch.linalg.norm(obs[0, :2] - target))

    def upright_cost(s, a=None, **_):
        return 10.0 * s[..., 2] ** 2 + 0.1 * s[..., 3] ** 2

    m, horizon = 2, 12
    ctrl = MultiDisco(
        observation_space=Box(dim=4), action_space=Box(dim=1, low=-1.0,
                                                        high=1.0),
        hz_len=horizon, n_policies=m, action_samples=32,
        a_cov=0.25 * torch.eye(1), inst_cost_fn=upright_cost,
        term_cost_fn=upright_cost, params_sampling="none", device=dev)
    lik = ExponentiatedUtility(alpha=1.0, n_samples=32, controller=ctrl,
                               model=model)
    svmpc = SVMPC(likelihood=lik, n_particles=m, lr=0.5)
    theta0 = torch.zeros((m, horizon, 1), device=dev)
    prior = GMM.from_cov(theta0, torch.ones(m, device=dev),
                         0.25 * torch.eye(1, device=dev))
    sv = svmpc.init_state(theta0, prior)
    sv, _, costs = svmpc.optimize(
        sv, ctrl.init_state(), torch.tensor([[0.0, 0.0, 0.1, 0.0]],
                                            device=dev),
        None, torch.Generator(device=dev).manual_seed(SEED + 2))
    sv, a_seq, _ = svmpc.forward(sv, costs)
    svmpc_finite = bool(torch.isfinite(a_seq).all()
                        and torch.isfinite(costs).all())
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = _counts()
    _check_counts(label, launches, {})
    result = {"cartpole_theta": theta, "cartpole_finite": pole_finite,
              "skid_distance_start": d0, "skid_distance_end": d1,
              "svmpc_cartpole_finite": svmpc_finite, "seconds": elapsed}
    print(f"{label}: cart-pole theta after 60 steps {theta:.5f} rad "
          f"(|theta| < {CARTPOLE_MAX_THETA}); skid-steer distance to the "
          f"waypoint {d0:.4f} -> {d1:.4f} m (< {SKID_MAX_SHARE} x start); "
          f"SVMPC on the cart-pole finite {svmpc_finite}; {elapsed:.3f} s; "
          f"no kernel launched")
    if not (pole_finite and abs(theta) < CARTPOLE_MAX_THETA):
        raise AssertionError(f"{label}: the pole fell (theta {theta})")
    if not d1 < SKID_MAX_SHARE * d0:
        raise AssertionError(f"{label}: no progress to the waypoint "
                             f"({d0} -> {d1})")
    if not svmpc_finite:
        raise AssertionError(f"{label}: non-finite SVMPC plan or costs")
    return result


def _n_model(dev):
    """Floats of the demo model array the particle kernels read."""
    from dust_tpu_torch.ops import particle_rollout as pr

    _, stack = _particle_stack(dev)
    model = stack.model
    return pr.model_tensor(_pkw(model), model.dt, model.max_acc,
                           model.max_speed, dev).numel()


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from dust_tpu_torch.experiments import PENDULUM_DEMO_CONFIG

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = _nvidia_smi()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    build = phase_build()
    k1_err = phase_k1(dev)
    k2_err = phase_k2(dev)
    main_path = phase_main_path(dev, PENDULUM_DEMO_CONFIG)
    loop_err = phase_kernel_vs_plain(dev, PENDULUM_DEMO_CONFIG)
    times = phase_timing(dev)
    k3_err = phase_k3(dev)
    path2 = phase_main_path(dev, PENDULUM_DEMO_CONFIG, fused_solve=True)
    print(f"ms per MPC step: path 1 (K1 + K2) {main_path['ms_per_step']:.3f}"
          f", path 2 (K3 + K2) {path2['ms_per_step']:.3f}")
    k3_loop_err = phase_k3_vs_plain(dev, PENDULUM_DEMO_CONFIG)
    k4_err = phase_k4(dev)
    path3 = phase_episode_path(dev, PENDULUM_DEMO_CONFIG)
    k5_err = phase_k5(dev)
    path4 = phase_sweep_path(dev, PENDULUM_DEMO_CONFIG)
    k5_err = max(k5_err, path4["layout_max_abs_err"])
    times.update(phase_timing_slice2(dev, PENDULUM_DEMO_CONFIG))

    k6_err, occupancy = phase_k6(dev)
    k7_err = phase_k7(dev)
    path5 = phase_particle_path(dev)
    loop5_err = phase_particle_kernel_vs_plain(dev)
    k8_err = phase_k8(dev)
    path6 = phase_particle_path(dev, fused_solve=True)
    loop6_err = phase_particle_kernel_vs_plain(dev, fused_solve=True)
    print(f"ms per MPC step: path 5 (K6 + K7) {path5['ms_per_step']:.3f}, "
          f"path 6 (K8 + K7) {path6['ms_per_step']:.3f}")
    k9_err = phase_k9(dev)
    path7 = phase_particle_episode_path(dev)
    times.update(phase_timing_slice3(dev, path7))

    k10_err = phase_k10(dev)
    path8 = phase_particle_sweep_path(dev)
    k10_err = max(k10_err, path8["layout_max_abs_err"])
    path9 = phase_particle_scenario_path(dev)
    stream_errs = phase_stream_kernels(dev)
    path10 = phase_particle_large_path(dev)
    path11 = phase_fused_mpf_path(dev)
    times.update(phase_timing_slice4(dev, path8))

    print(f"path 12 (dust): path 1 above, lowest cost in steps "
          f"{MAIN_STEPS // 2}-{MAIN_STEPS - 1} "
          f"{main_path['min_cost_second_half']:.6f}")
    path12 = phase_paper_cases(dev, PENDULUM_DEMO_CONFIG)
    path13 = phase_scenario_sweep_path(dev, PENDULUM_DEMO_CONFIG)
    cross = phase_cross_model(dev)

    kernels = []
    for name, source, replaces, err, path in (
            ("pendulum_rollout_costs", "dust_tpu_torch/csrc/pendulum_rollout.cu",
             "dust_tpu/ops/pallas_rollout.py:92", k1_err, main_path),
            ("pendulum_mpf_optimize", "dust_tpu_torch/csrc/pendulum_mpf.cu",
             "dust_tpu/ops/pallas_mpf.py:169", k2_err, main_path),
            ("pendulum_solve", "dust_tpu_torch/csrc/pendulum_solve.cu",
             "dust_tpu/ops/pallas_solve.py:397", k3_err, path2),
            ("pendulum_episode", "dust_tpu_torch/csrc/pendulum_episode.cu",
             "dust_tpu/ops/pallas_episode.py:795", k4_err, path3),
            ("pendulum_sweep_episode",
             "dust_tpu_torch/csrc/pendulum_episode.cu",
             "dust_tpu/ops/pallas_sweep_episode.py:1319", k5_err, path4),
            ("particle_rollout_costs",
             "dust_tpu_torch/csrc/particle_rollout.cu",
             "dust_tpu/ops/pallas_particle_rollout.py:253", k6_err, path5),
            ("particle_mpf_optimize", "dust_tpu_torch/csrc/particle_mpf.cu",
             "dust_tpu/ops/pallas_particle_mpf.py:141", k7_err, path5),
            ("particle_solve", "dust_tpu_torch/csrc/particle_solve.cu",
             "dust_tpu/ops/pallas_solve.py:538", k8_err, path6),
            ("particle_episode", "dust_tpu_torch/csrc/particle_episode.cu",
             "dust_tpu/ops/pallas_particle_episode.py:620", k9_err,
             path7),
            ("particle_sweep_episode",
             "dust_tpu_torch/csrc/particle_episode.cu",
             "dust_tpu/ops/pallas_particle_sweep_episode.py:1148", k10_err,
             path8),
            ("svgd_phi", "dust_tpu_torch/csrc/svgd_phi.cu",
             "dust_tpu/ops/pallas_svgd.py:100", stream_errs["svgd_phi"],
             path10),
            ("svgd_phi_packed", "dust_tpu_torch/csrc/svgd_phi.cu",
             "dust_tpu/ops/pallas_svgd.py:197",
             stream_errs["svgd_phi_packed"], path11["m=8192"]),
            # K11c is a kernel of no path (no FusedMPF layout calls it): its
            # launches are read from path 11's packed run, where they stay 0
            ("svgd_phi_symm", "dust_tpu_torch/csrc/svgd_phi.cu",
             "dust_tpu/ops/pallas_svgd.py:310", stream_errs["svgd_phi_symm"],
             path11["m=8192"]),
            ("gmm_prior_score", "dust_tpu_torch/csrc/gmm_score.cu",
             "dust_tpu/ops/pallas_gmm.py:97", stream_errs["gmm_prior_score"],
             path10),
            ("gmm_prior_score_packed", "dust_tpu_torch/csrc/gmm_score.cu",
             "dust_tpu/ops/pallas_gmm.py:201",
             stream_errs["gmm_prior_score_packed"], path11["m=8192"]),
            ("mpf_stream_step", "dust_tpu_torch/csrc/mpf_stream.cu",
             "dust_tpu/ops/pallas_mpf_stream.py:155",
             stream_errs["mpf_stream_step"],
             path11["m=8192 fuse_streams"])):
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": path["launches"][name],
            "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t.get("library_ms"),
        })

    report = {
        "card": card, "torch": torch.__version__,
        "cuda": torch.version.cuda, "build_seconds": build["seconds"],
        "build_log": build["log"], "main_path": main_path,
        "kernel_vs_plain_path_max_abs_err": loop_err, "timing": times,
        "path2_k3": path2, "k3_path_vs_plain_path_max_abs_err": k3_loop_err,
        "path3_k4_episode": path3, "path4_k5_sweep": path4,
        "k6_occupancy": occupancy, "path5_k6_k7": path5,
        "k6_path_vs_plain_path_max_abs_err": loop5_err,
        "path6_k8_k7": path6,
        "k8_path_vs_plain_path_max_abs_err": loop6_err,
        "path7_k9_episode": path7, "path8_k10_sweep": path8,
        "path9_particle_scenario_sweep": path9,
        "path10_particle_large_fused_mpf": path10,
        "path11_fused_mpf": path11, "path12_paper_cases": path12,
        "path13_scenario_sweep": path13, "cross_model": cross,
        "kernels": kernels,
    }
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_report.json").write_text(
        json.dumps(report, indent=1))

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
