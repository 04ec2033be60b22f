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
     8192, 32768 and with fuse_streams at 8192 and 32768, and with Adam
     (optimizer="adam") at 2048 (K11a + K12a) and 8192 (K11b + K12b):
     conditioned updates per second (Adam's beside SGD's) and the
     launches of each layout;
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
     waypoint, SVMPC on the cart-pole; no kernel launch;
 34. the multi-device layer (`dust_tpu_torch.parallel`) on an NCCL process
     group at world size 1 (NCCL refuses two ranks on one card; the CPU
     tests hold world sizes 2 and 4 on gloo): a cpu mesh on it raises;
     make_sharded_svgd_phi, make_sharded_gmm_score and ShardedMPF.step at
     m = 2048 and 8192 against svgd_phi_reference, GMM.score and MPF.step;
     make_sharded_disco_forward on the demo controller (8 x 128 x 3, H 30,
     one K1 launch) against MultiDisco.forward, two collectives per call;
     ShardedSVMPC.svgd_step against SVMPC.svgd_step on injected noise, at
     the JAX tests' tolerances; MegakernelGroupSweep(mesh=) at path 4's
     shape in one K5 launch, bit-equal to path 4's launch, and each
     quarter of its groups in a launch of its own bit-equal to the same
     groups; ScenarioSweep(mesh=) over path 13's scenarios, bit-equal to
     path 13's outputs; ParticleScenarioSweep(mesh=) over path 9's first
     two scenarios (K6 + K7), bit-equal to path 9's; the process group
     destroyed at the end;
 35. tuning: parallel_lr_sweep on the `dust` stack (K1 hook + K2), four
     rates x 100 steps, each lane bit-equal to the sweep with that rate
     alone; successive_halving over pendulum_sweep_tail_objective (K5)
     and over particle_sweep_asha_objective (K10), 4 trials each in rungs
     of 4, 2 and 1: seconds, launches per objective call (one per trial),
     the chosen configuration;
 36. checkpoints: path 1's carry saved at step 100 with its CUDA generator,
     loaded and run to step 200, bit-equal to 200 uninterrupted steps;
     ten more steps timed by a Stopwatch.
 37. the entry points (`dust_tpu_torch.demo`) in-process, on the default
     device (the card), each with the launch counts set to 0 just before
     and read just after: `pendulum_example` (four cases, 200 steps, one
     prior-drawn parameter set, `--save`) launches no kernel, its costs
     are finite and its printed summaries equal the numbers from its
     columns; `data.pkl` holds the rows and `config.yaml` hashes to the
     CPU test's text (yaml.dump's); `plots_html.html_mean_results`
     writes the page of its columns; then `run_cases` per case with
     length 1.0, mass 1.0 and `fused_rollout: true`: every case swings
     up, dust and svmpc launch 200 K1 each, mppi and disco_utf none;
     `particle_example --steps 200` (its line parses, costs and the mass
     estimate finite); `sweep_example` for both tasks at its defaults (16
     scenarios, 100 steps): two K5 / K10 launches, every row equal to the
     demo's row function on direct sweep calls on the same seeds (a check
     of its seeds, grouping and printing); `pendulum_tuning --tail 9
     --seeds 1` (one K5 per trial evaluation), `--trials 2` and
     `--parallel-lr 4` (none) and
     `particle_tuning --sweep --trials 4 --steps 200` (one K10 per trial
     evaluation and held-out seed). plots.py and `--render` need
     matplotlib and are not called;
 38. K11a and K12a on their general walk (d > 8, the register-tiled
     column-split walk of csrc/stream_tile2d.cuh) against their plain
     versions at d = 9, 16, 60, 64, 127, 128, 129, 256 and 1024, m = 2048
     and 2049, K12 with k = m and 130 centers, MPF-like and normal
     inputs, normal inputs offset by 2000 at d = 64 and 256, every call
     twice with the same bits; their times at (m, d) = (2048, 16 / 64 /
     128 / 256 / 1024) and (8192, 64) beside the bounds, the plain
     versions' and, for K12a, one SDPA call's with its backend, each split
     by phase under the walk's clocked build; one cuBLAS float32 GEMM, the
     card's practical float32 rate; K11a and
     K12a at d = 60 hashed against D60_SHA256 (the general walk's bits)
     and at d = 2 against D2_SHA256 (the d <= 8 walk's, unchanged since
     commit 464b649);
 39. path 14: path 1's `dust` stack at full width (8 draws x 128 samples
     x 3 policies, H 30; 50 MPF particles x 20 steps, 200 MPC steps) with
     SVMPC(optimizer="adam", lr=0.1) on the K1 hook and
     FusedMPF(optimizer="adam") at the config's MPF rate on K11a + K12a:
     one K1 per hook call and 20 each of K11a and K12a per step, every
     value finite, the lowest cost printed (swing-up reported, not
     required: no configuration tunes Adam); then the kernel path against
     the plain path (rollout loop + autograd MPF, both with Adam) for 10
     steps re-synced per step, as phase 5;
 40. path 15: FusedMPF.optimize over d = 64 and 256 parameters (an
     isotropic Gaussian likelihood of the parameters, m = 2048, SGD, 20
     SVGD steps per conditioned update): 20 K11a and 20 K12a per update on
     their general walk, the particles finite and moved, updates/s;
 41. K14 (the cart-pole sweep, `experiments.CARTPOLE_DEMO_CONFIG`):
     against its plain version on the card after 1 and 3 steps at path
     16's layout, at K14_TOLS; path 16: the benchmark cell's shape, 8
     groups x 16 scenarios x 2 chains x 200 steps, in one K14 launch
     through MegakernelGroupSweep, every value finite, the same seeds the
     same bits; its device ms per call (one launch between CUDA events,
     median of 3) beside the bound from perfbench/cartpole_counts.py and
     the plain version's one call; one more call under its clocked build;
     the share of episodes upright (|th| < 0.2 rad, th wrapped) at step
     99, before the tip load, and at step 199 (reported, not required).
 42. the branch-free sin/cos and division of K14's rollouts
     (`csrc/cartpole_math.cuh`), built on their own with the library's
     flags (`csrc/checks/cartpole_math_check.cu`): fast_sincosf bit for
     bit sincosf (both outputs) and its cosine cosf over every float with
     |x| < 105615; fast_div bit for bit `/` over 1e9 pairs across its
     whole range and 1e9 over K14's (numerator in [-1024, 1024],
     denominator in [1/32, 8]); the edges: the ranges' ends, +-0,
     subnormals, +-inf and NaN fail the range tests (the fallback), and
     every value inside them is the library's; then K14's fallback: path
     16's layout, 20 steps from a start angle of 2e5 rad (past the fast
     range), every rollout chunk-step counted as a fallback, every value
     finite (chip_compare.py holds its bits to the parent's).
 43. K15 (the skid-steer sweep, `experiments.SKID_STEER_DEMO_CONFIG`):
     against its plain version on the card after 1 and 3 steps at path
     17's layout, at K15_TOLS; path 17: the benchmark cell's shape, 8
     groups x 8 scenarios x 4 chains x 200 steps, in one K15 launch
     through MegakernelGroupSweep, every value finite, the same seeds the
     same bits; its device ms per call (one launch between CUDA events,
     median of 7) beside the bound from perfbench/skid_steer_counts.py and
     the plain version's one call; one more call under its clocked build;
     the share of episodes that reached the target and that crashed by
     step 199 (reported, not required); then K15's fallback: path 17's
     layout, 5 steps from a heading of 2e5 rad (past the fast sin/cos),
     every rollout step counted as a fallback, every value finite.

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
# K14 against its plain version: the same arithmetic but the MPF loop's
# ex2.approx, bit-equal after one step but the MPF; K4's tolerances by the
# kind of value (positions and angles as th, speeds as om), but the
# bandwidths: the MPF's rounding moves the draws, and through the rollouts
# the plans and their Silverman bandwidth, 1e-5 after 3 steps (NVIDIA H100
# 80GB HBM3, 700 W), and the MPF's bandwidth with its particles
K14_TOLS = dict(x=1e-5, x_dot=1e-4, th=1e-5, th_dot=1e-4, action=1e-4,
                cost=1e-3, bw_sv=1e-4, bw_mpf=1e-5, theta=1e-3, a_mat=5e-3,
                mpf_x=1e-5)
# K15 against its plain version: the same arithmetic but the MPF loop's
# ex2.approx, bit-equal after one step but the MPF; K14's tolerances by
# the kind of value (positions as x, the plans as theta), but the wheel
# speeds, the speeds they give and the heading they turn: the MPF's
# rounding moves the draws and through the rollouts the plans, whose first
# values are the wheel speeds (1.2e-4 after 3 steps; the heading 1.8e-5;
# NVIDIA H100 80GB HBM3, 700 W), so these take the plans' 1e-3 and the
# heading 1e-4; the MPF particles, three log-space values each, 1e-4
# (1.3e-5 after 3 steps)
K15_TOLS = dict(x=1e-5, y=1e-5, th=1e-4, v=1e-3, omega=1e-3, a_r=1e-3,
                a_l=1e-3, cost=1e-3, bw_sv=1e-4, bw_mpf=1e-5, theta=1e-3,
                a_mat=5e-3, mpf_x=1e-4)
SKID_GROUPS, SKID_SC, SKID_CHAINS = 8, 8, 4
# a cart-pole episode is upright at a step where its wrapped angle is
# within this many radians of 0 (a sanity reading, not a gate)
UPRIGHT_RAD = 0.2
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
# path 14: SVMPC's Adam rate, that of tests/test_svmpc_sharded.py:126
ADAM_SVMPC_LR = 0.1


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


def _with_adam(stack, fused):
    """Path 14's optimizers on a built `dust` stack: SVMPC with Adam at
    ADAM_SVMPC_LR (the rate of tests/test_svmpc_sharded.py:126's
    optax.adam), the MPF with Adam at the config's MPF rate, as
    FusedMPF (K11a + K12a) where `fused`, else the autograd MPF."""
    from dust_tpu_torch.inference import FusedMPF
    from dust_tpu_torch.inference.optim import make_optimizer

    stack.svmpc.optimizer = make_optimizer("adam", ADAM_SVMPC_LR)
    stack.mpf.optimizer = make_optimizer("adam", stack.mpf.lr)
    if fused:
        mpf = stack.mpf
        stack.mpf = FusedMPF(mpf.likelihood, optimizer=mpf.optimizer,
                             bw_scale=mpf.bw_scale, n_steps=mpf.n_steps)
    return stack


def _kernel_harness(config, arrays, dev, fused, steps, fused_solve=False,
                    adam=False):
    """A stack and harness on the kernel path (fused=True: K1 hook, or K3
    with fused_solve=True, + FusedPendulumMPF; with adam=True K1 +
    FusedMPF, both optimizers Adam) or the plain path (rollout loop +
    autograd MPF), wired around the same initial arrays, as bench.py wires
    the JAX stack."""
    from dust_tpu_torch.experiments import assemble_stack
    from dust_tpu_torch.inference import FusedPendulumMPF
    from dust_tpu_torch.simulation import PendulumSimulation

    cfg = copy.deepcopy(config)
    cfg["exp_params"]["fused_rollout"] = fused
    cfg["exp_params"]["fused_solve"] = fused and fused_solve
    stack = assemble_stack(cfg, arrays, case="dust", device=dev)
    if adam:
        _with_adam(stack, fused)
    elif fused:
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
        cartpole_sweep_episode,
        episode,
        gmm,
        mpf,
        mpf_stream,
        particle_episode,
        particle_mpf,
        particle_rollout,
        particle_sweep_episode,
        rollout,
        skid_steer_sweep_episode,
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
        "cartpole_sweep_episode":
            cartpole_sweep_episode.fused_cartpole_sweep_groups,
        "svgd_phi": svgd.svgd_phi_streamed,
        "svgd_phi_packed": svgd.svgd_phi_streamed_packed,
        "svgd_phi_symm": svgd.svgd_phi_streamed_symm,
        "gmm_prior_score": gmm.gmm_prior_score_streamed,
        "gmm_prior_score_packed": gmm.gmm_prior_score_streamed_packed,
        "mpf_stream_step": mpf_stream.fused_mpf_stream_step,
        "skid_steer_sweep_episode":
            skid_steer_sweep_episode.fused_skid_steer_sweep_groups,
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


def phase_main_path(dev, config, fused_solve=False, adam=False):
    """Path 1 (fused_solve=False): K1 hook + FusedPendulumMPF. Path 2
    (fused_solve=True): FusedPendulumSVMPC (K3) + FusedPendulumMPF; the
    K1 hook stays wired and must not launch. Path 14 (adam=True): the K1
    hook and FusedMPF (K11a + K12a), SVMPC and MPF both stepping by Adam
    (`_with_adam`); no swing-up is required (no configuration tunes
    Adam), the lowest cost is reported."""
    import torch

    from dust_tpu_torch.experiments import build_pendulum_stack
    from dust_tpu_torch.inference import FusedPendulumMPF
    from dust_tpu_torch.ops import rollout
    from dust_tpu_torch.simulation import PendulumSimulation

    label = ("path 14 (K1 + K11a + K12a, Adam)" if adam else
             "path 2 (K3 + K2)" if fused_solve else "main path")
    cfg = copy.deepcopy(config)
    cfg["exp_params"]["fused_rollout"] = True
    cfg["exp_params"]["fused_solve"] = fused_solve
    gen = torch.Generator(device=dev).manual_seed(SEED)
    stack = build_pendulum_stack(cfg, gen, case="dust", device=dev)
    if adam:
        _with_adam(stack, fused=True)
    else:
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
    if adam:
        n_mpf = MAIN_STEPS * stack.mpf_steps
        want = {solve_kernel: MAIN_STEPS, "svgd_phi": n_mpf,
                "gmm_prior_score": n_mpf}
    else:
        want = {solve_kernel: MAIN_STEPS,
                "pendulum_mpf_optimize": MAIN_STEPS}
    _check_counts(label, launches, want)
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
    if adam:
        result["lowest_cost"] = float(cols["Cost"].min())
        result["swung_up"] = second_half_min < SWINGUP_MAX_COST
        print(f"{label}: lowest cost {result['lowest_cost']:.4f}; swing-up "
              f"(reported, not required) {result['swung_up']}")
    else:
        _check_swingup(label, second_half_min)
    return result


def _check_swingup(label, low):
    if not low < SWINGUP_MAX_COST:
        raise AssertionError(f"{label}: no swing-up (lowest cost in the "
                             f"second half {low:.4f})")


def phase_kernel_vs_plain(dev, config, adam=False):
    """The kernel path (path 1, or path 14 with adam=True) against the
    plain path for COMPARE_STEPS steps, the plain side re-synced to the
    kernel side's carry (the optimizers' states included) every step."""
    import torch

    from dust_tpu_torch.experiments import draw_stack_arrays
    from dust_tpu_torch.ops.bandwidth import silvermans_rule

    arrays = draw_stack_arrays(
        config, torch.Generator(device=dev).manual_seed(SEED + 3), "dust",
        dev)
    k_stack, k_harness = _kernel_harness(config, arrays, dev, True,
                                         COMPARE_STEPS, adam=adam)
    p_stack, p_harness = _kernel_harness(config, arrays, dev, False,
                                         COMPARE_STEPS, adam=adam)
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
    path = "path 14 (Adam) " if adam else ""
    for name, pairs in (("action", actions), ("MPF particles", particles)):
        got = torch.stack([p[0] for p in pairs])
        want = torch.stack([p[1] for p in pairs])
        worst = max(worst,
                    _check_close(f"{path}kernel vs plain path, {name}, "
                                 f"steps 0-4", got[:5], want[:5],
                                 **EARLY_TOL))
        worst = max(worst,
                    _check_close(f"{path}kernel vs plain path, {name}, "
                                 f"{COMPARE_STEPS} steps", got, want,
                                 **RUN_TOL))
    if adam:
        from dust_tpu_torch.inference.optim import AdamState

        for what, state in (("SVMPC", k_carry[3]), ("MPF", k_carry[4])):
            if not isinstance(state.opt_state, AdamState):
                raise AssertionError(f"path 14: the {what} carry holds no "
                                     f"Adam state")
        print(f"path 14: Adam counts after {COMPARE_STEPS} steps: SVMPC "
              f"{k_carry[3].opt_state.count}, MPF "
              f"{k_carry[4].opt_state.count}")
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
              "launches": launches, "layout_max_abs_err": layout_err,
              "out": out}
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
    """`calls` more calls of fn (a K2, K3, K4/K5, K6, K7, K8, K9/K10 or
    K11a/K12a general-walk launch) under the kernel's clocked build
    (`clock`, an `ops/phase_clock.PhaseClock`):
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
    out = clock.summary(rows, steps, per=per)
    print(f"{label} per-phase clock, us per {per} (mean of {out['blocks']} "
          f"blocks; share): " + ", ".join(
              f"{k} {v[f'us_per_{per}']:.2f} ({100 * v['share']:.1f}%)"
              for k, v in out["phases"].items())
          + f"; the loop {out[f'loop_us_per_{per}']:.2f} us per {per}, "
          f"{out['ns_per_cycle']:.4f} ns per cycle")
    return out


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
    # Adam on the two-kernel layouts (the packed one at 8192)
    ("m=2048 adam", 2048, 10, dict(lr=1e-3, optimizer="adam"),
     ("gmm_prior_score", "svgd_phi")),
    ("m=8192 adam", 8192, 10, dict(lr=1e-3, optimizer="adam"),
     ("gmm_prior_score_packed", "svgd_phi_packed")),
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


def _path9_setup(dev):
    """Path 9's stack (the particle demo stack with the K6 hook and
    FusedParticleMPF), episode keywords, episode and sweep arguments: 8
    scenarios, true masses linspace(1.5, 3.0, 8), one seed each."""
    import torch

    from dust_tpu_torch.inference import FusedParticleMPF
    from dust_tpu_torch.parallel import broadcast_scenarios
    from dust_tpu_torch.simulation import particle_episode_fn

    _, stack = _particle_stack(dev, fused_rollout=True)
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
    return stack, kw, episode, args


def phase_particle_scenario_path(dev):
    """Path 9: ParticleScenarioSweep over `particle_episode_fn` with the
    K6 hook and FusedParticleMPF (K7), 8 scenarios, true masses
    linspace(1.5, 3.0, 8) (bench/bench_all.py:307-357), MAIN_STEPS
    steps; every scenario against `run_particle_episode` on the same
    generator seed."""
    import torch

    from dust_tpu_torch.parallel import ParticleScenarioSweep
    from dust_tpu_torch.simulation import run_particle_episode

    label = "path 9 (ParticleScenarioSweep, K6 + K7)"
    stack, kw, episode, args = _path9_setup(dev)
    seeds, _, _, (svstate, *_), (mstate, *_), masses = args
    n = len(seeds)
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
    result["out"] = out
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
    # general walk (stream_tile2d.cuh), two calls bit-equal
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


# phase 38: K11a and K12a on their general walk (d > 8,
# csrc/stream_tile2d.cuh) against their plain versions at every d of
# WIDE_D, m = 2048 and 2049 (a row count on no tile), K12 with k = m and
# 130 centers; the plain versions in row chunks of WIDE_ROWS rows (their
# per-dimension [rows, m] terms at d = 1024 take 1 GB a chunk); the inputs
# offset by 2000 at WIDE_OFFSET_D
WIDE_D = (9, 16, 60, 64, 127, 128, 129, 256, 1024)
WIDE_M = (2048, 2049)
WIDE_K = (None, 130)   # None: k = m
WIDE_OFFSET_D = (64, 256)
WIDE_ROWS = 128
# the timed shapes: bench/bench_svgd.py:54's (2048, 64) and (8192, 64), and
# m = 2048 at d = 16, 128, 256 and 1024
WIDE_TIMED = ((2048, 16), (2048, 64), (2048, 128), (2048, 256),
              (2048, 1024), (8192, 64))
# the general walk's bits at d = 60 (SHA-256 of K11a's and K12a's outputs
# from `_d60_sha256`'s inputs) as the register-tiled walk of
# stream_tile2d.cuh gave them on an NVIDIA H100 80GB HBM3 (chip_compare.py's
# "k11_k12_d60_sha256" is the same hash): a change to the walk's arithmetic
# or summation order changes it
D60_SHA256 = ("1632e719c229fc7ff5630f6d6d2a86faba2900967df440162c2cfb46"
              "b6407f1f")
# the d <= 8 walk's bits (stream_split.cuh) at d = 2, m = 2048 on path 11's
# kind of inputs (`_d2_sha256`), as the kernels of commit 464b649 gave them
# on an NVIDIA H100 80GB HBM3 (chip_compare.py's "k11_k12_d2_sha256")
D2_SHA256 = ("6390b44bb12804a64a13efc3c32ea3d4427b537e2329275e5f7538a5"
             "6d351a4e")


def _hash_outputs(x, s, c, bw, pbw):
    """SHA-256 of K11a's and K12a's outputs on these inputs."""
    import hashlib

    from dust_tpu_torch.ops import gmm, svgd

    h = hashlib.sha256()
    for out in (svgd.svgd_phi_streamed(x, s, bw),
                gmm.gmm_prior_score_streamed(x, c, pbw)):
        h.update(out.cpu().numpy().tobytes())
    return h.hexdigest()


def _d60_sha256(dev):
    """K11a and K12a at d = 60 on numpy-seeded inputs (m = 300, k = 130;
    bandwidths 0.7 and 0.4 times sqrt(d)), hashed: the same code as
    chip_compare.py's, so that the two trees can be held bit for bit."""
    import torch

    rng = np.random.default_rng(60)
    x, s = (torch.tensor(a.astype(np.float32), device=dev) for a in (
        rng.normal(size=(300, 60)) + 0.8, 5.0 * rng.normal(size=(300, 60))))
    c = torch.tensor(rng.normal(size=(130, 60)).astype(np.float32),
                     device=dev)
    return _hash_outputs(x, s, c, 0.7 * 60 ** 0.5, 0.4 * 60 ** 0.5)


def _d2_sha256(dev):
    """K11a and K12a at d = 2, m = k = 2048 on numpy-seeded inputs of path
    11's kind (particles uniform(0.6, 1.3), scores ~50, centers 0.02 from
    the particles; its bandwidths 0.3 and 0.2), hashed."""
    import torch

    rng = np.random.default_rng(2)
    x = rng.uniform(0.6, 1.3, size=(2048, 2))
    s = 50.0 * rng.normal(size=(2048, 2))
    c = x + 0.02 * rng.normal(size=(2048, 2))
    x, s, c = (torch.tensor(a.astype(np.float32), device=dev)
               for a in (x, s, c))
    return _hash_outputs(x, s, c, 0.3, 0.2)


def _row_chunks(m):
    return [slice(r, min(r + WIDE_ROWS, m)) for r in range(0, m, WIDE_ROWS)]


def _phi_plain_chunked(x, s, bw):
    import torch

    from dust_tpu_torch.ops import svgd

    return torch.cat([svgd.svgd_phi_plain(x, s, bw, rows=r)
                      for r in _row_chunks(x.shape[0])])


def _score_plain_chunked(x, c, bw):
    import torch

    from dust_tpu_torch.ops import gmm

    return torch.cat([gmm.gmm_prior_score_plain(x[r], c, bw)
                      for r in _row_chunks(x.shape[0])])


def wide_times(dev, shapes=WIDE_TIMED, plain=True, reps=2):
    """K11a and K12a (k = m) at each (m, d) of `shapes` on MPF-like inputs
    (K11's bandwidth 0.3 sqrt(d), K12's the MPF prior's 0.2): device ms
    (the least of `reps` `_device_ms` runs) beside the bound, the plain
    versions' time (row chunks, one call between CUDA events) when `plain`,
    and beside K12a one SDPA call's (`_sdpa_k12`) with its backend, held
    once against the kernel's output; then 20 calls of each under the
    general walk's clocked build (`_phase_clock`, where the tree has one):
    the mean time per call of its phases per block. Shared with
    chip_compare.py."""
    import torch

    from dust_tpu_torch.ops import gmm, svgd

    gen = torch.Generator(device=dev).manual_seed(SEED + 95)
    out = {}
    for m, d in shapes:
        x, s, c = _stream_inputs(m, d, gen, dev)
        # device scalars: a CUDA graph captures no host-to-device copy
        bw = torch.tensor(0.3 * d ** 0.5, device=dev)
        pbw = torch.tensor(0.2, device=dev)
        for name, kern, plain_fn, bound, module in (
                ("svgd_phi", lambda: svgd.svgd_phi_streamed(x, s, bw),
                 lambda: _phi_plain_chunked(x, s, bw), _k11_bound(m, d),
                 svgd),
                ("gmm_prior_score",
                 lambda: gmm.gmm_prior_score_streamed(x, c, pbw),
                 lambda: _score_plain_chunked(x, c, pbw),
                 _k12_bound(m, m, d), gmm)):
            t = {"m": m, "d": d,
                 "ms": min(_device_ms(kern) for _ in range(reps)),
                 "bound_ms": bound[0], "bound_by": bound[1],
                 "bound_bytes": bound[2], "bound_ops": bound[3]}
            t["bound_share"] = t["bound_ms"] / t["ms"]
            if plain:
                t["plain_ms"] = _call_ms(plain_fn, reps=2, warmup=1)
            if name == "gmm_prior_score":
                call, backend = _sdpa_k12(x, c, pbw)
                t["library_ms"] = min(_device_ms(call) for _ in range(reps))
                t["library"] = f"scaled_dot_product_attention, {backend}"
                t["library_max_abs_diff"] = (call() - kern()).abs().max(
                    ).item()
            out[f"{name} m={m} d={d}"] = t
            lib = (f"; SDPA ({t['library']}) {t['library_ms']:.4f} ms, "
                   f"max |SDPA - kernel| {t['library_max_abs_diff']:.2e}"
                   if "library_ms" in t else "")
            pl = (f", plain {t['plain_ms']:.4f} ms" if plain else "")
            print(f"time {name} m={m} d={d}: kernel {t['ms']:.4f} ms{pl}; "
                  f"bound {t['bound_ms']:.4e} ms ({t['bound_by']}), "
                  f"{t['bound_share']:.1%} of it{lib}")
            if hasattr(module, "phase_clock"):
                t["phase_clock"] = _phase_clock(
                    f"{name} (m={m}, d={d})", kern, module.phase_clock,
                    steps=1, calls=20, per="call")
    return out


def sgemm_tflops(dev, m=2048, k=1024, n=2048):
    """The card's practical float32 rate in this run, the yardstick beside
    the 67 TFLOP/s that the bounds assume: one cuBLAS float32 GEMM (TF32
    off) of [m, k] @ [k, n], K11a's second pass at d = 1024, as device
    time per call (`_device_ms`); returns TFLOP/s. Shared with
    chip_compare.py."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 97)
    a = torch.randn((m, k), generator=gen, device=dev)
    b = torch.randn((k, n), generator=gen, device=dev)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ms = min(_device_ms(lambda: a @ b) for _ in range(2))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    rate = 2.0 * m * k * n / (ms * 1e-3) / 1e12
    print(f"the card's float32 GEMM (cuBLAS, TF32 off) at [{m}, {k}] @ "
          f"[{k}, {n}]: {ms:.4f} ms, {rate:.2f} TFLOP/s "
          f"({rate * 1e12 / PEAK_F32_OPS_PER_S:.1%} of the bounds' rate)")
    return rate


def phase_stream_general(dev):
    """K11a and K12a on their general walk (d > 8) against their plain
    versions (in row chunks) at d = WIDE_D, m = WIDE_M: MPF-like inputs
    (particles uniform(0.6, 1.3), scores ~50, centers 0.02 from the
    particles) with K11's bandwidth 0.3 sqrt(d) (the kernel values near
    exp(-0.45)) and K12's the MPF prior's 0.2 (each row's own center
    dominates; k = 130 leaves most rows without one); normal inputs with
    0.7 sqrt(d) and 0.4 sqrt(d) (tests/test_torch_*_stream.py's); at
    WIDE_OFFSET_D the normal inputs offset by 2000 from the origin; K12
    with k = m and 130 centers; every call made twice with the same bits.
    Times at WIDE_TIMED (`wide_times`) and the card's float32 GEMM rate
    (`sgemm_tflops`); the d = 60 bits against D60_SHA256 and the d = 2
    bits (the d <= 8 walk) against D2_SHA256."""
    import torch

    from dust_tpu_torch.ops import gmm, svgd

    gen = torch.Generator(device=dev).manual_seed(SEED + 90)
    errs = {"svgd_phi": 0.0, "gmm_prior_score": 0.0}

    def chk(name, label, got, want, tol):
        errs[name] = max(errs[name], _check_close(
            f"{name} {label}", got, want, **tol))

    def twice(name, label, fn):
        first, second = fn(), fn()
        torch.cuda.synchronize()
        if not torch.equal(first, second):
            raise AssertionError(f"{name} {label}: two calls with the same "
                                 f"inputs differ")
        return first

    n_checks = 0
    for m in WIDE_M:
        for d in WIDE_D:
            x, s, c = _stream_inputs(m, d, gen, dev)
            xn = torch.randn((m, d), generator=gen, device=dev)
            sn = 5.0 * torch.randn((m, d), generator=gen, device=dev)
            cn = torch.randn((m, d), generator=gen, device=dev)
            root = d ** 0.5
            cases = [("MPF-like", x, s, c, 0.3 * root, 0.2),
                     ("normal", xn, sn, cn, 0.7 * root, 0.4 * root)]
            if d in WIDE_OFFSET_D:
                cases.append(("normal + 2000", xn + 2000.0, sn,
                              cn + 2000.0, 0.7 * root, 0.4 * root))
            for kind, xx, ss, cc, bw, pbw in cases:
                label = f"d={d} m={m} {kind}"
                chk("svgd_phi", label,
                    twice("svgd_phi", label,
                          lambda: svgd.svgd_phi_streamed(xx, ss, bw)),
                    _phi_plain_chunked(xx, ss, bw), K11_TOL)
                n_checks += 1
                for k in WIDE_K:
                    ck = cc if k is None else cc[:k]
                    klabel = f"d={d} m={m} k={ck.shape[0]} {kind}"
                    chk("gmm_prior_score", klabel,
                        twice("gmm_prior_score", klabel,
                              lambda: gmm.gmm_prior_score_streamed(
                                  xx, ck, pbw)),
                        _score_plain_chunked(xx, ck, pbw), K12_TOL)
                    n_checks += 1
    print(f"K11a and K12a at d = {WIDE_D}, m = {WIDE_M}: {n_checks} cases "
          f"within K11_TOL and K12_TOL of their plain versions, two calls "
          f"bit-equal")

    times = wide_times(dev)
    sgemm = sgemm_tflops(dev)
    digests = {"d60_sha256": _d60_sha256(dev), "d2_sha256": _d2_sha256(dev)}
    for key, want, what in (("d60_sha256", D60_SHA256, "the general walk"),
                            ("d2_sha256", D2_SHA256, "the d <= 8 walk")):
        same = digests[key] == want
        print(f"K11a and K12a {key[:-7]}: sha256 {digests[key]} "
              f"{'equal to' if same else 'FAIL: differs from'} the pinned "
              f"{want} ({what})")
        if not same:
            raise AssertionError(f"K11a/K12a {key}: {what} changed its "
                                 f"bits")
    return {"max_abs_err": errs, "timing": times, "cases": n_checks,
            "sgemm_tflops": sgemm, **digests}


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
    for label in [k for k in out if k.endswith(" adam")]:
        sgd = label[:-len(" adam")]
        print(f"path 11 Adam beside SGD, {sgd}: "
              f"{out[label]['updates_per_s']:.2f} against "
              f"{out[sgd]['updates_per_s']:.2f} updates/s")
    return out


# path 15: FusedMPF.optimize over d dynamics parameters with an isotropic
# Gaussian likelihood of the parameters themselves, m = 2048, SGD, 20 SVGD
# steps per conditioned update (K11a + K12a on their general walk)
PATH15_D = (64, 256)
PATH15_M, PATH15_UPDATES = 2048, 10


class _ParamsModel:
    """A model whose one-step prediction is the parameter vector itself,
    so that GaussianLikelihood over it is the isotropic Gaussian
    log-likelihood of the d parameters around each observation."""

    def params_to_dict(self, params):
        return {"theta": params}

    def step(self, states, action, params):
        return params["theta"]


def phase_wide_mpf_path(dev, dims=PATH15_D):
    """Path 15: FusedMPF.optimize (SGD at 1e-3, 20 SVGD steps per update)
    over d parameters, m = PATH15_M: GaussianLikelihood(obs_std=0.5) of the
    parameters (`_ParamsModel`), particles uniform(0.6, 1.3), prior
    bandwidth 0.2, SVGD bandwidth 0.3 sqrt(d); observations 1 + 0.1 N(0, 1)
    per dimension. Each update launches 20 K11a and 20 K12a; updates/s on
    the host clock. Shared with chip_compare.py."""
    import torch

    from dust_tpu_torch.inference import FusedMPF, GaussianLikelihood

    lik = GaussianLikelihood(obs_std=0.5, model=_ParamsModel())
    out = {}
    for d in dims:
        m, updates = PATH15_M, PATH15_UPDATES
        gen = torch.Generator(device=dev).manual_seed(SEED + 600 + d)
        mpf = FusedMPF(lik, lr=1e-3)
        x0 = 0.6 + 0.7 * torch.rand((m, d), generator=gen, device=dev)
        obs = 1.0 + 0.1 * torch.randn((updates + 1, d), generator=gen,
                                      device=dev)
        ms0 = mpf.init_state(x0, obs[-1], dim_a=1, bw=0.2)
        act = torch.zeros((1,), device=dev)
        bw = 0.3 * d ** 0.5

        def run(ms, rows):
            for i in rows:
                ms, _, _ = mpf.optimize(ms, act, obs[i], bw=bw, n_steps=20)
            return ms

        run(ms0, [updates])  # warm-up
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ms = run(ms0, range(updates))
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = _counts()
        label = f"path 15 d={d}"
        _check_counts(label, launches, {"svgd_phi": 20 * updates,
                                        "gmm_prior_score": 20 * updates})
        moved = (ms.x - x0).abs().max().item()
        if not torch.isfinite(ms.x).all() or moved < 1e-4:
            raise AssertionError(f"{label}: non-finite or unmoved particles")
        out[f"d={d}"] = {"m": m, "d": d, "updates": updates,
                         "seconds": elapsed,
                         "updates_per_s": updates / elapsed,
                         "launches": launches, "max_move": moved}
        print(f"{label} (FusedMPF, m = {m}, K11a + K12a): {updates} "
              f"conditioned updates x 20 SVGD steps in {elapsed:.4f} s, "
              f"{updates / elapsed:.2f} updates/s; largest move "
              f"{moved:.3e}; launches {launches}")
    return out


def _k11_ops(m, d):
    """Per particle pair 5d + 3 float32 operations (the distance 3d, the
    scale, exp, the kernel's row sum, a multiply-add per dimension of
    sum_j K_ij (score_j - 2 x_j / bw^2)); per element of x 8 (that column
    operand once, the row-sum term and the division by m)."""
    return m * m * (5 * d + 3) + 8 * m * d


def _k11_bound(m, d):
    """x and score read once, phi written once."""
    return _bound(4 * (3 * m * d + 1), _k11_ops(m, d))


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
                  _k11_ops(m, d) + _k12_ops(m, m, d) + 2 * m * d)


SDPA_BACKENDS = ("EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "FLASH_ATTENTION", "MATH")


def _sdpa_k12(x, centers, bw):
    """K12's function as one scaled_dot_product_attention call, the
    yardstick of `library_ms` (the port never calls it): softmax over k of
    q.k_k / bw^2 - |k_k|^2 / (2 bw^2), queries x - c_0, keys and values
    c - c_0 (the row term |x - c_0|^2 / (2 bw^2) cancels in the softmax),
    the head dimension zero-padded to the next multiple of 8; then
    (out - (x - c_0)) / bw^2. Returns the call and the name of the first
    backend of SDPA_BACKENDS that runs it."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    m, d = x.shape
    b2 = float(bw) ** 2
    q = x - centers[0]
    kv = centers - centers[0]
    pad = -d % 8
    qp = F.pad(q, (0, pad))[None, None]
    kp = F.pad(kv, (0, pad))[None, None]
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


def _path13_setup(dev, config):
    """Path 13's harness (the `dust` stack with the K1 hook and
    FusedPendulumMPF, MAIN_STEPS steps), initial observation and states,
    scenario seeds, true (length, mass) drawn from the dynamics prior with
    a numpy seed, and run(sweep, rows, lengths): the sweep over those
    scenarios with the given true lengths."""
    import torch

    from dust_tpu_torch.experiments import build_pendulum_stack
    from dust_tpu_torch.inference import FusedPendulumMPF
    from dust_tpu_torch.parallel import broadcast_scenarios
    from dust_tpu_torch.simulation import PendulumSimulation

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

    def run(sweep, rows, lengths):
        k = len(rows)
        return sweep.run(
            [seeds[i] for i in rows],
            {"length": torch.tensor(lengths, device=dev),
             "mass": torch.tensor(true[rows, 1], device=dev)},
            init_obs.expand(k, 1, 2),
            *(broadcast_scenarios(st, k) for st in states))

    return harness, init_obs, states, seeds, true, run


def phase_scenario_sweep_path(dev, config):
    """Path 13: ScenarioSweep over the `dust` stack on the kernel path (K1
    hook + FusedPendulumMPF, K2), PATH13_SCENARIOS scenarios x MAIN_STEPS
    steps, true (length, mass) drawn from the dynamics prior with a numpy
    seed. Scenario 0 must be bit-equal to one episode_fn run from its
    seed; a NaN true length must leave its scenario unhealthy and the
    others' bits alone."""
    import torch

    from dust_tpu_torch.parallel import ScenarioSweep

    label = "path 13 (ScenarioSweep, K1 + K2)"
    harness, init_obs, states, seeds, true, run = _path13_setup(dev, config)
    n = PATH13_SCENARIOS
    sweep = ScenarioSweep(harness, device=dev)

    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run(sweep, list(range(n)), true[:, 0])
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
    nan_out = run(sweep, rows, [true[0, 0], np.nan, true[2, 0]])
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
    result["out"] = out
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


# -- the multi-device layer, tuning and checkpoints -------------------------

# phase 34: path 11's particle counts (the sharded SVGD direction, GMM
# score and MPF step); the sharded objects against their unsharded port
# counterparts at the JAX tests' tolerances (tests/test_stein_sharded.py:27,
# tests/test_sharding_rollout.py:49-62, tests/test_svmpc_sharded.py:85-101)
SHARD_M = (2048, 8192)
STEIN_TOL = dict(rtol=1e-4, atol=1e-5)
DISCO_TOLS = {"costs": (1e-5, 1e-5), "omega": (1e-3, 1e-6),
              "a_mat": (1e-3, 1e-4), "a_mix": (1e-3, 1e-7)}
SVMPC_TOLS = {"costs": (1e-4, 1e-4), "theta": (1e-4, 1e-4),
              "a_mat": (1e-3, 1e-4), "a_mix": (1e-3, 1e-6)}
# phase 35: the learning rates of the lanes, the lanes' episode length,
# and the successive-halving runs over the sweep kernels
TUNE_LRS = (0.5, 1.0, 2.0, 4.0)
TUNE_STEPS = 100
PEND_SH = dict(n_configs=4, eta=2, min_budget=50, max_budget=200, seed=SEED)
PEND_SPACE = {"learning_rate": (0.5, 4.0, "log"), "alpha": (0.5, 2.0)}
PART_SH = dict(n_configs=4, eta=2, min_budget=100, max_budget=400,
               seed=SEED)
PART_SPACE = {"learning_rate": (50.0, 200.0, "log"), "alpha": (0.5, 2.0)}
# path 9's scenarios that phase 34 runs again through a mesh
PATH9_MESH_SCENARIOS = 2
# phase 36: where path 1's carry is saved
CKPT_STEP = 100


class _CollectiveCount:
    """Counts dist.all_reduce and dist.all_gather calls while active (the
    sharded modules call them through torch.distributed)."""

    def __init__(self):
        import torch.distributed as dist

        self.dist = dist
        self.counts = {"all_reduce": 0, "all_gather": 0}
        self.saved = {}

    def __enter__(self):
        for name in self.counts:
            fn = self.saved[name] = getattr(self.dist, name)

            def wrapped(*args, _fn=fn, _name=name, **kw):
                self.counts[_name] += 1
                return _fn(*args, **kw)

            setattr(self.dist, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.dist, name, fn)

    def reset(self):
        for name in self.counts:
            self.counts[name] = 0


def _check_tols(label, got, want, tols):
    worst = 0.0
    for k, (rtol, atol) in tols.items():
        worst = max(worst, _check_close(f"{label} {k}", got[k], want[k],
                                        rtol, atol))
    return worst


def _shard_stein(dev, mesh, count):
    """make_sharded_svgd_phi, make_sharded_gmm_score and ShardedMPF.step
    at path 11's state against svgd_phi_reference (MPF.phi's direction),
    GMM.score and MPF.step."""
    import torch

    from dust_tpu_torch.inference import MPF, GaussianLikelihood
    from dust_tpu_torch.models import PendulumModel
    from dust_tpu_torch.ops.svgd import svgd_phi_reference
    from dust_tpu_torch.parallel import (ShardedMPF, make_sharded_gmm_score,
                                         make_sharded_svgd_phi)

    lik = GaussianLikelihood(
        obs_std=0.1, model=PendulumModel(uncertain_params=("length",
                                                           "mass")))
    phi = make_sharded_svgd_phi(mesh, "particle")
    score = make_sharded_gmm_score(mesh, "particle")
    plain, sharded = MPF(lik, lr=1e-3), ShardedMPF(lik, mesh, lr=1e-3)
    obs0 = torch.tensor([3.0, 0.0], device=dev)
    worst, out = 0.0, {}

    def timed(seconds, name, fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*args)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return res

    for m in SHARD_M:
        gen = torch.Generator(device=dev).manual_seed(SEED + 500)
        x0 = 0.6 + 0.7 * torch.rand((m, 2), generator=gen, device=dev)
        ms = plain.init_state(x0, obs0, dim_a=1, bw=0.2)
        ms = plain._condition(ms, torch.tensor([0.8], device=dev),
                              obs0 + 0.1 * torch.randn(
                                  2, generator=gen, device=dev))
        pr, sec = ms.prior, {}
        # the plain prior score once: the direction's input and the
        # sharded score's reference
        prior_score = timed(sec, "GMM.score", pr.score, ms.x)
        s = plain._grad_lik(ms, ms.x) + prior_score
        count.reset()
        got = timed(sec, "make_sharded_svgd_phi", phi, ms.x, s, 0.3)
        calls = dict(count.counts)
        worst = max(worst, _check_close(
            f"phase 34 make_sharded_svgd_phi m={m}", got,
            svgd_phi_reference(ms.x, s, 0.3), **STEIN_TOL))
        worst = max(worst, _check_close(
            f"phase 34 make_sharded_gmm_score m={m}",
            timed(sec, "make_sharded_gmm_score", score, ms.x, pr.locs,
                  pr.logits, pr.scale_tril), prior_score, **STEIN_TOL))
        sm = sharded.shard_state(ms)
        got, gnorm = timed(sec, "ShardedMPF.step", sharded.step, sm, 0.3)
        want, wnorm = timed(sec, "MPF.step", plain.step, ms, 0.3)
        worst = max(worst, _check_close(
            f"phase 34 ShardedMPF.step m={m} particles", got.x, want.x,
            **STEIN_TOL))
        _check_close(f"phase 34 ShardedMPF.step m={m} direction norm",
                     gnorm, wnorm, rtol=1e-3, atol=0.0)
        out[f"m={m}"] = {"phi_collectives": calls, "seconds": sec}
        print(f"phase 34 m={m}: seconds per call (the first of each, "
              + ", ".join(f"{k} {v:.4f}" for k, v in sec.items()) + ")")
    return worst, out


def _shard_disco(dev, config, mesh, count):
    """make_sharded_disco_forward on the demo controller (8 draws x 128
    samples x 3 policies, H 30, the K1 hook) against MultiDisco.forward on
    the same noise and parameter draws; exactly two collectives."""
    import torch

    from dust_tpu_torch.experiments import build_pendulum_stack
    from dust_tpu_torch.parallel import make_sharded_disco_forward

    cfg = copy.deepcopy(config)
    cfg["exp_params"]["fused_rollout"] = True
    stack = build_pendulum_stack(
        cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    ctrl, model = stack.controller, stack.model
    gen = torch.Generator(device=dev).manual_seed(SEED + 34)
    eps = ctrl.sample_eps(gen)
    dstate = ctrl.init_state(stack.init_policies)
    state = stack.init_state.reshape(1, -1)
    ds, costs, _, _, omega, _ = ctrl.forward(
        dstate, state, model, stack.dynamics_prior,
        torch.Generator(device=dev).manual_seed(SEED + 35), eps_noise=eps)
    params, _ = ctrl._sample_params(
        torch.Generator(device=dev).manual_seed(SEED + 35), model,
        stack.dynamics_prior)
    fwd = make_sharded_disco_forward(ctrl, model, mesh)
    count.reset()
    _reset_counts()
    new, s_costs, s_omega = fwd(dstate, state, eps, params)
    torch.cuda.synchronize()
    calls, launches = dict(count.counts), _counts()
    if calls != {"all_reduce": 2, "all_gather": 0}:
        raise AssertionError(f"phase 34 sharded DISCO forward: collectives "
                             f"{calls}, expected two all_reduce")
    _check_counts("phase 34 sharded DISCO forward", launches,
                  {"pendulum_rollout_costs": 1})
    worst = _check_tols(
        "phase 34 make_sharded_disco_forward (8 x 128 x 3, H 30)",
        {"costs": s_costs, "omega": s_omega, "a_mat": new.a_mat,
         "a_mix": new.a_mix},
        {"costs": costs, "omega": omega, "a_mat": ds.a_mat,
         "a_mix": ds.a_mix}, DISCO_TOLS)
    print(f"phase 34 make_sharded_disco_forward: collectives per call "
          f"{calls}, launches {launches}")
    return worst, {"collectives": calls, "launches": launches}


def _shard_svmpc(dev, config, mesh, count):
    """ShardedSVMPC.svgd_step on the demo stack's SVMPC (the K1 hook)
    against SVMPC.svgd_step with the same injected noise and parameter
    generator seed."""
    import torch

    from dust_tpu_torch.experiments import build_pendulum_stack
    from dust_tpu_torch.parallel import ShardedSVMPC

    cfg = copy.deepcopy(config)
    cfg["exp_params"]["fused_rollout"] = True
    stack = build_pendulum_stack(
        cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    svmpc = stack.svmpc
    sv0 = svmpc.init_state(stack.init_policies, stack.policies_prior)
    ds0 = stack.controller.init_state(stack.init_policies)
    state = stack.init_state.reshape(1, -1)
    noise = torch.randn((svmpc.likelihood.n_samples, *sv0.theta.shape),
                        generator=torch.Generator(device=dev).manual_seed(
                            SEED + 36), device=dev)
    bw = 0.9
    sv, ds, costs = svmpc.svgd_step(
        sv0, ds0, state, stack.dynamics_prior,
        torch.Generator(device=dev).manual_seed(SEED + 37), bw, noise=noise)
    sharded = ShardedSVMPC(svmpc, stack.model, mesh)
    s_sv, s_ds = sharded.shard_states(sv0, ds0)
    count.reset()
    _reset_counts()
    s_sv, s_ds, s_costs = sharded.svgd_step(
        s_sv, s_ds, state, stack.dynamics_prior,
        torch.Generator(device=dev).manual_seed(SEED + 37), bw, noise=noise)
    torch.cuda.synchronize()
    calls, launches = dict(count.counts), _counts()
    _check_counts("phase 34 ShardedSVMPC.svgd_step", launches,
                  {"pendulum_rollout_costs": 1})
    worst = _check_tols(
        "phase 34 ShardedSVMPC.svgd_step",
        {"costs": s_costs, "theta": s_sv.theta, "a_mat": s_ds.a_mat,
         "a_mix": s_ds.a_mix},
        {"costs": costs, "theta": sv.theta, "a_mat": ds.a_mat,
         "a_mix": ds.a_mix}, SVMPC_TOLS)
    print(f"phase 34 ShardedSVMPC.svgd_step: collectives {calls}, "
          f"launches {launches}")
    return worst, {"collectives": calls, "launches": launches}


def _shard_group_sweep(dev, config, mesh, path4_out):
    """MegakernelGroupSweep(mesh=) at bench.py's shape in one K5 launch,
    bit-equal to path 4's launch; and each quarter of the groups in one
    launch of its own (a rank's block at world size 4), bit-equal to the
    same groups of path 4's launch."""
    import torch

    from dust_tpu_torch.parallel import MegakernelGroupSweep

    groups, seeds, lens, mass, _ = _bench_sweep(dev, config)
    sweep = MegakernelGroupSweep(groups.sweep_fn, mesh=mesh)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sweep.run(seeds(1), lens, mass)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = _counts()
    _check_counts("phase 34 MegakernelGroupSweep(mesh=)", launches,
                  {"pendulum_sweep_episode": 1})
    for k in sorted(out):
        _check_equal(f"phase 34 MegakernelGroupSweep(mesh=) {k} vs path 4",
                     out[k], path4_out[k])
    quarter = SWEEP_GROUPS // 4
    differ = 0
    for r in range(4):
        rows = slice(r * quarter, (r + 1) * quarter)
        part = sweep.local(seeds(1)[rows], lens[rows], mass[rows])
        differ += sum(not torch.equal(part[k], path4_out[k][rows])
                      for k in part)
    print(f"phase 34 MegakernelGroupSweep: four launches of "
          f"{quarter} groups each: {differ} fields differ in any bit from "
          f"path 4's launch")
    if differ:
        raise AssertionError("a block of groups differs from the same "
                             "groups of one launch")
    return {"seconds": elapsed, "launches": launches}


def _shard_scenario_sweep(dev, config, mesh, path13_out):
    """ScenarioSweep(mesh=) over path 13's scenarios, bit-equal to path
    13's outputs."""
    import torch

    from dust_tpu_torch.parallel import ScenarioSweep

    harness, _, _, _, true, run = _path13_setup(dev, config)
    n = PATH13_SCENARIOS
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run(ScenarioSweep(harness, mesh=mesh, device=dev), list(range(n)),
              true[:, 0])
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = _counts()
    _check_counts("phase 34 ScenarioSweep(mesh=)", launches,
                  {"pendulum_rollout_costs": n * MAIN_STEPS,
                   "pendulum_mpf_optimize": n * MAIN_STEPS})
    for k in sorted(out):
        _check_equal(f"phase 34 ScenarioSweep(mesh=) {k} vs path 13",
                     out[k], path13_out[k])
    return {"seconds": elapsed, "launches": launches}


def _shard_particle_sweep(dev, mesh, path9_out):
    """ParticleScenarioSweep(mesh=) over path 9's first
    PATH9_MESH_SCENARIOS scenarios (K6 + K7), bit-equal to the same
    scenarios of path 9."""
    import torch

    from dust_tpu_torch.parallel import ParticleScenarioSweep

    _, _, episode, args = _path9_setup(dev)
    k = PATH9_MESH_SCENARIOS
    _reset_counts()
    out = ParticleScenarioSweep(episode, mesh=mesh).run(
        *(a[:k] for a in args))
    torch.cuda.synchronize()
    launches = _counts()
    k7 = launches["particle_mpf_optimize"]
    _check_counts("phase 34 ParticleScenarioSweep(mesh=)", launches,
                  {"particle_rollout_costs": k * MAIN_STEPS,
                   "particle_mpf_optimize": k7})
    if not k <= k7 <= k * MAIN_STEPS:
        raise AssertionError(f"phase 34 ParticleScenarioSweep(mesh=): K7 "
                             f"launched {k7} times")
    for name in ("final_state", "success", "crashed", "cum_cost"):
        _check_equal(f"phase 34 ParticleScenarioSweep(mesh=) {name} vs "
                     f"path 9", out[name], path9_out[name][:k])
    return {"scenarios": k, "launches": launches}


def phase_multi_device(dev, config, path4_out, path9_out, path13_out):
    """Phase 34: the multi-device layer on the card at world size 1 (NCCL
    refuses two ranks on one card; the CPU tests hold world sizes 2 and 4
    on gloo). Each sharded object against its unsharded counterpart."""
    import os

    import torch
    import torch.distributed as dist

    from dust_tpu_torch.parallel import initialize_distributed, make_mesh

    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    # one rank: NCCL's bootstrap listens on the loopback interface
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    store = ROOT / "chiprun_out" / f"dist_store_{time.time_ns()}"
    store.parent.mkdir(exist_ok=True)
    if not initialize_distributed(f"file://{store}", 1, 0, device="cuda"):
        raise AssertionError("phase 34: no process group")
    backend, world = dist.get_backend(), dist.get_world_size()
    print(f"phase 34: process group backend {backend}, world size {world}")
    if backend != "nccl" or world != 1:
        raise AssertionError(f"phase 34: {backend} at world size {world}")
    try:
        make_mesh(device="cpu")
    except RuntimeError as exc:
        print(f"phase 34: a cpu mesh on the NCCL group raises: {exc}")
    else:
        raise AssertionError("phase 34: a cpu mesh on NCCL did not raise")
    meshes = {axis: make_mesh(axis_names=(axis,), device="cuda")
              for axis in ("particle", "rollout", "scenario")}
    seconds = {"process group and meshes": time.perf_counter() - t0}
    t1 = time.perf_counter()
    # the first collective sets up the NCCL communicator
    probe = torch.ones(1, device=dev)
    dist.all_reduce(probe)
    torch.cuda.synchronize()
    seconds["first collective"] = time.perf_counter() - t1
    result = {"backend": backend, "world_size": world}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t
        return out

    with _CollectiveCount() as count:
        stein_err, result["stein"] = timed(
            "stein (m = 2048, 8192)", _shard_stein, dev, meshes["particle"],
            count)
        disco_err, result["disco_forward"] = timed(
            "DISCO forward", _shard_disco, dev, config, meshes["rollout"],
            count)
        svmpc_err, result["svmpc"] = timed(
            "ShardedSVMPC", _shard_svmpc, dev, config, meshes["particle"],
            count)
    result["group_sweep"] = timed(
        "MegakernelGroupSweep", _shard_group_sweep, dev, config,
        meshes["scenario"], path4_out)
    result["scenario_sweep"] = timed(
        "ScenarioSweep", _shard_scenario_sweep, dev, config,
        meshes["scenario"], path13_out)
    result["particle_sweep"] = timed(
        "ParticleScenarioSweep", _shard_particle_sweep, dev,
        meshes["scenario"], path9_out)
    dist.destroy_process_group()
    store.unlink(missing_ok=True)
    result["max_abs_err"] = max(stein_err, disco_err, svmpc_err)
    result["seconds"] = time.perf_counter() - t0
    result["seconds_by_part"] = seconds
    print(f"phase 34 (multi-device layer, NCCL world size 1): every check "
          f"passed in {result['seconds']:.3f} s; seconds by part "
          + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items())
          + f"; the K5 launch through MegakernelGroupSweep(mesh=) "
          f"{result['group_sweep']['seconds']:.4f} s, ScenarioSweep(mesh=) "
          f"{result['scenario_sweep']['seconds']:.3f} s")
    return result


def _objective_run(label, objective, space, sh_kw, kernel):
    """successive_halving over a sweep-kernel objective, its kernel's
    launches counted per objective call."""
    import torch

    from dust_tpu_torch.tuning import successive_halving

    calls = []

    def counted(trials, budget):
        before = _wrappers()[kernel].launches
        scores = objective(trials, budget)
        calls.append({"trials": len(trials), "budget": budget,
                      "launches": _wrappers()[kernel].launches - before})
        return scores

    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best, value, history, eq = successive_halving(counted, space, **sh_kw)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    if any(c["launches"] != c["trials"] for c in calls):
        raise AssertionError(f"{label}: launches per objective call {calls} "
                             f"(one per trial expected)")
    if best is None or not np.isfinite(value):
        raise AssertionError(f"{label}: no finite full-budget score")
    print(f"{label}: {elapsed:.3f} s; objective calls (trials, budget, "
          f"{kernel} launches) "
          f"{[(c['trials'], c['budget'], c['launches']) for c in calls]}; "
          f"chosen {best}, score {value:.6f}, {eq:.2f} episode-equivalents")
    return {"seconds": elapsed, "calls": calls, "best": best,
            "value": value, "episode_equivalents": eq}


def phase_tuning(dev, config):
    """Phase 35: parallel_lr_sweep on the `dust` stack (K1 hook + K2) with
    four rates, each lane bit-equal to the sweep with that rate alone; one
    successive_halving over pendulum_sweep_tail_objective (K5) and one
    over particle_sweep_asha_objective (K10)."""
    import torch

    from dust_tpu_torch.experiments import (PARTICLE_DEMO_CONFIG,
                                            build_pendulum_stack)
    from dust_tpu_torch.inference import FusedPendulumMPF
    from dust_tpu_torch.simulation import PendulumSimulation
    from dust_tpu_torch.tuning import (parallel_lr_sweep,
                                       particle_sweep_asha_objective,
                                       pendulum_sweep_tail_objective)

    label = "phase 35 parallel_lr_sweep"
    cfg = copy.deepcopy(config)
    cfg["exp_params"]["fused_rollout"] = True
    stack = build_pendulum_stack(
        cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    stack.mpf = FusedPendulumMPF.from_mpf(stack.mpf)
    harness = PendulumSimulation(
        controller=stack.controller, svmpc=stack.svmpc, mpf=stack.mpf,
        model=stack.model, steps=TUNE_STEPS, warm_up=0, mpf_bw=stack.mpf_bw,
        mpf_steps=stack.mpf_steps, device=dev)
    true = {"length": 1.0, "mass": 1.0}
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lanes = parallel_lr_sweep(harness, stack, TUNE_LRS, SEED + 35, true)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = _counts()
    k = len(TUNE_LRS)
    _check_counts(label, launches,
                  {"pendulum_rollout_costs": k * TUNE_STEPS,
                   "pendulum_mpf_optimize": k * TUNE_STEPS})
    if not torch.isfinite(lanes).all():
        raise AssertionError(f"{label}: non-finite lanes {lanes}")
    for i, lr in enumerate(TUNE_LRS):
        single = parallel_lr_sweep(harness, stack, [lr], SEED + 35, true)
        _check_equal(f"{label} lane {i} (lr {lr}) vs the rate alone",
                     lanes[i:i + 1], single)
    result = {"lrs": list(TUNE_LRS), "steps": TUNE_STEPS,
              "avg_cum_cost": lanes.tolist(), "seconds": elapsed,
              "launches": launches}
    print(f"{label}: {k} lanes x {TUNE_STEPS} steps in {elapsed:.3f} s; "
          f"avg cum cost per rate {dict(zip(TUNE_LRS, lanes.tolist()))}; "
          f"launches {launches}")

    pend = pendulum_sweep_tail_objective(
        config, torch.linspace(0.7, 1.25, 8), torch.linspace(1.25, 0.7, 8),
        seed=SEED, device=dev)
    result["pendulum_tail_sh"] = _objective_run(
        "phase 35 successive_halving over pendulum_sweep_tail_objective "
        "(K5)", pend, PEND_SPACE, PEND_SH, "pendulum_sweep_episode")
    part = particle_sweep_asha_objective(
        PARTICLE_DEMO_CONFIG, torch.linspace(1.5, 3.0, 8), seed=SEED,
        device=dev)
    result["particle_sh"] = _objective_run(
        "phase 35 successive_halving over particle_sweep_asha_objective "
        "(K10)", part, PART_SPACE, PART_SH, "particle_sweep_episode")
    return result


def phase_checkpoints(dev, config):
    """Phase 36: path 1's carry (the K1 hook + K2 step loop) saved at step
    CKPT_STEP with its CUDA generator, loaded and run to MAIN_STEPS: bit-
    equal to MAIN_STEPS uninterrupted steps. One Stopwatch-timed step."""
    import torch

    from dust_tpu_torch.experiments import build_pendulum_stack
    from dust_tpu_torch.inference import FusedPendulumMPF
    from dust_tpu_torch.simulation import PendulumSimulation
    from dust_tpu_torch.utils.helper import load_checkpoint, save_checkpoint
    from dust_tpu_torch.utils.profiling import Stopwatch

    label = "phase 36 (checkpoints, path 1)"
    cfg = copy.deepcopy(config)
    cfg["exp_params"]["fused_rollout"] = True
    stack = build_pendulum_stack(
        cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    stack.mpf = FusedPendulumMPF.from_mpf(stack.mpf)
    harness = PendulumSimulation(
        controller=stack.controller, svmpc=stack.svmpc, mpf=stack.mpf,
        model=stack.model, steps=MAIN_STEPS, warm_up=0, mpf_bw=stack.mpf_bw,
        mpf_steps=stack.mpf_steps, device=dev)
    step = harness.step_fn(stack.dynamics_prior)
    true = {"length": torch.tensor(1.0, device=dev),
            "mass": torch.tensor(1.0, device=dev)}

    def carry0():
        obs = stack.init_state.reshape(1, -1)
        return (torch.Generator(device=dev).manual_seed(SEED + 360), obs,
                stack.controller.init_state(stack.init_policies),
                stack.svmpc.init_state(stack.init_policies,
                                       stack.policies_prior),
                stack.mpf.init_state(stack.mpf_init, obs[0], 1))

    def run(carry, start, stop):
        logs = []
        for t in range(start, stop):
            carry, log = step(carry, t, true)
            logs.append(log)
        return carry, [torch.stack(col) for col in zip(*logs)]

    full, full_logs = run(carry0(), 0, MAIN_STEPS)
    half, _ = run(carry0(), 0, CKPT_STEP)
    path = save_checkpoint(ROOT / "chiprun_out" / "checkpoints" /
                           "path1_step100.pt", half, step=CKPT_STEP)
    resumed, start, _ = load_checkpoint(path)
    if resumed[0].device.type != dev.type:
        raise AssertionError(f"{label}: the generator came back on "
                             f"{resumed[0].device}")
    _reset_counts()
    resumed, logs = run(resumed, start, MAIN_STEPS)
    torch.cuda.synchronize()
    launches = _counts()
    n = MAIN_STEPS - start
    _check_counts(label, launches, {"pendulum_rollout_costs": n,
                                    "pendulum_mpf_optimize": n})
    names = ("obs", "action", "cost", "theta", "weights", "dyn_particles",
             "bw")
    for name, got, want in zip(names, logs, full_logs):
        _check_equal(f"{label} resumed steps {start}-{MAIN_STEPS - 1} "
                     f"{name} vs uninterrupted", got, want[start:])
    _check_equal(f"{label} final MPF particles", resumed[4].x, full[4].x)
    _check_equal(f"{label} final policy particles", resumed[3].theta,
                 full[3].theta)
    _check_equal(f"{label} generator state", resumed[0].get_state(),
                 full[0].get_state())
    sw = Stopwatch()
    carry = resumed
    for t in range(MAIN_STEPS, MAIN_STEPS + 10):
        with sw.phase("mpc step") as h:
            carry, h.result = step(carry, t, true)
    summary = sw.summary()["mpc step"]
    print(f"{label}: saved at step {start}, resumed to {MAIN_STEPS}: "
          f"bit-equal to the uninterrupted run; {path.stat().st_size} "
          f"bytes; Stopwatch over 10 more steps: {summary['mean_ms']} ms "
          f"per step ({sw.rates()['mpc step']:.1f} steps/s)")
    return {"checkpoint_bytes": path.stat().st_size, "resumed_at": start,
            "launches": launches, "stopwatch": summary}


# -- the entry points (dust_tpu_torch.demo) ---------------------------------

# phase 37: the demos' depths (the sweep demo at its defaults: 16
# scenarios, 100 steps) and the configs of their searches
DEMO_STEPS = 200
DEMO_TAIL = ["--tail", "9", "--seeds", "1"]
DEMO_PSWEEP = ["--sweep", "--trials", "4", "--steps", "200"]
DEMO_SEARCH = ["--trials", "2"]
DEMO_LANES = ["--parallel-lr", "4"]
# SHA-256 of the config.yaml the pendulum demo's --save writes for
# PENDULUM_DEMO_CONFIG: yaml.dump's text (tests/test_torch_configs.py
# holds it)
PENDULUM_CONFIG_YAML_SHA256 = \
    "12024aca82619a0f06b87390e51d51acf0c8051ccbafba6a13f2ec64cf4f3919"


def _demo_call(label, fn, *args, **kw):
    """fn(*args, **kw) with every launch count set to 0 just before and
    read just after; its printed text is kept, not echoed. Returns (result,
    text, seconds, launches)."""
    import contextlib
    import io

    import torch

    buf = io.StringIO()
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = fn(*args, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: v for k, v in _counts().items() if v}
    print(f"phase 37 {label}: {seconds:.3f} s, launches {launches}")
    return res, buf.getvalue(), seconds, launches


def _printed_block(text, head, name):
    """{key: value text} of a pandas-Series-like block the pendulum demo
    prints: the line `head`, one "key  value" line per item, then the
    "Name: `name`" line."""
    lines = text.splitlines()
    start = lines.index(head)
    out = {}
    for line in lines[start + 1:]:
        if line.startswith(f"Name: {name}"):
            return out
        key, value = line.rsplit(None, 1)
        out[key.strip()] = value
    raise AssertionError(f"no block {head!r} ... {name!r} in the report")


def _finite_columns(label, cols):
    for name in ("Cost", "Actions", "Position", "Speed"):
        if not np.isfinite(cols[name]).all():
            raise AssertionError(f"{label}: non-finite values in {name}")


def _demo_pendulum(dev):
    """The pendulum demo through main (four cases, prior-drawn parameters,
    --save) and then through run_cases with length 1.0, mass 1.0 and
    `fused_rollout: true`, one case per call."""
    import hashlib
    import pickle

    from dust_tpu_torch.demo import pendulum_example as pe
    from dust_tpu_torch.experiments import PENDULUM_DEMO_CONFIG
    from dust_tpu_torch.utils.plots_html import html_mean_results

    argv = ["--steps", str(DEMO_STEPS), "--episodes", "1", "--seed",
            str(SEED), "--save"]
    res, text, seconds, launches = _demo_call(
        "pendulum_example " + " ".join(argv), pe.main, argv)
    _check_counts("phase 37 pendulum_example", launches, {})
    summary = _printed_block(text, "Case", "AvgCumCost")
    out = {"main": {"argv": argv, "seconds": seconds, "launches": launches,
                    "parameters_set": res["parameters_set"], "cases": {}}}
    for label, cols in res["columns"].items():
        _finite_columns(f"phase 37 pendulum_example {label}", cols)
        # the printed numbers against the same numbers from the columns
        last = cols["AvgCumCost"][cols["Timestep"] == DEMO_STEPS - 1]
        tail = cols["Cost"][-max(DEMO_STEPS // 10, 1):].mean()
        printed_tail = _printed_block(
            text.split(f"{label}: mean terminal cost per episode:")[1],
            "Iteration", "Cost")
        if float(summary[label]) != float(last.mean()) or \
                np.float32(printed_tail["0"]) != tail:
            raise AssertionError(
                f"phase 37 pendulum_example {label}: printed summary "
                f"{summary[label]} / tail {printed_tail['0']}, from the "
                f"columns {last.mean()!r} / {tail!r}")
        out["main"]["cases"][label] = {
            "min_cost_second_half":
                float(cols["Cost"][DEMO_STEPS // 2:].min()),
            "summary": float(last.mean()), "tail": float(tail)}
    saved = res["saved"]
    with (saved / "data.pkl").open("rb") as fh:
        data = pickle.load(fh)
    if len(data["Case"]) != 4 * DEMO_STEPS or not np.array_equal(
            data["Cost"], np.concatenate([c["Cost"] for c in
                                          res["columns"].values()])):
        raise AssertionError("phase 37 --save: data.pkl holds other rows")
    digest = hashlib.sha256((saved / "config.yaml").read_bytes()).hexdigest()
    if digest != PENDULUM_CONFIG_YAML_SHA256:
        raise AssertionError(f"phase 37 --save: config.yaml hashes to "
                             f"{digest}")
    print(f"phase 37 --save: data.pkl ({len(data['Case'])} rows) and "
          f"config.yaml equal to the CPU test's (sha256 {digest[:16]}...)")
    page = saved / "mean_results.html"
    html = html_mean_results(pe.combine_cases(res["columns"]),
                             save_path=page)
    if not page.read_text().startswith("<!DOCTYPE html>") or \
            page.read_text() != html:
        raise AssertionError("phase 37: html_mean_results wrote no page")
    print(f"phase 37 plots_html.html_mean_results on the demo's columns: "
          f"{len(html)} characters -> {page}")
    out["main"].update(saved=str(saved), config_sha256=digest,
                       html_chars=len(html))

    cfg = copy.deepcopy(PENDULUM_DEMO_CONFIG)
    cfg["exp_params"]["fused_rollout"] = True
    out["fused"] = {}
    for case, label in pe.CASES.items():
        res, _, seconds, launches = _demo_call(
            f"run_cases({case}, fused_rollout, length 1.0, mass 1.0)",
            pe.run_cases, cfg, cases=(case,), steps=DEMO_STEPS, seed=SEED,
            device=dev, parameters_set=[{"length": 1.0, "mass": 1.0}])
        want = {"pendulum_rollout_costs": DEMO_STEPS} \
            if case in ("dust", "svmpc") else {}
        _check_counts(f"phase 37 run_cases({case})", launches, want)
        cols = res["columns"][label]
        _finite_columns(f"phase 37 run_cases({case})", cols)
        low = float(cols["Cost"][DEMO_STEPS // 2:].min())
        _check_swingup(f"phase 37 run_cases({case})", low)
        out["fused"][case] = {"seconds": seconds, "launches": launches,
                              "min_cost_second_half": low}
    print("phase 37 pendulum_example: lowest cost in steps "
          f"{DEMO_STEPS // 2}-{DEMO_STEPS - 1} per case, main (drawn "
          f"parameters {out['main']['parameters_set']}) "
          + ", ".join(f"{k} {v['min_cost_second_half']:.6f}"
                      for k, v in out["main"]["cases"].items())
          + "; run_cases (1.0, 1.0, fused_rollout) "
          + ", ".join(f"{k} {v['min_cost_second_half']:.6f}"
                      for k, v in out["fused"].items()))
    return out


def _demo_particle():
    import re

    from dust_tpu_torch.demo import particle_example

    argv = ["--steps", str(DEMO_STEPS)]
    (res,), text, seconds, launches = _demo_call(
        "particle_example " + " ".join(argv), particle_example.main, argv)
    _check_counts("phase 37 particle_example", launches, {})
    m = re.search(r"episode 0: steps=(\d+) crashed=(True|False) "
                  r"success=(True|False) cum_cost=(\S+) final_state=", text)
    if m is None or int(m.group(1)) != res["steps"] or \
            m.group(2) != str(res["crashed"]):
        raise AssertionError(f"phase 37 particle_example: report {text!r}")
    est = res["mass_estimate"]
    if not (np.isfinite(res["costs"]).all() and est is not None
            and np.isfinite(est) and np.isfinite(res["trajectory"]).all()):
        raise AssertionError("phase 37 particle_example: non-finite costs, "
                             "states or mass estimate")
    print(f"phase 37 particle_example: {res['steps']} steps, crashed "
          f"{res['crashed']}, success {res['success']}, cum_cost "
          f"{res['cum_cost']:.1f}, MPF mass estimate {est:.3f}")
    return {"argv": argv, "seconds": seconds, "launches": launches,
            "steps": res["steps"], "crashed": res["crashed"],
            "success": res["success"], "cum_cost": res["cum_cost"],
            "mass_estimate": est}


def _demo_sweeps(dev):
    """sweep_example at its defaults for both tasks: a plumbing check of
    its seeds, grouping and printing. Each row is held against the demo's
    own row function (`pendulum_rows` / `particle_rows`) on the outputs of
    direct sweep calls on the same seeds and arguments; the kernels
    themselves are held against their plain versions in paths 4 and 8."""
    import torch

    from dust_tpu_torch.demo import sweep_example as se
    from dust_tpu_torch.experiments import (PARTICLE_DEMO_CONFIG,
                                            PENDULUM_DEMO_CONFIG,
                                            build_particle_stack,
                                            build_pendulum_stack)
    from dust_tpu_torch.simulation import (megakernel_particle_sweep_fn,
                                           megakernel_pendulum_sweep_fn)

    out = {}
    for task, kernel in (("pendulum", "pendulum_sweep_episode"),
                         ("particle", "particle_sweep_episode")):
        res, text, seconds, launches = _demo_call(
            f"sweep_example --task {task}", se.main, ["--task", task])
        groups, steps = 2, 100
        _check_counts(f"phase 37 sweep_example --task {task}", launches,
                      {kernel: groups})
        gen = torch.Generator(device=dev).manual_seed(SEED)
        want = []
        if task == "pendulum":
            stack = build_pendulum_stack(PENDULUM_DEMO_CONFIG, gen,
                                         case="dust", device=dev)
            fn = megakernel_pendulum_sweep_fn(
                stack, PENDULUM_DEMO_CONFIG["exp_params"], steps=steps,
                n_sc=8)
            lens = torch.linspace(0.7, 1.25, 8, device=dev)
            mass = torch.linspace(1.25, 0.7, 8, device=dev)
            for g in range(groups):
                o = fn(torch.tensor([SEED + 1, g * 1000], device=dev),
                       lens, mass)
                want += se.pendulum_rows(o, lens, mass, g, steps)
            lines = [f"{r[0]:>8} {r[1]:>7.3f} {r[2]:>6.3f} {r[3]:>18.4f} "
                     f"{r[4]:>10.4f}" for r in want]
            totals = {"solved": res["solved"]}
        else:
            stack = build_particle_stack(PARTICLE_DEMO_CONFIG, gen,
                                         device=dev)
            fn = megakernel_particle_sweep_fn(
                stack, PARTICLE_DEMO_CONFIG["exp_params"], steps=steps,
                n_sc=8)
            masses = torch.linspace(1.5, 3.0, 8, device=dev)
            for g in range(groups):
                o = fn(torch.tensor([SEED + 1, g * 1000], device=dev),
                       masses)
                want += se.particle_rows(o, masses, g)
            lines = [f"{r[0]:>8} {r[1]:>6.3f} {str(r[2]):>8} "
                     f"{str(r[3]):>8} {r[4]:>12.1f}" for r in want]
            totals = {"success": res["success"], "crashed": res["crashed"]}
        printed = text.splitlines()
        if res["rows"] != want or any(line not in printed for line in lines):
            raise AssertionError(f"phase 37 sweep_example --task {task}: "
                                 f"rows differ from the direct calls")
        print(f"phase 37 sweep_example --task {task}: 16 rows equal to "
              f"direct sweep calls on the same seeds (seeds, grouping and "
              f"printing); {text.splitlines()[-1]}")
        out[task] = {"seconds": seconds, "launches": launches, **totals}
    return out


def _evaluations(history):
    """Finite-scored trial evaluations of a successive_halving history
    (a trial its objective rejects scores +inf and launches nothing)."""
    return sum(1 for _, rung in history for _, score in rung
               if np.isfinite(score))


def _demo_tuning():
    from dust_tpu_torch.demo import particle_tuning, pendulum_tuning

    out = {}
    res, _, seconds, launches = _demo_call(
        "pendulum_tuning " + " ".join(DEMO_TAIL), pendulum_tuning.main,
        DEMO_TAIL)
    _check_counts("phase 37 pendulum_tuning --tail", launches,
                  {"pendulum_sweep_episode": _evaluations(res["history"])})
    if not np.isfinite(res["value"]):
        raise AssertionError("phase 37 pendulum_tuning --tail: no finite "
                             "best value")
    out["pendulum_tail"] = {
        "seconds": seconds, "launches": launches, "value": res["value"],
        "rungs": [(b, len(r)) for b, r in res["history"]]}
    for key, argv in (("pendulum_search", DEMO_SEARCH),
                      ("pendulum_parallel_lr", DEMO_LANES)):
        res, _, seconds, launches = _demo_call(
            "pendulum_tuning " + " ".join(argv), pendulum_tuning.main, argv)
        _check_counts(f"phase 37 pendulum_tuning {argv[0]}", launches, {})
        if not np.isfinite(res["value"]):
            raise AssertionError(f"phase 37 pendulum_tuning {argv[0]}: no "
                                 f"finite best value")
        out[key] = {"seconds": seconds, "value": res["value"]}
    res, _, seconds, launches = _demo_call(
        "particle_tuning " + " ".join(DEMO_PSWEEP), particle_tuning.main,
        DEMO_PSWEEP)
    want = _evaluations(res["history"]) + len(res["held_out"])
    _check_counts("phase 37 particle_tuning --sweep", launches,
                  {"particle_sweep_episode": want})
    if not np.isfinite(res["value"]) or len(res["held_out"]) != 3:
        raise AssertionError("phase 37 particle_tuning --sweep: no finite "
                             "best value")
    out["particle_sweep"] = {"seconds": seconds, "launches": launches,
                             "value": res["value"],
                             "held_out": list(res["held_out"].values())}
    print("phase 37 tuning: pendulum --tail rungs (budget, trials) "
          f"{out['pendulum_tail']['rungs']}, best "
          f"{out['pendulum_tail']['value']:.6f}; random search best "
          f"{out['pendulum_search']['value']:.4f}; --parallel-lr best "
          f"{out['pendulum_parallel_lr']['value']:.4f}; particle --sweep "
          f"best {out['particle_sweep']['value']:.6f}, held-out "
          f"{_fmt(out['particle_sweep']['held_out'])}")
    return out


def _cartpole_sweep(dev, steps, th0=None):
    """Path 16: the cart-pole benchmark cell's sweep on the demo stack
    (`CARTPOLE_DEMO_CONFIG`, its start angle `th0` where given), 8 groups
    x 16 scenarios x 2 chains of `steps`-step episodes through
    MegakernelGroupSweep; the seeds of call i, the true (length,
    mass_pole) grids of the cell's traffic, and plain(seeds): the sweep's
    plain version on the same inputs."""
    import torch

    from dust_tpu_torch.experiments import (
        CARTPOLE_DEMO_CONFIG,
        build_pendulum_stack,
    )
    from dust_tpu_torch.ops import cartpole_sweep_episode as cse
    from dust_tpu_torch.parallel import MegakernelGroupSweep
    from dust_tpu_torch.simulation import megakernel_cartpole_sweep_fn

    cfg = copy.deepcopy(CARTPOLE_DEMO_CONFIG)
    if th0 is not None:
        cfg["exp_params"]["init_state"][2] = th0
    stack = build_pendulum_stack(
        cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    make = lambda: megakernel_cartpole_sweep_fn(
        stack, cfg["exp_params"], steps=steps, n_sc=SWEEP_SC,
        n_chains=SWEEP_CHAINS)
    sweep = make()
    # the same adapter over the plain version: the adapter takes its
    # wrapper from the module when it is made
    launch = cse.fused_cartpole_sweep_groups
    cse.fused_cartpole_sweep_groups = cse.plain_cartpole_sweep_groups
    try:
        plain_sweep = make()
    finally:
        cse.fused_cartpole_sweep_groups = launch
    lens = torch.linspace(0.8, 1.2, SWEEP_SC, device=dev).expand(
        SWEEP_GROUPS, SWEEP_SC)
    mps = torch.linspace(0.08, 0.12, SWEEP_SC, device=dev).flip(0).expand(
        SWEEP_GROUPS, SWEEP_SC)

    def seeds(i):
        return torch.stack([
            torch.full((SWEEP_GROUPS,), i, dtype=torch.int64, device=dev),
            torch.arange(SWEEP_GROUPS, device=dev) * 1000], dim=1)

    def plain(seed_rows):
        return plain_sweep.groups(seed_rows, lens, mps)

    return MegakernelGroupSweep(sweep), seeds, lens, mps, plain


def phase_k14(dev):
    """K14 against its plain version, path 16, K14's time and clock and
    the upright shares (see the module docstring, phase 41)."""
    import torch

    from dust_tpu_torch.experiments import CARTPOLE_DEMO_CONFIG
    from dust_tpu_torch.ops import cartpole_episode
    from perfbench.cartpole_counts import cartpole_work

    worst = 0.0
    for steps in (1, 3):
        groups, seeds, lens, mps, plain = _cartpole_sweep(dev, steps)
        got = groups.run(seeds(1), lens, mps)
        want = plain(seeds(1))
        torch.cuda.synchronize()
        for k, tol in K14_TOLS.items():
            worst = max(worst, _check_close(
                f"K14 vs plain {SWEEP_GROUPS}x{SWEEP_SC}x{SWEEP_CHAINS} "
                f"device RNG {steps} steps {k}", got[k], want[k], rtol=0.0,
                atol=tol))

    groups, seeds, lens, mps, plain = _cartpole_sweep(dev, MAIN_STEPS)
    groups.run(seeds(0), lens, mps)  # warm-up
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = groups.run(seeds(1), lens, mps)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = _counts()
    _check_counts("path 16 (K14 sweep)", launches,
                  {"cartpole_sweep_episode": 1})
    for k, v in out.items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"path 16: non-finite values in {k}")
    again = groups.run(seeds(1), lens, mps)
    differ = [k for k in out if not torch.equal(out[k], again[k])]
    if differ:
        raise AssertionError(f"path 16: the same seeds gave other bits in "
                             f"{differ}")
    th = torch.remainder(out["th"] + np.pi, 2 * np.pi) - np.pi
    upright = (th.abs() < UPRIGHT_RAD).float()     # [G, C, steps, n_sc]
    episodes = SWEEP_GROUPS * SWEEP_SC * SWEEP_CHAINS
    ops, nbytes = cartpole_work(CARTPOLE_DEMO_CONFIG["exp_params"],
                                MAIN_STEPS, episodes)
    bound = _bound(nbytes, ops)
    runs = {"plain": [], "kernel": []}
    kern = lambda: groups.run(seeds(1), lens, mps)
    for which in ("plain", "kernel", "kernel", "plain"):
        if which == "kernel":
            runs[which].append(statistics.median(_event_ms(kern, 3)))
        elif not runs["plain"]:
            runs[which].append(_event_ms(lambda: plain(seeds(1)), 1)[0])
    clock = _phase_clock("K14 (path 16)", kern, cartpole_episode.phase_clock)
    result = {
        "episodes": episodes, "steps": MAIN_STEPS, "seconds": elapsed,
        "solves_per_s": episodes * MAIN_STEPS / elapsed,
        "launches": launches, "max_abs_err": worst,
        "upright_share_step_99": float(upright[:, :, 99].mean()),
        "upright_share_step_199": float(upright[:, :, -1].mean()),
        "ms": min(runs["kernel"]), "plain_ms": min(runs["plain"]),
        "runs": runs, "bound_ms": bound[0], "bound_by": bound[1],
        "bound_bytes": bound[2], "bound_ops": bound[3],
        "timed_as": "one launch between CUDA events, median of 3",
        "phase_clock": clock}
    print(f"path 16 (K14 sweep): {episodes} episodes x {MAIN_STEPS} steps in "
          f"one launch, {elapsed:.4f} s, {result['solves_per_s']:.1f} "
          f"solves/s; K14 {result['ms']:.3f} ms a call (plain "
          f"{result['plain_ms']:.1f} ms), bound {bound[0]:.4f} ms "
          f"({bound[1]}), {100 * bound[0] / result['ms']:.2f}% of it; "
          f"upright (|th| < {UPRIGHT_RAD}) at step 99 "
          f"{result['upright_share_step_99']:.4f}, at step 199 "
          f"{result['upright_share_step_199']:.4f}; launches {launches}")
    return result


def _skid_steer_sweep(dev, steps, th0=None):
    """Path 17: the skid-steer benchmark cell's sweep on the demo stack
    (`SKID_STEER_DEMO_CONFIG`, its start heading `th0` where given), 8
    groups x 8 scenarios x 4 chains of `steps`-step episodes through
    MegakernelGroupSweep; the seeds of call i, the true (x_icr,
    wheel_radius, axial_distance) grids of the cell's traffic, and
    plain(seeds): the sweep's plain version on the same inputs."""
    import torch

    from dust_tpu_torch.experiments import (
        SKID_STEER_DEMO_CONFIG,
        build_particle_stack,
    )
    from dust_tpu_torch.ops import skid_steer_sweep_episode as sse
    from dust_tpu_torch.parallel import MegakernelGroupSweep
    from dust_tpu_torch.simulation import megakernel_skid_steer_sweep_fn

    cfg = copy.deepcopy(SKID_STEER_DEMO_CONFIG)
    if th0 is not None:
        cfg["env_params"]["init_state"][2] = th0
    stack = build_particle_stack(
        cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    make = lambda: megakernel_skid_steer_sweep_fn(
        stack, cfg["exp_params"], steps=steps, n_sc=SKID_SC,
        n_chains=SKID_CHAINS)
    sweep = make()
    # the same adapter over the plain version: the adapter takes its
    # wrapper from the module when it is made
    launch = sse.fused_skid_steer_sweep_groups
    sse.fused_skid_steer_sweep_groups = sse.plain_skid_steer_sweep_groups
    try:
        plain_sweep = make()
    finally:
        sse.fused_skid_steer_sweep_groups = launch
    grid = lambda lo, hi: torch.linspace(lo, hi, SKID_SC, device=dev)
    params = (grid(0.15, 0.25).expand(SKID_GROUPS, SKID_SC),
              grid(0.05625, 0.06875).flip(0).expand(SKID_GROUPS, SKID_SC),
              grid(0.4275, 0.5225).roll(3).expand(SKID_GROUPS, SKID_SC))

    def seeds(i):
        return torch.stack([
            torch.full((SKID_GROUPS,), i, dtype=torch.int64, device=dev),
            torch.arange(SKID_GROUPS, device=dev) * 1000], dim=1)

    def plain(seed_rows):
        return plain_sweep.groups(seed_rows, *params)

    return MegakernelGroupSweep(sweep), seeds, params, plain, sweep


def phase_k15(dev):
    """K15 against its plain version, path 17, K15's time and clock, the
    target and crash shares and the fallback (see the module docstring,
    phase 43)."""
    import torch

    from dust_tpu_torch.experiments import SKID_STEER_DEMO_CONFIG
    from dust_tpu_torch.ops import skid_steer_episode
    from perfbench.skid_steer_counts import skid_steer_work

    worst = 0.0
    for steps in (1, 3):
        groups, seeds, params, plain, _ = _skid_steer_sweep(dev, steps)
        got = groups.run(seeds(1), *params)
        want = plain(seeds(1))
        torch.cuda.synchronize()
        for k, tol in K15_TOLS.items():
            worst = max(worst, _check_close(
                f"K15 vs plain {SKID_GROUPS}x{SKID_SC}x{SKID_CHAINS} "
                f"device RNG {steps} steps {k}", got[k], want[k], rtol=0.0,
                atol=tol))

    groups, seeds, params, plain, sweep = _skid_steer_sweep(dev, MAIN_STEPS)
    groups.run(seeds(0), *params)  # warm-up
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = groups.run(seeds(1), *params)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = _counts()
    _check_counts("path 17 (K15 sweep)", launches,
                  {"skid_steer_sweep_episode": 1})
    for k, v in out.items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"path 17: non-finite values in {k}")
    again = groups.run(seeds(1), *params)
    differ = [k for k in out if not torch.equal(out[k], again[k])]
    if differ:
        raise AssertionError(f"path 17: the same seeds gave other bits in "
                             f"{differ}")
    done, crashed = out["done"][:, :, -1], out["crashed"][:, :, -1]
    episodes = SKID_GROUPS * SKID_SC * SKID_CHAINS
    ended = float(out["done"][:, :, :-1].sum())
    ops, nbytes = skid_steer_work(
        SKID_STEER_DEMO_CONFIG["exp_params"],
        SKID_STEER_DEMO_CONFIG["env_params"], MAIN_STEPS,
        episodes * MAIN_STEPS - ended, episodes)
    bound = _bound(nbytes, ops)
    runs = {"plain": [], "kernel": []}
    kern = lambda: groups.run(seeds(1), *params)
    for which in ("plain", "kernel", "kernel", "plain"):
        if which == "kernel":
            runs[which].append(statistics.median(_event_ms(kern, 7)))
        elif not runs["plain"]:
            runs[which].append(_event_ms(lambda: plain(seeds(1)), 1)[0])
    clock = _phase_clock("K15 (path 17)", kern,
                         skid_steer_episode.phase_clock)
    guard = sweep.wrapper.rollout_guard
    result = {
        "episodes": episodes, "steps": MAIN_STEPS, "seconds": elapsed,
        "solves_per_s": episodes * MAIN_STEPS / elapsed,
        "launches": launches, "max_abs_err": worst,
        "target_share": float(((done > 0.5) & (crashed < 0.5)).float()
                              .mean()),
        "crash_share": float((crashed > 0.5).float().mean()),
        "ms": min(runs["kernel"]), "plain_ms": min(runs["plain"]),
        "runs": runs, "bound_ms": bound[0], "bound_by": bound[1],
        "bound_bytes": bound[2], "bound_ops": bound[3],
        "timed_as": "one launch between CUDA events, median of 7",
        "phase_clock": clock, "rollout_fast": guard.fast,
        "rollout_fallback": guard.fallback}
    print(f"path 17 (K15 sweep): {episodes} episodes x {MAIN_STEPS} steps in "
          f"one launch, {elapsed:.4f} s, {result['solves_per_s']:.1f} "
          f"solves/s; K15 {result['ms']:.3f} ms a call (plain "
          f"{result['plain_ms']:.1f} ms), bound {bound[0]:.4f} ms "
          f"({bound[1]}), {100 * bound[0] / result['ms']:.2f}% of it; "
          f"reached the target {result['target_share']:.4f}, crashed "
          f"{result['crash_share']:.4f}; rollout steps fast "
          f"{guard.fast}, fallback {guard.fallback}; launches {launches}")

    # the fallback: every rollout step past the fast sin/cos's range
    groups, seeds, params, _, sweep = _skid_steer_sweep(dev, 5, th0=2e5)
    guard = sweep.wrapper.rollout_guard
    f0, s0 = guard.fallback, guard.steps
    far = groups.run(seeds(2), *params)
    n_fallback, n_steps = guard.fallback - f0, guard.steps - s0
    for k, v in far.items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"K15 fallback: non-finite values in {k}")
    if n_fallback != n_steps or n_steps == 0:
        raise AssertionError(f"K15 fallback: {n_fallback} fallbacks of "
                             f"{n_steps} rollout steps")
    result["fallback_run"] = {"steps": n_steps, "fallbacks": n_fallback}
    print(f"K15 fallback (heading 2e5 rad, 5 steps): {n_fallback} of "
          f"{n_steps} rollout steps took the library's sincosf")
    return result


def _build_math_check():
    """The check library of `csrc/checks/cartpole_math_check.cu`, built
    with the kernels' flags beside the kernels' library, loaded."""
    import ctypes

    from dust_tpu_torch.ops import _build

    src = _build.SRC_DIR / "checks" / "cartpole_math_check.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / "libcartpole_math_check.so"
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared",
                    str(src), "-o", str(out)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    vp, i32, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong
    lib.dust_check_trig.argtypes = [vp, vp, vp]
    lib.dust_check_div.argtypes = [i32, u64, vp, vp, vp]
    lib.dust_check_eval.argtypes = [vp, i32, vp, vp, i32, vp, vp, vp]
    return lib


def _math_edges():
    """Edge cases of the range tests: (x, trig_ok) and (a, b, div_ok)."""
    f32 = np.float32
    below = lambda v: float(np.nextafter(f32(v), f32(0)))
    tiny = float(np.finfo(np.float32).smallest_subnormal)
    inf, nan = float("inf"), float("nan")
    lo, hi = 2.0 ** -60, 2.0 ** 60
    xs = [(0.0, True), (-0.0, True), (tiny, True), (-tiny, True),
          (1e-30, True), (np.pi, True), (below(105615.0), True),
          (-below(105615.0), True), (105615.0, False), (-105615.0, False),
          (2e5, False), (1e30, False), (inf, False), (-inf, False),
          (nan, False)]
    pairs = [(1.0, 3.0, True), (-7.5, 0.25, True), (lo, 1.0, True),
             (below(lo), 1.0, False), (below(hi), 1.0, True),
             (hi, 1.0, False), (1.0, lo, True), (1.0, below(lo), False),
             (1.0, below(hi), True), (1.0, hi, False),
             (below(hi), lo, True), (lo, below(hi), True),
             (-lo, -below(hi), True), (0.0, 1.0, False),
             (-0.0, 1.0, False), (1.0, 0.0, False), (1.0, -0.0, False),
             (tiny, 1.0, False), (1.0, tiny, False), (inf, 1.0, False),
             (1.0, inf, False), (-inf, 2.0, False), (nan, 1.0, False),
             (1.0, nan, False)]
    return xs, pairs


def phase_cartpole_math(dev):
    """Phase 42: K14's branch-free sin/cos and division against the
    library (see the module docstring)."""
    import torch

    lib = _build_math_check()
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = {}

    def run(call, n_counts, n_first, *args):
        counts = torch.zeros(n_counts, dtype=torch.int64, device=dev)
        first = torch.zeros(n_first, dtype=torch.int32, device=dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        rc = call(*args, counts.data_ptr(), first.data_ptr(), stream)
        end.record()
        torch.cuda.synchronize()
        if rc != 0:
            raise RuntimeError(f"phase 42: CUDA error {rc}")
        return counts.tolist(), first.view(-1).tolist(), \
            start.elapsed_time(end)

    counts, first, ms = run(lib.dust_check_trig, 5, 16 * 6)
    n_trig = 2 * int(np.float32(105615.0).view(np.uint32))
    out["trig"] = {"values": n_trig, "sin_mismatches": counts[0],
                   "cos_mismatches": counts[1],
                   "cosf_mismatches": counts[2], "outside_range": counts[3],
                   "ms": ms}
    if counts[4]:
        raise AssertionError(f"phase 42: fast_sincosf differs from the "
                             f"library: {out['trig']}; first x, sin, fast "
                             f"sin, cos, fast cos, cosf (bits): "
                             f"{[hex(v & 0xffffffff) for v in first[:24]]}")
    for mode, what in ((0, "div_range"), (1, "div_k14")):
        n = 10 ** 9
        counts, first, ms = run(
            lambda *a, mode=mode, n=n: lib.dust_check_div(mode, n, *a), 2,
            16 * 4)
        out[what] = {"pairs": n, "mismatches": counts[0],
                     "outside_range": counts[1], "ms": ms}
        if counts[0] or (mode == 0 and counts[1]):
            raise AssertionError(
                f"phase 42: fast_div differs from `/` ({what}): "
                f"{out[what]}; first a, b, a / b, fast (bits): "
                f"{[hex(v & 0xffffffff) for v in first[:16]]}")

    xs, pairs = _math_edges()
    x = torch.tensor([v for v, _ in xs], dtype=torch.float32, device=dev)
    a = torch.tensor([p[0] for p in pairs], dtype=torch.float32, device=dev)
    b = torch.tensor([p[1] for p in pairs], dtype=torch.float32, device=dev)
    ox = torch.zeros((len(xs), 6), dtype=torch.int32, device=dev)
    od = torch.zeros((len(pairs), 3), dtype=torch.int32, device=dev)
    rc = lib.dust_check_eval(x.data_ptr(), len(xs), a.data_ptr(),
                             b.data_ptr(), len(pairs), ox.data_ptr(),
                             od.data_ptr(), stream)
    torch.cuda.synchronize()
    if rc != 0:
        raise RuntimeError(f"phase 42: CUDA error {rc}")
    for (v, want), row in zip(xs, ox.tolist()):
        if bool(row[0]) != want or (want and not (
                row[1] == row[2] and row[3] == row[4] == row[5])):
            raise AssertionError(f"phase 42: x = {v!r}: trig_ok {row[0]} "
                                 f"(want {int(want)}), bits {row[1:]}")
    for (p, q, want), row in zip(pairs, od.tolist()):
        if bool(row[0]) != want or (want and row[1] != row[2]):
            raise AssertionError(f"phase 42: {p!r} / {q!r}: div_ok "
                                 f"{row[0]} (want {int(want)}), fast "
                                 f"{row[1]:#x}, library {row[2]:#x}")
    out["edges"] = {"x": len(xs), "pairs": len(pairs)}
    out["fallback"], _ = _k14_fallback(dev)
    print(f"phase 42 (K14's sin/cos and division): fast_sincosf equal to "
          f"sincosf and cosf on all {n_trig} floats with |x| < 105615 "
          f"({out['trig']['ms']:.1f} ms); fast_div equal to `/` on 1e9 "
          f"pairs of its range ({out['div_range']['ms']:.1f} ms) and 1e9 "
          f"of K14's ({out['div_k14']['outside_range']} outside the "
          f"range); {len(xs)} + {len(pairs)} edge cases; the planted "
          f"fallback: {out['fallback']}")
    return out


def _k14_fallback(dev, steps=20):
    """K14 from a start angle of 2e5 rad, past the fast range: a sweep of
    path 16's layout, `steps` steps; every rollout chunk-step falls back
    (the angle stays past the range), so the wrapper's count reads all of
    them as fallbacks. Returns the counts and the outputs (chip_compare.py
    hashes them against the parent's)."""
    import torch

    from dust_tpu_torch.ops import cartpole_sweep_episode as cse

    guard = cse.fused_cartpole_sweep_groups.rollout_guard
    before = guard.fast, guard.fallback
    groups, seeds, lens, mps, _ = _cartpole_sweep(dev, steps, th0=2e5)
    out = groups.run(seeds(1), lens, mps)
    fast, fallback = guard.fast - before[0], guard.fallback - before[1]
    if fast != 0 or fallback == 0:
        raise AssertionError(f"phase 42: the planted fallback counted "
                             f"{fast} fast and {fallback} fallback "
                             f"chunk-steps")
    for k, v in out.items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"phase 42: non-finite values in {k} from "
                                 f"th = 2e5")
    return {"fast": fast, "fallback": fallback}, out


def phase_demos(dev):
    """Phase 37: the five demos of `dust_tpu_torch.demo` in-process through
    `main` (default device, the card) or their config functions, each with
    the launch counts set to 0 just before and read just after."""
    import importlib.util

    t0 = time.perf_counter()
    out = {"pendulum_example": _demo_pendulum(dev),
           "particle_example": _demo_particle(),
           "sweep_example": _demo_sweeps(dev),
           "tuning": _demo_tuning()}
    missing = [m for m in ("matplotlib", "seaborn", "pandas")
               if importlib.util.find_spec(m) is None]
    print("phase 37: plots.py and the demos' --render are not called here ("
          + (f"{', '.join(missing)} not installed" if missing else
             "the CPU tests hold them against dust_tpu's") + ")")
    out["seconds"] = time.perf_counter() - t0
    launches = {}
    for part in _walk_launches(out):
        for k, v in part.items():
            launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    print(f"phase 37 (the demos): every check passed in "
          f"{out['seconds']:.3f} s; launches {launches}")
    return out


def _walk_launches(node):
    """Every "launches" dict in a nested result."""
    if isinstance(node, dict):
        for k, v in node.items():
            if k == "launches" and isinstance(v, dict):
                yield v
            else:
                yield from _walk_launches(v)


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
    multi = phase_multi_device(dev, PENDULUM_DEMO_CONFIG, path4.pop("out"),
                               path9.pop("out"), path13.pop("out"))
    tuning = phase_tuning(dev, PENDULUM_DEMO_CONFIG)
    ckpt = phase_checkpoints(dev, PENDULUM_DEMO_CONFIG)
    demos = phase_demos(dev)
    general = phase_stream_general(dev)
    path14 = phase_main_path(dev, PENDULUM_DEMO_CONFIG, adam=True)
    loop14_err = phase_kernel_vs_plain(dev, PENDULUM_DEMO_CONFIG, adam=True)
    path15 = phase_wide_mpf_path(dev)
    path16 = phase_k14(dev)
    times["cartpole_sweep_episode"] = path16
    cartpole_math = phase_cartpole_math(dev)
    path17 = phase_k15(dev)
    times["skid_steer_sweep_episode"] = path17
    for name, err in general["max_abs_err"].items():
        stream_errs[name] = max(stream_errs[name], err)

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
             path11["m=8192 fuse_streams"]),
            ("cartpole_sweep_episode",
             "dust_tpu_torch/csrc/cartpole_episode.cu", "none (port only)",
             path16["max_abs_err"], path16),
            ("skid_steer_sweep_episode",
             "dust_tpu_torch/csrc/skid_steer_episode.cu", "none (port only)",
             path17["max_abs_err"], path17)):
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
        "multi_device": multi, "tuning": tuning, "checkpoints": ckpt,
        "demos": demos, "stream_general": general, "path14_adam": path14,
        "path15_wide_fused_mpf": path15, "path16_k14_sweep": path16,
        "cartpole_math": cartpole_math, "path17_k15_sweep": path17,
        "path14_vs_plain_path_max_abs_err": loop14_err, "kernels": kernels,
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
