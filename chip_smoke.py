#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`dust_tpu_torch`) on one NVIDIA
GPU: builds the hand-written kernels, holds each against its plain
PyTorch version, drives the pendulum DuSt closed loop through them at the
demo configuration's full width, and times the kernels.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. build the kernels from dust_tpu_torch/csrc with nvcc (sm_90a); print
     the build time and the card's name and power limit;
  2. K1 (rollout costs) against its plain version on the card, at the
     main-path shapes and at an odd shape near the speed clamp;
  3. K2 (the MPF loop) against its plain version, m = 50, 20 steps,
     log_space off and on, and near the speed clamp;
  4. the main path: the `dust` stack from PENDULUM_DEMO_CONFIG with the
     fused rollout (K1) and FusedPendulumMPF (K2), 200 MPC steps of
     PendulumSimulation; every kernel must launch once per step and every
     cost, action and particle must be finite;
  5. kernel path against plain path (rollout loop + autograd MPF) for
     10 steps from the same state and generator seed, re-synced per step;
  6. kernel and plain-version times at the main-path shapes, beside the
     bound: device time per call (20 calls in one CUDA graph, median of 7
     replays) and time per call as the main path pays it (CUDA events
     around one call, median of 100); plain, kernel, kernel, plain.

The line before the last is the kernels' JSON summary; the last line is
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
K2_TOL = dict(rtol=1e-4, atol=1e-5)
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


def _k1_bound(n_params, n_act, n_pol, hz):
    """Least time for K1's work on the card: each input read once, each
    output written once; per trajectory and step 19 float32 operations
    (cost 7: cos, -1, square, *50, om^2, 2 adds; dynamics 12: 2 clamps of
    2, +pi, sin, 2 products, 2 adds, *dt, +), plus the terminal cost (7)
    and the per-thread coefficients (6)."""
    n = n_params * n_act * n_pol
    nbytes = 4 * (2 + n_act * n_pol * hz + 2 * n_params + n)
    ops = n * (19 * hz + 7 + 6)
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


def phase_k1(dev):
    import torch

    from dust_tpu_torch.ops import rollout

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    errs = {}
    for label, shape, state0 in (("main 8x128x3 H30", (8, 128, 3, 30),
                                  (3.0, 0.0)),
                                 ("odd 3x7x3 H11", (3, 7, 3, 11),
                                  (0.2, 7.9))):
        s0, acts, lens, masses = _k1_inputs(*shape, state0, gen, dev)
        got = rollout.fused_pendulum_rollout_costs(s0, acts, lens, masses)
        torch.cuda.synchronize()
        want = rollout.pendulum_rollout_costs_plain(s0, acts, lens, masses)
        errs[label] = _check_close(f"K1 {label}", got, want, **K1_TOL)
    return max(errs.values())


def phase_k2(dev):
    import torch

    from dust_tpu_torch.ops import mpf

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    errs = {}
    for label, log_space, past_obs, loc, action in (
            ("m50 log_space=False", False, (2.9, 0.4), (2.95, 0.9), 1.3),
            ("m50 log_space=True", True, (2.9, 0.4), (2.95, 0.9), -2.6),
            ("m50 near speed clamp", False, (0.5, 7.9), (0.6, 8.0), 2.0)):
        inp = _k2_inputs(50, past_obs, loc, action, gen, dev, log_space)
        got = mpf.fused_pendulum_mpf_optimize(**inp, n_steps=20,
                                              log_space=log_space)
        torch.cuda.synchronize()
        scal = mpf._scalars(inp["x"], inp["past_obs"], inp["loc"],
                            inp["action"], inp["bw"], inp["prior_bw"],
                            inp["lr"], inp["obs_sigma"])
        want = mpf.pendulum_mpf_optimize_plain(inp["x"], inp["prior_locs"],
                                               scal, n_steps=20,
                                               log_space=log_space)
        if (want - inp["x"]).abs().max().item() < 1e-4:
            raise AssertionError(f"K2 {label}: the particles did not move")
        errs[label] = _check_close(f"K2 {label}", got, want, **K2_TOL)
    return max(errs.values())


def _kernel_harness(config, arrays, dev, fused, steps):
    """A stack and harness on the kernel path (fused=True: K1 hook +
    FusedPendulumMPF) or the plain path (rollout loop + autograd MPF),
    wired around the same initial arrays, as bench.py wires the JAX
    stack."""
    from dust_tpu_torch.experiments import assemble_stack
    from dust_tpu_torch.inference import FusedPendulumMPF
    from dust_tpu_torch.simulation import PendulumSimulation

    cfg = copy.deepcopy(config)
    cfg["exp_params"]["fused_rollout"] = fused
    stack = assemble_stack(cfg, arrays, case="dust", device=dev)
    if fused:
        stack.mpf = FusedPendulumMPF.from_mpf(stack.mpf)
    harness = PendulumSimulation(
        controller=stack.controller, svmpc=stack.svmpc, mpf=stack.mpf,
        model=stack.model, steps=steps, warm_up=0, mpf_bw=stack.mpf_bw,
        mpf_steps=stack.mpf_steps, device=dev,
    )
    return stack, harness


def phase_main_path(dev, config):
    import torch

    from dust_tpu_torch.experiments import build_pendulum_stack
    from dust_tpu_torch.inference import FusedPendulumMPF
    from dust_tpu_torch.ops import mpf, rollout
    from dust_tpu_torch.simulation import PendulumSimulation

    cfg = copy.deepcopy(config)
    cfg["exp_params"]["fused_rollout"] = True
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

    run(5)  # warm-up: library handles, allocator, first-call set-up

    rollout.fused_pendulum_rollout_costs.launches = 0
    mpf.fused_pendulum_mpf_optimize.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cols = run(MAIN_STEPS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {
        "pendulum_rollout_costs": rollout.fused_pendulum_rollout_costs.launches,
        "pendulum_mpf_optimize": mpf.fused_pendulum_mpf_optimize.launches,
    }
    print(f"main path: {MAIN_STEPS} MPC steps "
          f"(8 draws x 128 samples x 3 policies, H 30; 50 MPF particles x "
          f"20 steps) in {elapsed:.3f} s; launches {launches}")
    for name, n in launches.items():
        if n != MAIN_STEPS:
            raise AssertionError(
                f"{name} launched {n} times in {MAIN_STEPS} steps")
    for name in ("Cost", "Actions", "DynParticles", "PolParticles",
                 "Position", "Speed"):
        if not np.isfinite(cols[name]).all():
            raise AssertionError(f"non-finite values in {name}")
    second_half_min = float(cols["Cost"][MAIN_STEPS // 2:].min())
    result = {
        "steps": MAIN_STEPS,
        "seconds": elapsed,
        "solves_per_s": MAIN_STEPS / elapsed,
        "ms_per_step": 1e3 * elapsed / MAIN_STEPS,
        "min_cost_second_half": second_half_min,
        "final_cost": float(cols["Cost"][-1]),
        "launches": launches,
    }
    print(f"main path: {result['solves_per_s']:.1f} solves/s, "
          f"{result['ms_per_step']:.3f} ms per MPC step, lowest cost in "
          f"steps {MAIN_STEPS // 2}-{MAIN_STEPS - 1}: {second_half_min:.4f}")
    return result


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
        inp["x"], inp["prior_locs"], scal, n_steps=20)
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
    return out


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

    kernels = []
    for name, source, replaces, err in (
            ("pendulum_rollout_costs", "dust_tpu_torch/csrc/pendulum_rollout.cu",
             "dust_tpu/ops/pallas_rollout.py:92", k1_err),
            ("pendulum_mpf_optimize", "dust_tpu_torch/csrc/pendulum_mpf.cu",
             "dust_tpu/ops/pallas_mpf.py:169", k2_err)):
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": main_path["launches"][name],
            "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None,
        })

    report = {
        "card": card, "torch": torch.__version__,
        "cuda": torch.version.cuda, "build_seconds": build["seconds"],
        "build_log": build["log"], "main_path": main_path,
        "kernel_vs_plain_path_max_abs_err": loop_err, "timing": times,
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
