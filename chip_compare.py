"""Path 11 and the redesigned kernels of one checkout, for comparing two
commits on one card.

Run from the root of a checkout, on a machine with a card:

    python3 /path/to/chip_compare.py LABEL [--wide-only]

It builds the checkout's kernels, times K1 at the demo's shapes, alone and
as path 1's MultiDisco hook (`make_fused_pendulum_state_costs` on stride-2
draw columns: device ms, ms per call and device operations per call by
torch.profiler), drives path 11 (`chip_smoke.py`'s `phase_fused_mpf_path`:
FusedMPF.optimize at m = 2048, 8192, 32768 and with fuse_streams), times
K11a at m = 2048, d = 1, K11b, K12b and K13 at m = 8192 and 32768, d = 2,
K2, K3, K6, K7 and K8 at the demos' shapes (`chip_smoke._device_ms`; K2
and K7 also at m = 1024), one 200-step K4 and K9 episode (paths 3 and 7)
and one 256-episode K5 and K10 sweep (paths 4 and 8) between CUDA events
(median of 3), and hashes the outputs of K1 (its costs, and the hook's
draw means on their own), K2, K3 (its costs also on their own), K6, K7
(m = 50 and 1024), K13, K11a and K12a at d = 60, K8, a 200-step K4
episode, a 20-step K5 sweep on fixed seeded inputs (host noise) at the
demo's 50 MPF particles and at 48, 49, 52, 53, 64, 100 and 256 (both MPF
loops of the episode kernels), the timed 200-step K5 and K14 sweeps
(device noise), a 200-step K9 episode (device noise) and a 20-step K10
sweep (its final log-weights with it; device noise and host noise) at
the demo's 50 MPF particles and at 48, 49, 52, 53 and 64 (both MPF loops
of K9/K10), with the timed K10 sweep's per-phase clock, so
that two trees can be held bit for bit, and reads the episode wrappers'
launch, prepared-input and MPF-loop counters after its calls. It also
hashes a 20-step K14 sweep from a start angle of 2e5 rad, where every
rollout chunk-step takes the library's sincosf and division, with the
wrapper's fast / fallback counts of it, and of all its K14 calls, where
the tree has them. It also
times one 256-episode K14 sweep (path 16, as K5's) and, where the tree
has it, one 256-episode K15 sweep (path 17), and hashes K15's outputs;
and reads the registers and spill bytes of the episode kernels K4/K5,
K9/K10, K14 and K15 and of K7's register loop from the build's ptxas
report (empty where the
library was already built). Where the tree has them, it prints the
per-phase clocks of K1, K2, K3, K6 and K7 (their clocked builds,
`chip_smoke._phase_clock`). It prints one line, `RESULT {json}`. To
compare a parent and a change, unpack both (`git archive`) and run the
script once in each, in the order parent, change, change, parent, in one
call on one card:

    for t in parent change change parent; do (cd $t && python3 ../chip_compare.py $t); done

First it times K11a and K12a (k = m) on their general walk (d > 8) at
`chip_smoke.WIDE_TIMED`'s shapes beside their bounds and, for K12a, one
SDPA call's time and backend; drives path 15 (FusedMPF.optimize over d =
64 and 256 parameters); hashes K11a's and K12a's outputs at d = 2 (the
d <= 8 walk); and times one cuBLAS float32 GEMM, the card's practical
float32 rate in the run. Those measurements come from the `chip_smoke.py` beside this
script, so an older checkout is measured by the same code; `--wide-only`
stops after them.

Otherwise it calls only functions that the checkout's `chip_smoke.py` has
had since its K10-K13 slice, and K1's wrapper and hook, which every tree
has, so it runs in older checkouts too.
"""
import copy
import hashlib
import importlib.util
import json
import os
import statistics
import sys
import types
from pathlib import Path

sys.path.insert(0, os.getcwd())
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from dust_tpu_torch.experiments import (  # noqa: E402
    PENDULUM_DEMO_CONFIG,
    build_pendulum_stack,
)
from dust_tpu_torch.models import PendulumModel  # noqa: E402
from dust_tpu_torch.ops import gmm, mpf, mpf_stream, rollout, solve, svgd  # noqa: E402
from dust_tpu_torch.ops import cartpole_sweep_episode as cse  # noqa: E402
from dust_tpu_torch.ops import episode as ep  # noqa: E402
from dust_tpu_torch.ops import particle_episode as pe  # noqa: E402
from dust_tpu_torch.ops import particle_mpf as pm  # noqa: E402
from dust_tpu_torch.ops import particle_rollout as pr  # noqa: E402
from dust_tpu_torch.ops import particle_sweep_episode as pse  # noqa: E402
from dust_tpu_torch.ops import sweep_episode  # noqa: E402
from dust_tpu_torch.simulation import (  # noqa: E402
    megakernel_particle_episode_fn,
    megakernel_pendulum_episode_fn,
)


def device_ops(fn, calls=20):
    """Device operations (kernels, copies, fills) per call of fn, counted
    by torch.profiler over `calls` calls: (ops per call, {name: per
    call}). The same count as `chip_smoke._device_ops`, kept here so that
    the script runs in trees that lack it."""
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


def ptxas_usage(log, kernels=("pendulum_episode_kernel",
                                "particle_episode_kernel",
                                "cartpole_episode_kernel",
                                "skid_steer_episode_kernel",
                                "particle_mpf_reg_kernel")):
    """{mangled entry: {registers, spill_stores, spill_loads}} of each
    compiled entry whose name holds one of `kernels`, from the build's
    `ptxas -v` lines."""
    import re

    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            entry = m.group(1) if any(k in m.group(1) for k in kernels) \
                else None
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(entry, {}).update(spill_stores=int(m.group(1)),
                                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(entry, {})["registers"] = int(m.group(1))
    return out


def sha256(tensors):
    """One hash of the tensors' bytes, in order: equal hashes, equal bits."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


tree = sys.argv[1]
dev = torch.device("cuda")
build = cs.phase_build()
res = {"tree": tree, "card": cs._nvidia_smi(),
       "ptxas": ptxas_usage(build.get("log", "") if isinstance(build, dict)
                            else "")}

# K11a and K12a's general walk, K12a's SDPA yardstick, path 15 and the d = 2
# hash, measured by the chip_smoke.py beside this script on the checkout's
# kernels (its functions import the checkout's dust_tpu_torch, loaded above)
_spec = importlib.util.spec_from_file_location(
    "chip_smoke_beside", Path(__file__).resolve().with_name("chip_smoke.py"))
beside = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(beside)
# K15's wrapper, where the tree has it; in a tree before K15 the beside
# script's launch counts (`_wrappers`) read a stand-in that never launches
try:
    from dust_tpu_torch.ops import skid_steer_sweep_episode as sse
except ImportError:
    sse = None
    sys.modules["dust_tpu_torch.ops.skid_steer_sweep_episode"] = (
        types.SimpleNamespace(fused_skid_steer_sweep_groups=(
            types.SimpleNamespace(launches=0))))
res["wide"] = beside.wide_times(dev, plain=False)
res["path15_updates_per_s"] = {
    k: v["updates_per_s"] for k, v in beside.phase_wide_mpf_path(dev).items()}
res["k11_k12_d2_sha256"] = beside._d2_sha256(dev)
res["sgemm_tflops"] = beside.sgemm_tflops(dev)
if "--wide-only" in sys.argv[2:]:
    print("RESULT", json.dumps(res), flush=True)
    sys.exit(0)

# K1 at the demo's shapes: the wrapper alone (contiguous columns) and path
# 1's MultiDisco hook on stride-2 draw columns (as MultiDisco.
# _sample_params builds them): device ms per call, the hook's ms per call
# and its device operations per call; K1's costs hashed on fixed inputs
# (contiguous, stride-2 columns, the odd shape, a 300-step horizon), the
# hook's draw means hashed on their own
k1_gen = torch.Generator(device=dev).manual_seed(cs.SEED + 70)
k1_s0, k1_acts, k1_lens, k1_masses = cs._k1_inputs(8, 128, 3, 30,
                                                   (3.0, 0.0), k1_gen, dev)
k1_draws = torch.stack([k1_lens, k1_masses], dim=1)
k1_params = {k: k1_draws[:, i].reshape(8, 1, 1, 1)
             for i, k in enumerate(("length", "mass"))}
k1_hook_fn = rollout.make_fused_pendulum_state_costs(PendulumModel())
k1_state = k1_s0.reshape(1, 2)
k1_hook = lambda: k1_hook_fn(k1_state, k1_acts, k1_params)  # noqa: E731
res["k1_ms"] = min(cs._device_ms(
    lambda: rollout.fused_pendulum_rollout_costs(k1_s0, k1_acts, k1_lens,
                                                 k1_masses))
    for _ in range(2))
res["k1_hook_ms"] = min(cs._device_ms(k1_hook) for _ in range(2))
res["k1_hook_call_ms"] = min(cs._call_ms(k1_hook) for _ in range(2))
res["k1_hook_ops_per_call"], res["k1_hook_ops"] = device_ops(k1_hook)
k1_odd = cs._k1_inputs(3, 7, 3, 11, (0.2, 7.9), k1_gen, dev)
k1_long = cs._k1_inputs(2, 5, 3, 300, (3.0, 0.0), k1_gen, dev)
res["k1_sha256"] = sha256(
    rollout.fused_pendulum_rollout_costs(*args) for args in (
        (k1_s0, k1_acts, k1_lens, k1_masses),
        (k1_s0, k1_acts, k1_draws[:, 0], k1_draws[:, 1]), k1_odd, k1_long))
res["k1_hook_sha256"] = sha256(
    [k1_hook(), k1_hook_fn(k1_state, k1_acts, {"mass": k1_params["mass"]}),
     k1_hook_fn(k1_state, k1_acts, None)])
# the per-phase clock of K1 (through the hook, as path 1 launches it),
# where the tree has it
if hasattr(rollout, "phase_clock"):
    res["k1_clock"] = cs._phase_clock(
        f"{tree} K1", k1_hook, rollout.phase_clock, steps=1, calls=20,
        per="call")

path11 = cs.phase_fused_mpf_path(dev)
res["updates_per_s"] = {k: v["updates_per_s"] for k, v in path11.items()}
gen = torch.Generator(device=dev).manual_seed(cs.SEED + 80)
dt = lambda v: torch.tensor(v, device=dev)  # noqa: E731
bw, pbw, lr = dt(0.3), dt(0.2), dt(1e-3)
x1, s1, _ = cs._stream_inputs(2048, 1, gen, dev)
res["k11a_ms_2048"] = min(cs._device_ms(
    lambda: svgd.svgd_phi_streamed(x1, s1, bw)) for _ in range(2))
for m in (8192, 32768):
    x, s, c = cs._stream_inputs(m, 2, gen, dev)
    res[f"k13_ms_{m}"] = min(cs._device_ms(
        lambda: mpf_stream.fused_mpf_stream_step(x, s, c, bw, pbw, lr))
        for _ in range(2))
    res[f"k12b_ms_{m}"] = min(cs._device_ms(
        lambda: gmm.gmm_prior_score_streamed_packed(x, c, pbw))
        for _ in range(2))
    res[f"k11b_ms_{m}"] = min(cs._device_ms(
        lambda: svgd.svgd_phi_streamed_packed(x, s, bw)) for _ in range(2))

# K13's outputs on fixed inputs, hashed: equal hashes, equal bits
digest = hashlib.sha256()
hgen = torch.Generator(device=dev).manual_seed(cs.SEED + 90)
for m, d in ((8192, 2), (2049, 3), (33, 8)):
    x, s, c = cs._stream_inputs(m, d, hgen, dev)
    for out in mpf_stream.fused_mpf_stream_step(x, s, c, bw, pbw, lr):
        digest.update(out.cpu().numpy().tobytes())
res["k13_sha256"] = digest.hexdigest()

# K11a and K12a at d = 60 (their general walk) on numpy-seeded inputs: the
# same code as chip_smoke.py's _d60_sha256, kept here so that the script
# runs in trees that lack it; chip_smoke.py's D60_SHA256 is this hash of
# the register-tiled walk (stream_tile2d.cuh)
d60_rng = np.random.default_rng(60)
d60_x, d60_s = (torch.tensor(a.astype(np.float32), device=dev) for a in (
    d60_rng.normal(size=(300, 60)) + 0.8,
    5.0 * d60_rng.normal(size=(300, 60))))
d60_c = torch.tensor(d60_rng.normal(size=(130, 60)).astype(np.float32),
                     device=dev)
res["k11_k12_d60_sha256"] = sha256([
    svgd.svgd_phi_streamed(d60_x, d60_s, 0.7 * 60 ** 0.5),
    gmm.gmm_prior_score_streamed(d60_x, d60_c, 0.4 * 60 ** 0.5)])

# the pendulum kernels K2-K5 at the demo's shapes
pgen = torch.Generator(device=dev).manual_seed(cs.SEED + 5)
k2_in = cs._k2_inputs(50, (2.9, 0.4), (2.95, 0.9), 1.3, pgen, dev)
res["k2_ms"] = min(cs._device_ms(
    lambda: mpf.fused_pendulum_mpf_optimize(**k2_in, n_steps=20))
    for _ in range(2))
k3_args = cs._k3_inputs(30, 3, 8, 128, (3.0, 0.0), pgen, dev)
k3_st = dict(hz=30, m=3, n_params=8, n_act=128, exp_util=True)
res["k3_ms"] = min(cs._device_ms(
    lambda: solve.fused_pendulum_solve(*k3_args, **k3_st)) for _ in range(2))
# K2's and K3's outputs on those inputs, hashed; K3's costs on their own
res["k2_sha256"] = sha256(
    [mpf.fused_pendulum_mpf_optimize(**k2_in, n_steps=20)])
k3_out = solve.fused_pendulum_solve(*k3_args, **k3_st)
res["k3_sha256"] = sha256(k3_out)
res["k3_costs_sha256"] = sha256(k3_out[6:])
# K2 on its general path (m = 1024)
k2_big = cs._k2_inputs(1024, (2.9, 0.4), (2.95, 0.9), 1.3, pgen, dev)
res["k2_ms_1024"] = min(cs._device_ms(
    lambda: mpf.fused_pendulum_mpf_optimize(**k2_big, n_steps=20))
    for _ in range(2))
res["k2_sha256_1024"] = sha256(
    [mpf.fused_pendulum_mpf_optimize(**k2_big, n_steps=20)])
# the per-phase clocks of K2 and K3, where the tree has them
if hasattr(mpf, "phase_clock"):
    res["k2_clock"] = cs._phase_clock(
        f"{tree} K2", lambda: mpf.fused_pendulum_mpf_optimize(
            **k2_in, n_steps=20), mpf.phase_clock, steps=1, calls=20,
        per="call")
if hasattr(solve, "pendulum_phase_clock"):
    res["k3_clock"] = cs._phase_clock(
        f"{tree} K3", lambda: solve.fused_pendulum_solve(*k3_args, **k3_st),
        solve.pendulum_phase_clock, steps=1, calls=20, per="solve")
pcfg = copy.deepcopy(PENDULUM_DEMO_CONFIG)
pstack = build_pendulum_stack(
    pcfg, torch.Generator(device=dev).manual_seed(cs.SEED), case="dust",
    device=dev)
k4 = megakernel_pendulum_episode_fn(pstack, pcfg["exp_params"],
                                    steps=cs.MAIN_STEPS)
res["k4_ms_per_episode"] = statistics.median(
    cs._event_ms(lambda: k4([cs.SEED, 1]), 3))
k4_out = k4([cs.SEED, 1])
res["k4_sha256"] = sha256(k4_out[k] for k in sorted(k4_out)
                          if torch.is_tensor(k4_out[k]))
pgroups, pseeds, lens, mass, _ = cs._bench_sweep(dev, PENDULUM_DEMO_CONFIG)
res["k5_ms_per_sweep"] = statistics.median(
    cs._event_ms(lambda: pgroups.run(pseeds(1), lens, mass), 3))
k5_timed = pgroups.run(pseeds(1), lens, mass)
res["k5_timed_sha256"] = sha256(k5_timed[k] for k in sorted(k5_timed))
# K14: the cart-pole cell's 256-episode sweep (path 16), timed as K5's,
# and its outputs hashed
cgroups, cseeds, clens, cmps, _ = cs._cartpole_sweep(dev, cs.MAIN_STEPS)
res["k14_ms_per_sweep"] = statistics.median(
    cs._event_ms(lambda: cgroups.run(cseeds(1), clens, cmps), 3))
k14_out = cgroups.run(cseeds(1), clens, cmps)
res["k14_sha256"] = sha256(k14_out[k] for k in sorted(k14_out))
# K14 from a start angle past its rollouts' fast range (2e5 rad), 20 steps
# of path 16's layout: every rollout chunk-step takes the library's sincosf
# and division; its outputs hashed, and the wrapper's fast / fallback
# counts where the tree has them
guard = getattr(cse.fused_cartpole_sweep_groups, "rollout_guard", None)
before = None if guard is None else (guard.fast, guard.fallback)
fgroups, fseeds, flens, fmps, _ = beside._cartpole_sweep(dev, 20, th0=2e5)
k14_fb = fgroups.run(fseeds(1), flens, fmps)
res["k14_fallback_sha256"] = sha256(k14_fb[k] for k in sorted(k14_fb))
res["k14_fallback_counts"] = None if guard is None else [
    guard.fast - before[0], guard.fallback - before[1]]
# K15: the skid-steer cell's 256-episode sweep (path 17), timed as K14's,
# and its outputs hashed, where the tree has it
if sse is not None:
    sgroups, sseeds, sparams, _, _ = beside._skid_steer_sweep(
        dev, cs.MAIN_STEPS)
    res["k15_ms_per_sweep"] = statistics.median(
        cs._event_ms(lambda: sgroups.run(sseeds(1), *sparams), 3))
    k15_out = sgroups.run(sseeds(1), *sparams)
    res["k15_sha256"] = sha256(k15_out[k] for k in sorted(k15_out))
# K5's outputs on fixed host-noise inputs, 16 scenarios x 2 chains x 20 steps
steps = 20
theta0, mpfx0, noise = cs._episode_setup(steps, cs.SEED + 13, dev,
                                         cs.SWEEP_SC, cs.SWEEP_CHAINS)
k5_out = cs._sweep_call(
    sweep_episode.fused_pendulum_sweep_episode, [1, 2], theta0, mpfx0,
    torch.linspace(0.8, 1.2, cs.SWEEP_SC, device=dev),
    torch.linspace(0.9, 1.1, cs.SWEEP_SC, device=dev), dev, steps,
    cs.SWEEP_SC, cs.SWEEP_CHAINS, noise)
res["k5_sha256"] = sha256(k5_out[k] for k in sorted(k5_out))
# the same sweep at other MPF widths: 49 and 52 particles (the ends of the
# episode kernels' register loop), 48, 53, 64, 100 and 256 (their
# shared-memory walk, which the kernel takes up to 256; the wrapper keeps
# the TPU adapter's m_mpf <= 64, so its check is set aside above that)
check_dims = sweep_episode.check_sweep_dims
for m_mpf in (48, 49, 52, 53, 64, 100, 256):
    sweep_episode.check_sweep_dims = (
        check_dims if m_mpf <= 64 else lambda *a, **k: None)
    wrng = np.random.default_rng(m_mpf)
    wx = torch.tensor(1.0 + 0.1 * wrng.normal(size=(m_mpf, 2)),
                      dtype=torch.float32, device=dev)
    wargs = cs._episode_args(
        theta0, wx, dev, torch.linspace(0.8, 1.2, cs.SWEEP_SC, device=dev),
        torch.linspace(0.9, 1.1, cs.SWEEP_SC, device=dev))
    w_out = sweep_episode.fused_pendulum_sweep_episode(
        [1, 2], *wargs[:4], *wargs[5:], n_sc=cs.SWEEP_SC, steps=steps,
        n_chains=cs.SWEEP_CHAINS, host_eps=noise[0], host_pdz=noise[1],
        host_pdu=noise[2], **dict(cs._EP, m_mpf=m_mpf))
    res[f"k5_sha256_mpf{m_mpf}"] = sha256(w_out[k] for k in sorted(w_out))
sweep_episode.check_sweep_dims = check_dims

kgen = torch.Generator(device=dev).manual_seed(cs.SEED + 50)
inp = cs._k7_inputs(kgen, dev, True, (0.4, -0.2), (3.0, -5.0), 0.015)
res["k7_ms"] = min(cs._device_ms(
    lambda: pm.fused_particle_mpf_optimize(**inp, n_steps=20))
    for _ in range(2))
# K7 at m = 1024 (its general path; the inputs made here, as
# chip_smoke._k7_inputs makes them at m = 50)
xb = torch.log(1.6 + 0.8 * torch.rand((1024, 1), generator=kgen,
                                      device=dev))
k7_big = dict(inp, x=xb, prior_locs=xb + 0.02 * torch.randn(
    (1024, 1), generator=kgen, device=dev))
res["k7_ms_1024"] = min(cs._device_ms(
    lambda: pm.fused_particle_mpf_optimize(**k7_big, n_steps=20))
    for _ in range(2))
res["k7_sha256"] = sha256([pm.fused_particle_mpf_optimize(**inp, n_steps=20)])
res["k7_sha256_1024"] = sha256(
    [pm.fused_particle_mpf_optimize(**k7_big, n_steps=20)])
if hasattr(pm, "phase_clock"):
    res["k7_clock"] = cs._phase_clock(
        f"{tree} K7", lambda: pm.fused_particle_mpf_optimize(
            **inp, n_steps=20), pm.phase_clock, steps=1, calls=20,
        per="call")
cfg, stack = cs._particle_stack(dev)
# K6 at the demo's shapes (4 x 64 x 6, H 40), and its costs hashed from a
# free start, a start inside an obstacle and one inside a wall
k6_kw = cs._pkw(stack.model)
k6_gen = torch.Generator(device=dev).manual_seed(cs.SEED + 60)
k6_acts = 5.0 * torch.randn((64, 6, 40, 2), generator=k6_gen, device=dev)
k6_masses = 1.7 + 0.7 * torch.rand((4,), generator=k6_gen, device=dev)
k6_s0 = torch.tensor([-9.0, -9.0, 0.0, 0.0], device=dev)
res["k6_ms"] = min(cs._device_ms(
    lambda: pr.fused_particle_rollout_costs(k6_s0, k6_acts, k6_masses,
                                            **k6_kw)) for _ in range(2))
res["k6_sha256"] = sha256(
    pr.fused_particle_rollout_costs(torch.tensor([*start, 0.8, 1.2],
                                                 device=dev),
                                    k6_acts, k6_masses, **k6_kw)
    for start in ((-9.0, -9.0), (2.0, 2.0), (10.95, 0.3)))
if hasattr(pr, "phase_clock"):
    res["k6_clock"] = cs._phase_clock(
        f"{tree} K6", lambda: pr.fused_particle_rollout_costs(
            k6_s0, k6_acts, k6_masses, **k6_kw), pr.phase_clock, steps=1,
        calls=20, per="call")
k8_args = cs._k8_inputs(torch.Generator(device=dev).manual_seed(cs.SEED + 22),
                        dev, (-9.0, -9.0))
k8_st = dict(cs._K8_STATICS, exp_util=True, **cs._pkw(stack.model))
res["k8_ms"] = min(cs._device_ms(
    lambda: solve.fused_particle_solve(*k8_args, **k8_st)) for _ in range(2))
res["k8_sha256"] = sha256(solve.fused_particle_solve(*k8_args, **k8_st))
episode = megakernel_particle_episode_fn(stack, cfg["exp_params"],
                                         steps=cs.MAIN_STEPS)
res["k9_ms_per_episode"] = statistics.median(
    cs._event_ms(lambda: episode([cs.SEED, 1]), 3))
k9_out = episode([cs.SEED, 1])
res["k9_sha256"] = sha256(k9_out[k] for k in sorted(k9_out)
                          if torch.is_tensor(k9_out[k]))
groups, seeds, masses, _ = cs._bench_particle_sweep(dev, cs.MAIN_STEPS)
res["k10_ms_per_sweep"] = statistics.median(
    cs._event_ms(lambda: groups.run(seeds(1), masses), 3))
# K10's outputs, its final prior log-weights among them, on a fixed 20-step
# sweep of 8 scenarios x 4 chains, in device-RNG and in host-noise mode
k10_masses = torch.linspace(1.6, 2.4, cs.PSWEEP_SC, device=dev)
k10_noise = tuple(v[None] for v in cs._psweep_noise(
    cs.PSWEEP_SC, cs.PSWEEP_CHAINS, steps, cs.SEED + 61, dev))
for key, nz in (("k10_sha256", None), ("k10_host_noise_sha256", k10_noise)):
    k10_out = cs._psweep_call(
        pse.fused_particle_sweep_groups, cfg, stack,
        torch.tensor([[3, 7]], device=dev), k10_masses, steps, cs.PSWEEP_SC,
        cs.PSWEEP_CHAINS, noise=nz)
    res[key] = sha256(k10_out[k] for k in sorted(k10_out))
# the same sweep at other MPF widths, in both noise modes: 49 and 52 (the
# ends of K9/K10's register loop), 48, 53 and 64 (its shared-memory walk)
for m_mpf in (48, 49, 52, 53, 64):
    wcfg = copy.deepcopy(cfg)
    wcfg["exp_params"]["mpf_n_particles"] = m_mpf
    wx = torch.log(torch.tensor(
        1.6 + 0.8 * np.random.default_rng(m_mpf).random((m_mpf, 1)),
        dtype=torch.float32, device=dev))
    for key, nz in ((f"k10_sha256_mpf{m_mpf}", None),
                    (f"k10_host_noise_sha256_mpf{m_mpf}", k10_noise)):
        w_out = cs._psweep_call(
            pse.fused_particle_sweep_groups, wcfg, stack,
            torch.tensor([[3, 7]], device=dev), k10_masses, steps,
            cs.PSWEEP_SC, cs.PSWEEP_CHAINS, mpfx0=wx, noise=nz)
        res[key] = sha256(w_out[k] for k in sorted(w_out))
# the timed 256-episode K10 sweep's per-phase clock (its clocked build)
res["k10_clock"] = cs._phase_clock(
    f"{tree} K10", lambda: groups.run(seeds(1), masses), pe.phase_clock)
# the episode wrappers' counters after this script's calls (None where the
# tree's wrapper has no such counter)
res["counters"] = {
    w.__name__: {k: getattr(w, k, None) for k in (
        "launches", "input_hits", "input_builds", "mpf_reg_launches",
        "mpf_smem_launches")}
    for w in (ep.fused_pendulum_episode,
              sweep_episode.fused_pendulum_sweep_episode,
              pe.fused_particle_episode, pse.fused_particle_sweep_episode,
              cse.fused_cartpole_sweep_groups,
              *(() if sse is None else (sse.fused_skid_steer_sweep_groups,)))}
guard = getattr(cse.fused_cartpole_sweep_groups, "rollout_guard", None)
res["k14_rollout_guard"] = (None if guard is None
                            else [guard.fast, guard.fallback])
print("RESULT", json.dumps(res), flush=True)
