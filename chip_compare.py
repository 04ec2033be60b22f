"""Path 11 and the redesigned kernels of one checkout, for comparing two
commits on one card.

Run from the root of a checkout, on a machine with a card:

    python3 /path/to/chip_compare.py LABEL

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
(m = 50 and 1024), K13, K8, a 20-step K5 sweep on fixed seeded inputs
(host noise) and a 200-step K9 episode (device noise), so that two trees
can be held bit for bit. Where the tree has them, it prints the per-phase
clocks of K1, K2, K3, K6 and K7 (their clocked builds,
`chip_smoke._phase_clock`). It prints one line, `RESULT {json}`. To
compare a parent and a change, unpack both (`git archive`) and run the
script once in each, in the order parent, change, change, parent, in one
call on one card:

    for t in parent change change parent; do (cd $t && python3 ../chip_compare.py $t); done

It calls only functions that `chip_smoke.py` has had since its K10-K13
slice, and K1's wrapper and hook, which every tree has, so it runs in
older checkouts too.
"""
import copy
import hashlib
import json
import os
import statistics
import sys

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from dust_tpu_torch.experiments import (  # noqa: E402
    PENDULUM_DEMO_CONFIG,
    build_pendulum_stack,
)
from dust_tpu_torch.models import PendulumModel  # noqa: E402
from dust_tpu_torch.ops import gmm, mpf, mpf_stream, rollout, solve, svgd  # noqa: E402
from dust_tpu_torch.ops import particle_mpf as pm  # noqa: E402
from dust_tpu_torch.ops import particle_rollout as pr  # noqa: E402
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


def sha256(tensors):
    """One hash of the tensors' bytes, in order: equal hashes, equal bits."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


tree = sys.argv[1]
dev = torch.device("cuda")
cs.phase_build()
res = {"tree": tree, "card": cs._nvidia_smi()}

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
pgroups, pseeds, lens, mass, _ = cs._bench_sweep(dev, PENDULUM_DEMO_CONFIG)
res["k5_ms_per_sweep"] = statistics.median(
    cs._event_ms(lambda: pgroups.run(pseeds(1), lens, mass), 3))
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
print("RESULT", json.dumps(res), flush=True)
