"""Path 11 and the redesigned kernels of one checkout, for comparing two
commits on one card.

Run from the root of a checkout, on a machine with a card:

    python3 /path/to/chip_compare.py LABEL

It builds the checkout's kernels, drives path 11 (`chip_smoke.py`'s
`phase_fused_mpf_path`: FusedMPF.optimize at m = 2048, 8192, 32768 and with
fuse_streams), times K11a at m = 2048, d = 1, K11b, K12b and K13 at
m = 8192 and 32768, d = 2 (`chip_smoke._device_ms`), K7 at the particle
demo's shape, one 200-step K9 episode (path 7's shape) and one 256-episode
K10 sweep (path 8's) between CUDA events (median of 3), and hashes K13's
two outputs on fixed seeded inputs, so that two trees can be held bit for
bit. It prints one line, `RESULT {json}`. To compare a parent and a change,
unpack both (`git archive`) and run the script once in each, in the order
parent, change, change, parent, in one call on one card:

    for t in parent change change parent; do (cd $t && python3 ../chip_compare.py $t); done

It calls only functions that `chip_smoke.py` has had since its K10-K13
slice, so it runs in older checkouts too.
"""
import hashlib
import json
import os
import statistics
import sys

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from dust_tpu_torch.ops import gmm, mpf_stream, svgd  # noqa: E402
from dust_tpu_torch.ops import particle_mpf as pm  # noqa: E402
from dust_tpu_torch.simulation import (  # noqa: E402
    megakernel_particle_episode_fn,
)

tree = sys.argv[1]
dev = torch.device("cuda")
cs.phase_build()
res = {"tree": tree, "card": cs._nvidia_smi()}
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

kgen = torch.Generator(device=dev).manual_seed(cs.SEED + 50)
inp = cs._k7_inputs(kgen, dev, True, (0.4, -0.2), (3.0, -5.0), 0.015)
res["k7_ms"] = min(cs._device_ms(
    lambda: pm.fused_particle_mpf_optimize(**inp, n_steps=20))
    for _ in range(2))
cfg, stack = cs._particle_stack(dev)
episode = megakernel_particle_episode_fn(stack, cfg["exp_params"],
                                         steps=cs.MAIN_STEPS)
res["k9_ms_per_episode"] = statistics.median(
    cs._event_ms(lambda: episode([cs.SEED, 1]), 3))
groups, seeds, masses, _ = cs._bench_particle_sweep(dev, cs.MAIN_STEPS)
res["k10_ms_per_sweep"] = statistics.median(
    cs._event_ms(lambda: groups.run(seeds(1), masses), 3))
print("RESULT", json.dumps(res), flush=True)
