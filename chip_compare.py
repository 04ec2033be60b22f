"""Path 11 and the streamed kernels of one checkout, for comparing two
commits on one card.

Run from the root of a checkout, on a machine with a card:

    python3 /path/to/chip_compare.py LABEL

It builds the checkout's kernels, drives path 11 (`chip_smoke.py`'s
`phase_fused_mpf_path`: FusedMPF.optimize at m = 2048, 8192, 32768 and with
fuse_streams) and times K11b, K12b and K13 at m = 8192 and 32768, d = 2
(`chip_smoke._device_ms`), then prints one line, `RESULT {json}`. To
compare a parent and a change, unpack both (`git archive`) and run the
script once in each, in the order parent, change, change, parent, in one
session on one card:

    for t in parent change change parent; do (cd $t && python3 ../chip_compare.py $t); done
"""
import json
import os
import sys

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from dust_tpu_torch.ops import gmm, mpf_stream, svgd  # noqa: E402

tree = sys.argv[1]
dev = torch.device("cuda")
cs.phase_build()
res = {"tree": tree}
path11 = cs.phase_fused_mpf_path(dev)
res["updates_per_s"] = {k: v["updates_per_s"] for k, v in path11.items()}
gen = torch.Generator(device=dev).manual_seed(cs.SEED + 80)
dt = lambda v: torch.tensor(v, device=dev)  # noqa: E731
bw, pbw, lr = dt(0.3), dt(0.2), dt(1e-3)
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
print("RESULT", json.dumps(res), flush=True)
