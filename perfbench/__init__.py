"""The benchmark of the PyTorch and CUDA port (`dust_tpu_torch`): a
data-driven harness (`run.py`) over the configurations, traffic mixes,
runners, end-to-end and per-layer metric readers, correctness limits and
plain references in the folders beside it, named in `BENCHMARK.json`."""
