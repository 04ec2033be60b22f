"""Numerical building blocks: pairwise distances, bandwidth heuristics, RBF
kernel Gram/gradient evaluations, and the hand-written CUDA kernels of the
pendulum path (`rollout.py`, `mpf.py`; sources in `../csrc/`)."""
