"""Numerical building blocks: pairwise distances, bandwidth heuristics, RBF
kernel Gram/gradient evaluations, and the wrappers of the hand-written
CUDA kernels (sources in `../csrc/`): pendulum `rollout.py` (K1),
`mpf.py` (K2), `solve.py` (K3, and the particle K8), `episode.py` (K4),
`sweep_episode.py` (K5); particle `particle_rollout.py` (K6),
`particle_mpf.py` (K7), `particle_episode.py` (K9)."""
