"""K2 and the MPF: the port's autograd `MPF` and its `FusedPendulumMPF`
(whose wrapper runs the kernel's plain version on CPU tensors) against
the JAX `MPF` and `FusedPendulumMPF(interpret=True)`, mirroring
tests/test_pallas_mpf.py: torque clipping, log-space parameters and the
speed-clip gate.

Tolerance: rtol 2e-3, atol 2e-4 (the likelihood gradient with sigma = 0.1
is O(100), so float32 gradient noise reaches the particles through
lr * phi; the JAX package's own K2 tolerance)."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dust_tpu.inference import GaussianLikelihood as JLik
from dust_tpu.inference import MPF as JMPF
from dust_tpu.inference.mpf import FusedPendulumMPF as JFusedMPF
from dust_tpu.models import PendulumModel as JPendulum
from dust_tpu.ops.pallas_mpf import (
    fused_pendulum_mpf_optimize as j_mpf_optimize,
)
from dust_tpu_torch.inference import MPF as TMPF
from dust_tpu_torch.inference import FusedPendulumMPF as TFusedMPF
from dust_tpu_torch.inference import GaussianLikelihood as TLik
from dust_tpu_torch.models import PendulumModel as TPendulum
from dust_tpu_torch.ops import mpf as tmpf

RTOL, ATOL = 2e-3, 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _liks(log_space):
    j = JLik(obs_std=0.1, model=JPendulum(uncertain_params=("length", "mass")),
             log_space=log_space)
    t = TLik(obs_std=0.1, model=TPendulum(uncertain_params=("length", "mass")),
             log_space=log_space)
    return j, t


def _init(log_space, m=50, seed=0):
    rng = np.random.default_rng(seed)
    init = rng.uniform(0.6, 1.3, size=(m, 2)).astype(np.float32)
    return np.log(init) if log_space else init


def _run_all(log_space, action, obs, new_obs, n_steps, prior_bw=0.2,
             bw=0.3, lr=1e-3):
    init = _init(log_space)
    jl, tl = _liks(log_space)
    solvers = {
        "jax_plain": JMPF(likelihood=jl, optimizer=optax.sgd(lr)),
        "jax_fused": JFusedMPF(likelihood=jl, lr=lr, interpret=True),
        "torch_plain": TMPF(likelihood=tl, lr=lr),
        "torch_fused": TFusedMPF(likelihood=tl, lr=lr),
    }
    out = {}
    for name, s in solvers.items():
        if name.startswith("jax"):
            ms = s.init_state(init, obs, dim_a=1, bw=prior_bw)
            ms, _, _ = s.optimize(ms, jnp.array([action]),
                                  jnp.asarray(new_obs), bw=bw,
                                  n_steps=n_steps)
            out[name] = (np.asarray(ms.x), np.asarray(ms.prior.locs))
        else:
            ms = s.init_state(_t(init), _t(obs), dim_a=1, bw=prior_bw)
            ms, _, _ = s.optimize(ms, _t([action]), _t(new_obs), bw=bw,
                                  n_steps=n_steps)
            out[name] = (ms.x.numpy(), ms.prior.locs.numpy())
    return out


@pytest.mark.parametrize("log_space", [False, True])
@pytest.mark.parametrize("action", [0.9, 2.5, -1.4])
def test_mpf_and_plain_k2_match_jax(log_space, action):
    """Full optimize-loop parity, including torque clipping (|a| > 2) and
    log-space parameters: every path against the JAX autograd MPF, and
    the port's K2 against the JAX K2."""
    out = _run_all(log_space, action, np.array([2.8, -0.3], np.float32),
                   np.array([2.7, -0.6], np.float32), n_steps=6)
    ref_x, ref_locs = out["jax_plain"]
    for name in ("jax_fused", "torch_plain", "torch_fused"):
        np.testing.assert_allclose(out[name][0], ref_x, rtol=RTOL,
                                   atol=ATOL, err_msg=name)
        # the refreshed priors agree too
        np.testing.assert_allclose(out[name][1], ref_locs, rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    np.testing.assert_allclose(out["torch_fused"][0], out["jax_fused"][0],
                               rtol=RTOL, atol=ATOL)


def test_speed_clip_gate():
    """A state near the +8 speed limit: gradients through clipped rows
    vanish in the hand-derived K2 gradient exactly as in autograd."""
    out = _run_all(False, 2.0, np.array([0.5, 7.9], np.float32),
                   np.array([0.6, 8.0], np.float32), n_steps=4)
    ref_x = out["jax_plain"][0]
    for name in ("jax_fused", "torch_plain", "torch_fused"):
        np.testing.assert_allclose(out[name][0], ref_x, rtol=RTOL,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("log_space", [False, True])
def test_plain_k2_at_main_path_shapes(log_space):
    """The kernel function itself at m = 50, 20 steps."""
    rng = np.random.default_rng(5)
    x = _init(log_space, seed=5)
    locs = x + rng.normal(scale=0.02, size=x.shape).astype(np.float32)
    args = dict(past_obs=np.array([2.9, 0.4], np.float32),
                loc=np.array([2.95, 0.9], np.float32),
                action=np.array([1.3], np.float32))
    j = j_mpf_optimize(jnp.asarray(x), jnp.asarray(locs),
                       jnp.asarray(args["past_obs"]), jnp.asarray(args["loc"]),
                       jnp.asarray(args["action"]), 0.05, 0.04, 1e-3, 0.1,
                       n_steps=20, dt=0.05, g=9.8, log_space=log_space,
                       interpret=True)
    before = tmpf.fused_pendulum_mpf_optimize.launches
    t = tmpf.fused_pendulum_mpf_optimize(
        _t(x), _t(locs), _t(args["past_obs"]), _t(args["loc"]),
        _t(args["action"]), torch.tensor(0.05), torch.tensor(0.04), 1e-3,
        0.1, n_steps=20, dt=0.05, g=9.8, log_space=log_space)
    assert tmpf.fused_pendulum_mpf_optimize.launches == before
    assert np.abs(t.numpy() - x).max() > 1e-3      # the particles moved
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                               atol=ATOL)


def test_init_state_vector_bandwidth():
    """Default init: statsmodels Silverman, a per-dim vector; the prior is
    diagonal per dim and prior_bw is its mean (what K2 reads)."""
    x = np.stack([np.linspace(0.6, 0.61, 50), np.linspace(0.6, 1.3, 50)],
                 1).astype(np.float32)
    jl, tl = _liks(False)
    js = JMPF(likelihood=jl).init_state(x, np.zeros(2, np.float32), dim_a=1)
    ts = TMPF(likelihood=tl).init_state(_t(x), _t(np.zeros(2)), dim_a=1)
    np.testing.assert_allclose(ts.prior.scale_tril.numpy(),
                               np.asarray(js.prior.scale_tril), rtol=1e-5)
    assert ts.prior.scale_tril[0, 0] != ts.prior.scale_tril[1, 1]
    np.testing.assert_allclose(ts.prior_bw.numpy(), np.asarray(js.prior_bw),
                               rtol=1e-5)


def test_fused_reads_the_conditioned_past_action():
    """With new_obs=None the fused optimize uses the state's past_action,
    not the raw argument, as the autograd MPF does."""
    _, tl = _liks(False)
    init = _t(_init(False))
    plain = TMPF(likelihood=tl, lr=1e-3)
    fused = TFusedMPF(likelihood=tl, lr=1e-3)
    ms = plain.init_state(init, _t([2.8, -0.3]), dim_a=1, bw=0.2)
    ms, _, _ = plain.optimize(ms, _t([1.1]), _t([2.7, -0.6]), bw=0.3,
                              n_steps=0)
    xp, _, _ = plain.optimize(ms, _t([-5.0]), None, bw=0.3, n_steps=3)
    xf, norms, _ = fused.optimize(ms, _t([-5.0]), None, bw=0.3, n_steps=3)
    np.testing.assert_allclose(xf.x.numpy(), xp.x.numpy(), rtol=RTOL,
                               atol=ATOL)
    assert norms.shape == (3,)


def test_mpf_rejects_other_optimizers():
    _, tl = _liks(False)
    with pytest.raises(ValueError, match="SGD"):
        TMPF(likelihood=tl, optimizer="adam")
