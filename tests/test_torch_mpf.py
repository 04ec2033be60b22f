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


def _explicit_lane_sum(t, lanes):
    """The sum over t's last axis as a group of `lanes` kernel lanes takes
    it, written out in float32: lane l adds j = l, l + lanes, ... in turn
    from 0, then neighbouring lanes meet pairwise, (p0 + p1) + (p2 + p3)
    for a quad, ((p0 + p1) + (p2 + p3)) + ((p4 + p5) + (p6 + p7)) for 8.
    Keeps the axis."""
    a = t.numpy().astype(np.float32)
    acc = [np.zeros(a.shape[:-1], np.float32) for _ in range(lanes)]
    for j in range(a.shape[-1]):
        acc[j % lanes] = (acc[j % lanes] + a[..., j]).astype(np.float32)
    while len(acc) > 1:
        acc = [(x + y).astype(np.float32)
               for x, y in zip(acc[0::2], acc[1::2])]
    return torch.from_numpy(acc[0])[..., None]


def _plain_sum(t, lanes):
    return t.sum(dim=-1, keepdim=True)


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


@pytest.mark.parametrize("lanes", [4, 8])
@pytest.mark.parametrize("log_space", [False, True])
def test_plain_k2_sums_in_the_kernels_quad_order(monkeypatch, log_space,
                                                 lanes):
    """The plain MPF loop takes its six sums over j (the prior weights and
    weighted centers, the kernel row sums and drives) in the kernel's
    order, a group of lanes per row: a quad in the episode kernels
    (csrc/pendulum_mpf.cuh:kRowLanes), 8 lanes in K2 (csrc/pendulum_mpf.cu):
    with `lane_sum` replaced by that order written out, 20 steps at m = 50
    give the same bits; with a plain sum they do not."""
    rng = np.random.default_rng(7)
    x = _init(log_space, seed=7)
    locs = x + rng.normal(scale=0.02, size=x.shape).astype(np.float32)
    scal = tmpf._scalars(_t(x), _t([2.9, 0.4]), _t([2.95, 0.9]), _t([1.3]),
                         0.05, 0.04, 1e-3, 0.1)

    def run():
        return tmpf.pendulum_mpf_optimize_plain(
            _t(x), _t(locs), scal, n_steps=20, log_space=log_space,
            lanes=lanes)

    want = run()
    assert (tmpf.EPISODE_ROW_LANES, tmpf.ROW_LANES) == (4, 8)
    monkeypatch.setattr(tmpf, "lane_sum", _explicit_lane_sum)
    assert torch.equal(run(), want)
    monkeypatch.setattr(tmpf, "lane_sum", _plain_sum)
    assert not torch.equal(run(), want)


@pytest.mark.parametrize("lanes", [4, 8])
@pytest.mark.parametrize("m", [37, 64])
def test_plain_k2_lane_counts_match_jax(m, lanes):
    """The plain MPF loop at the lane counts of the kernels (a quad in the
    episode kernels, 8 in K2), in log space, at a width on no lane
    boundary (m = 37) and at K2's register ceiling (m = REGISTER_MAX),
    against JAX's K2 in interpret mode; the lane count changes only the
    order of the sums."""
    assert tmpf.REGISTER_MAX == 64
    rng = np.random.default_rng(m + lanes)
    x = np.log(rng.uniform(0.6, 1.3, size=(m, 2))).astype(np.float32)
    locs = x + rng.normal(scale=0.02, size=x.shape).astype(np.float32)
    obs = dict(past_obs=np.array([2.9, 0.4], np.float32),
               loc=np.array([2.95, 0.9], np.float32),
               action=np.array([-2.6], np.float32))
    j = j_mpf_optimize(jnp.asarray(x), jnp.asarray(locs),
                       *(jnp.asarray(v) for v in obs.values()), 0.05, 0.04,
                       1e-3, 0.1, n_steps=20, dt=0.05, g=9.8, log_space=True,
                       interpret=True)
    scal = tmpf._scalars(_t(x), *(_t(v) for v in obs.values()), 0.05, 0.04,
                         1e-3, 0.1)
    t = tmpf.pendulum_mpf_optimize_plain(_t(x), _t(locs), scal, n_steps=20,
                                         log_space=True, lanes=lanes)
    assert np.abs(t.numpy() - x).max() > 1e-3      # the particles moved
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                               atol=ATOL)


def test_plain_k2_needs_its_lane_count():
    """The plain MPF loop reproduces one kernel's sum order, so every
    caller names it: K2's ROW_LANES or the episode kernels'
    EPISODE_ROW_LANES; without it the call raises."""
    x = _t(_init(False))
    scal = tmpf._scalars(x, _t([2.9, 0.4]), _t([2.95, 0.9]), _t([1.3]),
                         0.05, 0.04, 1e-3, 0.1)
    with pytest.raises(TypeError, match="lanes"):
        tmpf.pendulum_mpf_optimize_plain(x, x, scal, n_steps=2)
    assert tmpf.pendulum_mpf_optimize_plain(
        x, x, scal, lanes=tmpf.ROW_LANES, n_steps=2).shape == x.shape


def test_episode_register_range_is_the_kernels():
    """The Python rule's range (`EPISODE_REGISTER_MIN`..`MAX`) is the
    episode kernels' (csrc/pendulum_mpf.cuh: kRowLanes lanes a row, each
    holding kEpisodeRegCols columns or one fewer), read from the source
    text, and one row per quad of the kernels' 256 threads reaches it."""
    import re
    from pathlib import Path

    src = (Path(tmpf.__file__).resolve().parents[1] / "csrc"
           / "pendulum_mpf.cuh").read_text()
    cols = re.findall(r"constexpr int kEpisodeRegCols = (\d+);", src)
    lanes = re.findall(r"constexpr int kRowLanes = (\d+);", src)
    assert cols == [str(tmpf.EPISODE_REGISTER_COLS)]
    assert lanes == [str(tmpf.EPISODE_ROW_LANES)]
    assert (tmpf.EPISODE_REGISTER_MIN, tmpf.EPISODE_REGISTER_MAX) == (49, 52)
    assert tmpf.EPISODE_REGISTER_MAX * tmpf.EPISODE_ROW_LANES <= 256


@pytest.mark.parametrize("m_mpf,register", [
    (49, True), (50, True), (52, True),
    (1, False), (48, False), (53, False), (64, False), (65, False),
    (256, False)])
def test_episode_mpf_path_rule(m_mpf, register):
    """The episode kernels' MPF update takes the register loop where each
    lane's 13 columns are full or all but one (49-52, the demos' 50) and
    the shared-memory walk at every other size; `run_episodes` counts each
    launch by this rule."""
    assert tmpf.episode_register_loop(m_mpf) is register


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
    """An unknown optimizer name raises (SGD, Adam and optimizer objects
    are taken: test_mpf_adam_matches_jax)."""
    _, tl = _liks(False)
    with pytest.raises(ValueError, match="optimizer must be one of"):
        TMPF(likelihood=tl, optimizer="rmsprop")


@pytest.mark.parametrize("closed_form", [False, True])
@pytest.mark.parametrize("log_space", [False, True])
def test_mpf_adam_matches_jax(log_space, closed_form):
    """`MPF(optimizer="adam")` (and `ClosedFormPendulumMPF`) against JAX's
    with `optax.adam(1e-2)` over three `optimize` calls of 5 steps, each
    conditioned on a new observation, Adam's moments carried from call to
    call as JAX carries `opt_state` across MPC steps. Particles and the
    first moment at RTOL/ATOL, the count exactly; the first phi has no
    element below 1e-5 in magnitude (counted: Adam's first step is
    lr * g / (|g| + eps), which turns an ulp of a tiny g into up to 2
    lr)."""
    from dust_tpu.inference.mpf import ClosedFormPendulumMPF as JClosed
    from dust_tpu_torch.inference import ClosedFormPendulumMPF as TClosed

    jl, tl = _liks(log_space)
    jcls, tcls = (JClosed, TClosed) if closed_form else (JMPF, TMPF)
    jm = jcls(likelihood=jl, optimizer=optax.adam(1e-2))
    tm = tcls(likelihood=tl, optimizer="adam", lr=1e-2)
    init = _init(log_space, seed=3)
    obs = np.array([2.8, -0.3], np.float32)
    js = jm.init_state(init, obs, dim_a=1, bw=0.2)
    ts = tm.init_state(_t(init), _t(obs), dim_a=1, bw=0.2)
    steps = [([0.9], [2.7, -0.6]), ([2.5], [2.6, -0.1]), ([-1.4], [2.7, 0.4])]
    first = tm.phi(tm._condition(ts, _t(steps[0][0]), _t(steps[0][1])), 0.3)
    small = int((first.abs() < 1e-5).sum())
    assert small == 0, f"{small} elements of the first phi below 1e-5"
    for call, (action, new_obs) in enumerate(steps):
        js, jg, _ = jm.optimize(js, jnp.array(action), jnp.array(new_obs),
                                bw=0.3, n_steps=5)
        ts, tg, _ = tm.optimize(ts, _t(action), _t(new_obs), bw=0.3,
                                n_steps=5)
        np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=RTOL)
        jadam = js.opt_state[0]
        assert ts.opt_state.count == int(jadam.count) == 5 * (call + 1)
        np.testing.assert_allclose(ts.opt_state.mu.numpy(),
                                   np.asarray(jadam.mu), rtol=RTOL,
                                   atol=ATOL)
    assert np.abs(ts.x.numpy() - init).max() > 1e-2   # the particles moved
