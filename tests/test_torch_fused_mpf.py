"""K13 and `FusedMPF`: the large-m dynamics posterior on the streamed
kernels (K11, K12, K13; their wrappers run the plain versions on CPU
tensors) against the JAX `FusedMPF(interpret=True)` and
`fused_mpf_stream_step(interpret=True)` (mirrors
tests/test_pallas_gmm.py:45-208), the guards, and a reduced particle
closed loop with `FusedMPF` held against JAX's step by step.

Tolerances are tests/test_pallas_gmm.py's: FusedMPF trajectories (with
SGD or Adam) rtol 1e-3, atol 1e-4 and their gradient norms rtol 1e-3
(atol 1e-4 with fuse_streams); the raw fused step x_new rtol 1e-4, atol
1e-5 and gp_new rtol/atol 1e-4; the closed loop
tests/test_equivalence_dual.py's per-step rtol 1e-3, atol 5e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dust_tpu.experiments import build_particle_stack as j_build
from dust_tpu.experiments import load_config
from dust_tpu.inference import GaussianLikelihood as JLik
from dust_tpu.inference.mpf import FusedMPF as JFusedMPF
from dust_tpu.models import PendulumModel as JPendulum
from dust_tpu.ops import pallas_mpf_stream as j_stream
from dust_tpu_torch.convert import (
    disco_state_from_numpy,
    mpf_state_from_numpy,
    particle_stack_from_numpy,
    svmpc_state_from_numpy,
)
from dust_tpu_torch.inference import MPF, FusedMPF
from dust_tpu_torch.inference import GaussianLikelihood as TLik
from dust_tpu_torch.inference import mpf as tmpf_module
from dust_tpu_torch.models import PendulumModel as TPendulum
from dust_tpu_torch.ops import mpf_stream
from dust_tpu_torch.ops.bandwidth import silvermans_rule

MPF_TOL = dict(rtol=1e-3, atol=1e-4)
EARLY_TOL = dict(rtol=1e-3, atol=5e-4)
OBS, ACTION, NEW_OBS = [2.8, -0.2], [0.8], [2.7, -0.5]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _liks():
    return (JLik(obs_std=0.1,
                 model=JPendulum(uncertain_params=("length", "mass"))),
            TLik(obs_std=0.1,
                 model=TPendulum(uncertain_params=("length", "mass"))))


def _init(m, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.6, 1.3, size=(m, 2)).astype(np.float32)


def _jax_optimize(mpf, init, n_steps=4):
    ms = mpf.init_state(init, np.asarray(OBS, np.float32), dim_a=1, bw=0.2)
    ms, g, _ = mpf.optimize(ms, jnp.array(ACTION), jnp.array(NEW_OBS),
                            bw=0.3, n_steps=n_steps)
    return np.asarray(ms.x), np.asarray(g)


def _port_optimize(mpf, init, n_steps=4):
    ms = mpf.init_state(_t(init), _t(OBS), dim_a=1, bw=0.2)
    ms, g, bw = mpf.optimize(ms, _t(ACTION), _t(NEW_OBS), bw=0.3,
                             n_steps=n_steps)
    assert bw == 0.3 and torch.equal(ms.prior.locs, ms.x)
    return ms.x.numpy(), g.numpy()


@pytest.mark.parametrize("packed", [False, True])
def test_fused_mpf_matches_jax_fused_mpf(packed):
    """Both layouts, at m = 64 (packed=True forces K11b/K12b below the
    auto threshold), against JAX's class and the port's plain MPF."""
    init = _init(64)
    jl, tl = _liks()
    j = _jax_optimize(JFusedMPF(likelihood=jl, optimizer=optax.sgd(1e-3),
                                interpret=True, packed=packed), init)
    t = _port_optimize(FusedMPF(tl, lr=1e-3, packed=packed), init)
    p = _port_optimize(MPF(tl, lr=1e-3), init)
    np.testing.assert_allclose(t[0], j[0], **MPF_TOL)
    np.testing.assert_allclose(t[1], j[1], rtol=1e-3)
    np.testing.assert_allclose(t[0], p[0], **MPF_TOL)
    np.testing.assert_allclose(t[1], p[1], rtol=1e-3)
    assert np.abs(t[0] - init).max() > 1e-4


@pytest.mark.parametrize("packed", [False, True])
def test_fused_mpf_adam_matches_jax_fused_mpf(packed):
    """Adam on the two-kernel path (gram K11a + K12a, or packed K11b +
    K12b forced at m = 64): the kernels give phi and `optax.adam(1e-2)`'s
    arithmetic is applied outside them, as in JAX's `FusedMPF` (its
    interpret mode). Two `optimize` calls of 4 steps, the moments carried
    from the first to the second; particles and the first moment at
    MPF_TOL, the gradient norms at rtol 1e-3, the count exactly; the
    port's plain MPF with Adam agrees as well."""
    init = _init(64, seed=4)
    jl, tl = _liks()
    jm = JFusedMPF(likelihood=jl, optimizer=optax.adam(1e-2),
                   interpret=True, packed=packed)
    tm = FusedMPF(tl, optimizer="adam", lr=1e-2, packed=packed)
    pm = MPF(tl, optimizer="adam", lr=1e-2)
    js = jm.init_state(init, np.asarray(OBS, np.float32), dim_a=1, bw=0.2)
    ts = tm.init_state(_t(init), _t(OBS), dim_a=1, bw=0.2)
    ps = pm.init_state(_t(init), _t(OBS), dim_a=1, bw=0.2)
    first = tm.phi(tm._condition(ts, _t(ACTION), _t(NEW_OBS)), 0.3)
    assert int((first.abs() < 1e-5).sum()) == 0
    for new_obs in (NEW_OBS, [2.6, -0.1]):
        js, jg, _ = jm.optimize(js, jnp.array(ACTION), jnp.array(new_obs),
                                bw=0.3, n_steps=4)
        ts, tg, _ = tm.optimize(ts, _t(ACTION), _t(new_obs), bw=0.3,
                                n_steps=4)
        ps, pg, _ = pm.optimize(ps, _t(ACTION), _t(new_obs), bw=0.3,
                                n_steps=4)
        for x, g in ((ts.x, tg), (ps.x, pg)):
            np.testing.assert_allclose(x.numpy(), np.asarray(js.x),
                                       **MPF_TOL)
            np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-3)
        np.testing.assert_allclose(ts.opt_state.mu.numpy(),
                                   np.asarray(js.opt_state[0].mu), **MPF_TOL)
    assert ts.opt_state.count == int(js.opt_state[0].count) == 8
    assert np.abs(ts.x.numpy() - init).max() > 1e-2


@pytest.mark.parametrize("m", [64, 333])
def test_fused_mpf_bf16_matches_jax(m):
    """use_bf16 on the packed entries: the port's bf16 rule (K12b's weights
    rounded per warp slice and tile, `gmm._bf16_weights`) against JAX's
    (per center block), over 4 SVGD steps. The particles are held at the
    FusedMPF tolerance; the gradients, which carry the prior score, at
    1.4e-2 times their largest value (JAX's bf16 prior-score error); and
    the rounding must move the particles by more than f32 noise."""
    init = _init(m, seed=2)
    jl, tl = _liks()
    j = _jax_optimize(JFusedMPF(likelihood=jl, optimizer=optax.sgd(1e-3),
                                interpret=True, packed=True, use_bf16=True),
                      init)
    t = _port_optimize(FusedMPF(tl, lr=1e-3, packed=True, use_bf16=True),
                       init)
    f32 = _port_optimize(FusedMPF(tl, lr=1e-3, packed=True), init)
    np.testing.assert_allclose(t[0], j[0], **MPF_TOL)
    np.testing.assert_allclose(t[1], j[1], atol=1.4e-2 * np.abs(j[1]).max())
    assert np.abs(t[0] - f32[0]).max() > 1e-5


def test_fuse_streams_matches_jax_and_plain_mpf():
    """fuse_streams (K12b for the first prior score, then one K13 per
    iteration) at m = 200, against JAX's fused path with small blocks (a
    multi-block grid, as tests/test_pallas_gmm.py:127-167) and the plain
    MPF."""
    init = _init(200, seed=1)
    jl, tl = _liks()
    orig = j_stream.fused_mpf_stream_step

    def small(*args, **kw):
        kw.update(block_i=128, block_j=128)
        return orig(*args, **kw)

    j_stream.fused_mpf_stream_step = small
    try:
        j = _jax_optimize(JFusedMPF(likelihood=jl, optimizer=optax.sgd(1e-3),
                                    interpret=True, fuse_streams=True,
                                    fused_lr=1e-3), init)
    finally:
        j_stream.fused_mpf_stream_step = orig
    t = _port_optimize(FusedMPF(tl, fuse_streams=True, fused_lr=1e-3), init)
    p = _port_optimize(MPF(tl, lr=1e-3), init)
    np.testing.assert_allclose(t[0], j[0], **MPF_TOL)
    np.testing.assert_allclose(t[1], j[1], **MPF_TOL)
    np.testing.assert_allclose(t[0], p[0], **MPF_TOL)
    np.testing.assert_allclose(t[1], p[1], **MPF_TOL)


@pytest.mark.parametrize("m,block_i,block_j", [
    (200, 128, 128),      # ragged padding + 2x2-block grid
    (512, 128, 256),      # multi-j online softmax in the gp stream
    (64, 128, 128),       # single-block degenerate grid
    (1, 128, 128),        # one particle
    (33, 128, 128),       # a row count on no tile or slice boundary
])
def test_stream_step_matches_jax_kernel(m, block_i, block_j):
    rng = np.random.default_rng(m)
    x = (rng.normal(size=(m, 2)) * 0.5).astype(np.float32)
    score = rng.normal(size=(m, 2)).astype(np.float32)
    centers = (rng.normal(size=(m, 2)) * 0.5).astype(np.float32)
    bw, pbw, lr = 0.4, 0.3, 0.05
    jx, jg = j_stream.fused_mpf_stream_step(
        x, score, centers, bw, pbw, lr, block_i=block_i, block_j=block_j,
        interpret=True)
    tx, tg = mpf_stream.fused_mpf_stream_step(
        _t(x), _t(score), _t(centers), bw, pbw, lr, block_i=block_i,
        block_j=block_j)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-4)


def test_auto_layout_choice(monkeypatch):
    """packed="auto" takes the packed entries iff m >= 4096 and d <= 8
    (`FusedMPF._use_packed`, JAX mpf.py:391-399); phi calls the chosen
    entries and no others."""
    _, tl = _liks()
    auto = FusedMPF(tl)
    assert not auto._use_packed(2048, 2) and auto._use_packed(4096, 2)
    assert not auto._use_packed(8192, 9)
    assert FusedMPF(tl, packed=True)._use_packed(64, 8)
    assert not FusedMPF(tl, packed=False)._use_packed(8192, 2)
    assert FusedMPF._blk_j(2048) == 2048 and FusedMPF._blk_j(32768) == 8192
    calls = []
    for name in ("gmm_prior_score_streamed",
                 "gmm_prior_score_streamed_packed", "svgd_phi_streamed",
                 "svgd_phi_streamed_packed"):
        fn = getattr(tmpf_module, name)
        monkeypatch.setattr(
            tmpf_module, name,
            lambda *a, _fn=fn, _name=name, **kw: (calls.append(_name),
                                                  _fn(*a, **kw))[1])
    for packed, want in ((False, ["gmm_prior_score_streamed",
                                  "svgd_phi_streamed"]),
                         (True, ["gmm_prior_score_streamed_packed",
                                 "svgd_phi_streamed_packed"])):
        calls.clear()
        _port_optimize(FusedMPF(tl, lr=1e-3, packed=packed), _init(32), 1)
        assert calls == want


def test_guards():
    _, tl = _liks()
    with pytest.raises(ValueError, match="fused_lr"):
        FusedMPF(tl, lr=1e-3, fuse_streams=True)
    with pytest.raises(ValueError, match="lr"):
        FusedMPF(tl, lr=1e-2, fuse_streams=True, fused_lr=1e-3)
    assert FusedMPF(tl, fuse_streams=True, fused_lr=2e-3).lr == 2e-3
    assert FusedMPF(tl, lr=2e-3, fuse_streams=True, fused_lr=2e-3).lr == 2e-3
    with pytest.raises(ValueError, match="reference_compat"):
        FusedMPF(tl, reference_compat=True)
    with pytest.raises(ValueError, match="packed"):
        FusedMPF(tl, packed="yes")
    z = torch.zeros(16, 2)
    with pytest.raises(ValueError, match="k == m"):
        mpf_stream.fused_mpf_stream_step(z, z, torch.zeros(8, 2), 1.0, 1.0,
                                         0.1)
    z9 = torch.zeros(16, 9)
    with pytest.raises(ValueError, match="d <= 8"):
        mpf_stream.fused_mpf_stream_step(z9, z9, z9, 1.0, 1.0, 0.1)


class _JDraws:
    def __init__(self, draws):
        self.draws, self.i = draws, 0

    def sample(self, key, shape):
        return jnp.asarray(self.draws[self.i])

    def log_prob(self, x):
        self.i += 1
        return jnp.zeros(x.shape[0])


class _TDraws(_JDraws):
    def sample(self, generator, shape):
        return _t(self.draws[self.i])

    def log_prob(self, x):
        self.i += 1
        return torch.zeros(x.shape[0])


@pytest.mark.parametrize("fuse_streams", [False, True])
def test_closed_loop_with_fused_mpf_matches_jax_step_by_step(fuse_streams):
    """The particle DuSt loop at reduced width (`svgd_step` with injected
    noise and mass draws, forward, the simulator with the mass change)
    with `FusedMPF` on the mass posterior on both sides, the port re-synced
    to the JAX state after every step (as
    tests/test_torch_particle_episode.py:384)."""
    cfg = load_config("demo/particle_config.yaml")
    cfg["exp_params"].update(horizon=10, action_samples=16,
                             params_samples=3, n_particles=3,
                             mpf_n_particles=12, mpf_steps=5)
    exp = cfg["exp_params"]
    lr = exp["mpf_learning_rate"]
    js = j_build(cfg, jax.random.key(0))
    arrays = {k: np.asarray(v) for k, v in {
        "init_policies": js.init_policies,
        "policies_prior.locs": js.policies_prior.locs,
        "policies_prior.scale_tril": js.policies_prior.scale_tril,
        "policies_prior.logits": js.policies_prior.logits,
        "mpf_init": js.mpf_init, "init_state": js.init_state}.items()}
    ts = particle_stack_from_numpy(arrays, cfg, device="cpu")
    kw = dict(fuse_streams=True, fused_lr=lr) if fuse_streams else {}
    jmpf = JFusedMPF(likelihood=js.mpf.likelihood, interpret=True,
                     optimizer=optax.sgd(lr), n_steps=exp["mpf_steps"], **kw)
    tmpf = FusedMPF(ts.mpf.likelihood, n_steps=exp["mpf_steps"],
                    **(kw or dict(lr=lr)))
    steps, change_at = 3, 1
    rng = np.random.default_rng(0)
    noise = rng.normal(size=(steps, 16, 3, 10, 2)).astype(np.float32)
    draws = np.log(rng.uniform(1.7, 2.4, (steps, 3, 1))).astype(np.float32)
    j_draws, t_draws = _JDraws(draws), _TDraws(draws)

    j_obs = js.init_state
    jsv = js.svmpc.init_state(js.init_policies, js.policies_prior)
    jd = js.controller.init_state()
    jms = jmpf.init_state(js.mpf_init, j_obs, 2, bw=js.mpf_init_bw)
    key = jax.random.key(1)  # unused: all noise injected
    rows = {k: [] for k in ("action", "obs", "mpf_x", "mpf_grads")}
    for t in range(steps):
        t_obs = _t(j_obs)
        tsv = svmpc_state_from_numpy(jsv.theta, jsv.prior.locs,
                                     jsv.prior.scale_tril, jsv.prior.logits,
                                     jsv.prior_updated, device="cpu")
        td = disco_state_from_numpy(jd.a_seq, jd.a_mat, jd.a_mix,
                                    device="cpu")
        tms = mpf_state_from_numpy(jms.x, jms.prior.locs,
                                   jms.prior.scale_tril, jms.prior.logits,
                                   jms.lik.loc, jms.lik.past_obs,
                                   jms.lik.past_action, jms.prior_bw,
                                   device="cpu")
        jbw = silvermans_rule(_t(jsv.theta))
        jsv, jd, jc = js.svmpc.svgd_step(jsv, jd, j_obs[None], j_draws, key,
                                         jnp.asarray(jbw.numpy()),
                                         noise=jnp.asarray(noise[t]))
        tsv, td, tc = ts.svmpc.svgd_step(tsv, td, t_obs[None], t_draws, None,
                                         silvermans_rule(tsv.theta),
                                         noise=_t(noise[t]))
        jsv, ja, _ = js.svmpc.forward(jsv, jc)
        tsv, ta, _ = ts.svmpc.forward(tsv, tc)
        mass = 2.0 + (ts.load if t >= change_at else 0.0)
        j_obs = js.model.step(j_obs[None], ja[0][None],
                              {"mass": jnp.float32(mass)})[0]
        t_obs = ts.model.step(t_obs[None], ta[0][None],
                              {"mass": torch.tensor(mass)})[0]
        jms, jg, _ = jmpf.optimize(jms, ja[0], j_obs, bw=js.mpf_bw)
        tms, tg, _ = tmpf.optimize(tms, ta[0], t_obs, bw=ts.mpf_bw)
        for name, a, b in (("action", ta[0], ja[0]), ("obs", t_obs, j_obs),
                           ("mpf_x", tms.x, jms.x),
                           ("mpf_grads", tg, jg)):
            rows[name].append((a.numpy(), np.asarray(b)))
    for name, pairs in rows.items():
        ours = np.stack([p[0] for p in pairs])
        theirs = np.stack([p[1] for p in pairs])
        np.testing.assert_allclose(ours, theirs, err_msg=name, **EARLY_TOL)
    assert np.abs(np.stack([p[1] for p in rows["action"]])).max() > 0.5
    moved = np.stack([p[1] for p in rows["mpf_x"]])
    assert np.abs(moved[-1] - arrays["mpf_init"]).max() > 1e-4
