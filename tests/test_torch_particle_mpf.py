"""K7 and `FusedParticleMPF`: the port's particle-mass MPF loop (whose
wrapper runs the kernel's plain version on CPU tensors) against the JAX
`fused_particle_mpf_optimize(interpret=True)`, and the port's
`FusedParticleMPF` against the JAX `FusedParticleMPF` and against the
port's own autograd `MPF` (mirrors tests/test_pallas_particle_mpf.py):
the acceleration and speed clip gates, the crash factor at the
prediction start, the padded particle counts, obstacle-free models.

Tolerances: the loop against the JAX kernel at K2's (rtol 1e-4, atol
1e-5); the fused classes against the autograd MPF at that file's (rtol
2e-3, atol 2e-4)."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dust_tpu.inference import GaussianLikelihood as JLik
from dust_tpu.inference.mpf import FusedParticleMPF as JFused
from dust_tpu.models import Particle as JParticle
from dust_tpu.ops.pallas_particle_mpf import (
    fused_particle_mpf_optimize as j_mpf,
)
from dust_tpu_torch.inference import MPF, FusedParticleMPF
from dust_tpu_torch.inference import GaussianLikelihood as TLik
from dust_tpu_torch.models import Particle as TParticle
from dust_tpu_torch.ops import particle_mpf as tpm

ENV = dict(
    dt=0.015, control_type="acceleration", can_crash=True,
    with_obstacle=True, deterministic=True, obst_preset="grid_4x4",
    obst_width=2.1, max_speed=5.0, max_accel=10.0, map_cell_size=0.1,
    map_size=[22, 22], map_type="direct",
)
K2_TOL = dict(rtol=1e-4, atol=1e-5)
MPF_TOL = dict(rtol=2e-3, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _setup(rng, log_space=True, m=50, with_obstacle=True):
    env = dict(ENV)
    if not with_obstacle:
        env.update(can_crash=False, with_obstacle=False)
        for k in ("obst_preset", "obst_width", "map_cell_size", "map_size",
                  "map_type"):
            env.pop(k)
    jm = JParticle(uncertain_params=["mass"], mass=2.0, **env)
    tm = TParticle(uncertain_params=["mass"], mass=2.0, device="cpu", **env)
    init = rng.uniform(1.6, 2.4, size=(m, 1)).astype(np.float32)
    if log_space:
        init = np.log(init)
    return jm, tm, init


@pytest.mark.parametrize("log_space", [True, False])
@pytest.mark.parametrize("action,v0,scale", [
    ((3.0, -5.0), (0.4, -0.2), 0.015),
    ((25.0, -2.0), (0.4, -0.2), 0.015),    # the acceleration clip
    ((9.0, -9.0), (4.96, -4.96), 0.015),   # the speed clip
    ((3.0, -5.0), (0.4, -0.2), 0.0),       # a crashed start
])
def test_loop_matches_jax_kernel_at_demo_width(rng, log_space, action, v0,
                                               scale):
    _, _, init = _setup(rng, log_space)
    centers = init + 0.02 * rng.normal(size=init.shape).astype(np.float32)
    past = np.array([-9.0, -9.0, *v0], np.float32)
    loc = past + np.array([0.01, -0.01, 0.1, -0.15], np.float32)
    args = (init, centers, past, loc, np.array(action, np.float32))
    kw = dict(bw=0.5, prior_bw=0.5, lr=1e-2, obs_sigma=0.1, n_steps=20,
              max_acc=10.0, max_speed=5.0, log_space=log_space)
    want = np.asarray(j_mpf(*(jnp.asarray(a) for a in args), scale,
                            interpret=True, **kw))
    before = tpm.fused_particle_mpf_optimize.launches
    got = tpm.fused_particle_mpf_optimize(*(_t(a) for a in args), scale,
                                          **kw)
    assert tpm.fused_particle_mpf_optimize.launches == before  # plain: CPU
    np.testing.assert_allclose(got.numpy(), want, **K2_TOL)
    assert np.abs(want - init).max() > 1e-4           # the particles moved


def _run(mpf, init, obs, action, new_obs, conv, n_steps, prior_bw=0.2):
    ms = mpf.init_state(init, conv(obs), 2, bw=prior_bw)
    ms, _, _ = mpf.optimize(ms, conv(action), conv(new_obs), bw=0.3,
                            n_steps=n_steps)
    return ms


@pytest.mark.parametrize("log_space", [False, True])
@pytest.mark.parametrize("action", [(3.0, -5.0), (25.0, -2.0), (9.0, 30.0)])
def test_fused_particle_mpf_matches_jax_and_autograd(rng, log_space, action):
    jm, tm, init = _setup(rng, log_space)
    obs = np.array([-9.0, -9.0, 0.4, -0.2], np.float32)
    new_obs = np.array([-8.9, -9.1, 0.5, -0.4], np.float32)
    a = np.array(action, np.float32)
    jlik = JLik(obs_std=0.1, model=jm, log_space=log_space)
    tlik = TLik(obs_std=0.1, model=tm, log_space=log_space)
    jf = _run(JFused(likelihood=jlik, lr=1e-2, interpret=True), init, obs,
              a, new_obs, jnp.asarray, 6)
    tf = _run(FusedParticleMPF(tlik, lr=1e-2), init, obs, a, new_obs, _t, 6)
    tp = _run(MPF(tlik, lr=1e-2), init, obs, a, new_obs, _t, 6)
    np.testing.assert_allclose(tf.x.numpy(), np.asarray(jf.x), **K2_TOL)
    np.testing.assert_allclose(tf.x.numpy(), tp.x.numpy(), **MPF_TOL)
    # the prior is refreshed around the new particles after the loop
    np.testing.assert_array_equal(tf.prior.locs.numpy(), tf.x.numpy())
    np.testing.assert_allclose(tf.prior_bw.numpy(), 0.3, rtol=1e-7)


@pytest.mark.parametrize("case", ["speed clip m13", "crashed start",
                                  "no obstacles"])
def test_fused_particle_mpf_edge_cases(rng, case):
    """Start velocity at the +-5 limit with m = 13 (not a multiple of 8);
    a prediction start inside an obstacle cell (frozen: zero likelihood
    gradient); an obstacle-free model (the full dt scale)."""
    jm, tm, init = _setup(rng, log_space=case != "no obstacles",
                          m=13 if case == "speed clip m13" else 50,
                          with_obstacle=case != "no obstacles")
    a = np.array([9.0, -9.0], np.float32)
    if case == "speed clip m13":
        obs = np.array([0.0, 0.0, 4.96, -4.96], np.float32)
        new_obs = np.array([0.07, -0.07, 5.0, -5.0], np.float32)
    elif case == "crashed start":
        xi, yi = np.argwhere(tm.obst_map.map > 0)[0]
        pos = (np.array([xi, yi]) + 0.5 - tm.obst_map.c_offset) * 0.1
        obs = np.array([pos[0], pos[1], 0.4, -0.2], np.float32)
        assert float(tm.obst_map.get_collisions(_t(obs[:2]))) == 1.0
        new_obs = obs.copy()
    else:
        obs = np.array([-9.0, -9.0, 0.4, -0.2], np.float32)
        new_obs = np.array([-8.9, -9.1, 0.5, -0.4], np.float32)
    jlik = JLik(obs_std=0.1, model=jm, log_space=case != "no obstacles")
    tlik = TLik(obs_std=0.1, model=tm, log_space=case != "no obstacles")
    jf = _run(JFused(likelihood=jlik, lr=1e-2, interpret=True), init, obs,
              a, new_obs, jnp.asarray, 4)
    tf = _run(FusedParticleMPF(tlik, lr=1e-2), init, obs, a, new_obs, _t, 4)
    tp = _run(MPF(tlik, lr=1e-2), init, obs, a, new_obs, _t, 4)
    np.testing.assert_allclose(tf.x.numpy(), np.asarray(jf.x), **K2_TOL)
    np.testing.assert_allclose(tf.x.numpy(), tp.x.numpy(), **MPF_TOL)


def test_conditioned_past_action_and_guards(rng):
    """Re-optimizing with new_obs=None uses the conditioned past action,
    not the argument; velocity control and a compat-mode MPF are
    refused."""
    _, tm, init = _setup(rng)
    lik = TLik(obs_std=0.1, model=tm, log_space=True)
    f = FusedParticleMPF.from_mpf(MPF(lik, lr=1e-2, n_steps=3))
    assert (f.lr, f.n_steps) == (1e-2, 3)
    ms = _run(f, init, np.array([-9, -9, 0.4, -0.2]), np.array([3.0, -5.0]),
              np.array([-8.9, -9.1, 0.5, -0.4]), _t, 3)
    a, _, _ = f.optimize(ms, _t([99.0, 99.0]), None, bw=0.3)
    b, _, _ = f.optimize(ms, None, None, bw=0.3)
    np.testing.assert_array_equal(a.x.numpy(), b.x.numpy())
    vel = TParticle(uncertain_params=["mass"], mass=2.0, dt=0.015, device="cpu",
                    control_type="velocity", deterministic=True,
                    max_speed=5.0)
    with pytest.raises(ValueError, match="acceleration"):
        FusedParticleMPF(TLik(obs_std=0.1, model=vel), lr=1e-2)
    with pytest.raises(ValueError, match="reference_compat"):
        FusedParticleMPF.from_mpf(MPF(lik, reference_compat=True))


@pytest.mark.parametrize("m,lanes", [(1, 4), (13, 4), (50, 4), (64, 8),
                                     (37, 8)])
def test_lane_sum_is_the_kernels_order(m, lanes):
    """`lane_sum` against a lane group's order written out in float32
    scalars: lane l adds j = l, l + lanes, ... in turn from 0, then
    neighbouring lanes' sums meet pairwise ((p0 + p1) + (p2 + p3) for a
    quad, the MPF loops' ROW_LANES in K7 and K9/K10; 8 lanes for the
    episode's DISCO delta); bit for bit, over a batch."""
    rng = np.random.default_rng(m)
    terms = (rng.normal(size=(3, m)) * 10.0 ** rng.integers(-3, 4, (3, m))
             ).astype(np.float32)
    got = tpm.lane_sum(_t(terms), lanes).numpy()[:, 0]
    for row, want_row in zip(terms, got):
        acc = []
        for lane in range(lanes):
            a = np.float32(0.0)
            for j in range(lane, m, lanes):
                a = np.float32(a + row[j])
            acc.append(a)
        while len(acc) > 1:
            acc = [np.float32(x + y) for x, y in zip(acc[0::2], acc[1::2])]
        assert want_row == acc[0]
    assert (tpm.ROW_LANES, tpm.REGISTER_MAX) == (4, 64)


def _jax_and_plain_inputs(rng, m, log_space):
    _, _, init = _setup(rng, log_space, m=m)
    centers = init + 0.02 * rng.normal(size=init.shape).astype(np.float32)
    past = np.array([-9.0, -9.0, 0.4, -0.2], np.float32)
    loc = past + np.array([0.01, -0.01, 0.1, -0.15], np.float32)
    return init, (init, centers, past, loc, np.array((3.0, -5.0),
                                                     np.float32))


@pytest.mark.parametrize("log_space", [True, False])
@pytest.mark.parametrize("m", [50, 64, 37, 200])
def test_plain_loop_matches_jax_at_the_kernels_widths(m, log_space):
    """The plain loop (sums in K7's quad order) against JAX's kernel in
    interpret mode at K7's widths: the demo's m = 50 and the register
    path's edge m = REGISTER_MAX (each lane's 16 centers in registers), a
    width on no lane boundary, and m = 200 on the general path; inputs
    made by numpy from a seed."""
    rng = np.random.default_rng(1000 + m)
    init, args = _jax_and_plain_inputs(rng, m, log_space)
    kw = dict(n_steps=20, max_acc=10.0, max_speed=5.0, log_space=log_space)
    sc = dict(bw=0.5, prior_bw=0.5, lr=1e-2, obs_sigma=0.1)
    want = np.asarray(j_mpf(*(jnp.asarray(a) for a in args), 0.015,
                            interpret=True, **sc, **kw))
    x, centers, past, loc, action = (_t(a) for a in args)
    scal = tpm.mpf_scalars(x, past, loc, action, 0.015, sc["bw"],
                           sc["prior_bw"], sc["lr"], sc["obs_sigma"])
    got = tpm.particle_mpf_optimize_plain(x, centers, scal, **kw)
    np.testing.assert_allclose(got.numpy(), want, **K2_TOL)
    assert np.abs(want - init).max() > 1e-4           # the particles moved


@pytest.mark.parametrize("numbers", [False, True])
def test_scalar_sources_read_the_callers_storage(rng, numbers):
    """The scalars reach K7 without a launch: each float32 tensor on x's
    device by the address of its element in the caller's own storage,
    each Python number by its value; read back, they are `mpf_scalars`'
    values bit for bit. (On the CPU x's device is the CPU, so the tensors
    here are read through their addresses.)"""
    x = _t(rng.uniform(0.5, 0.9, size=(5, 1)))
    past = _t([-9.0, -9.0, 0.4, -0.2])
    loc = _t([-8.9, -9.1, 0.5, -0.4])
    action = _t([3.0, -5.0])
    scale = _t(0.015)
    sc = (0.3, 0.2, 1e-2, 0.1) if numbers else tuple(
        _t(v) for v in (0.3, 0.2, 1e-2, 0.1))
    ptrs, vals, keep = tpm.scalar_sources(x, past, loc, action, scale, *sc)
    assert keep == []                                 # nothing was copied
    got = np.array([ctypes.c_float.from_address(p).value if p else v
                    for p, v in zip(ptrs, vals)], np.float32)
    want = tpm.mpf_scalars(x, past, loc, action, scale, *sc).numpy()
    np.testing.assert_array_equal(got, want)
    owners = [(v, 0) for v in sc] + [(past, 2), (past, 3), (action, 0),
                                     (action, 1), (loc, 2), (loc, 3),
                                     (scale, 0)]
    for ptr, val, (owner, elem) in zip(ptrs, vals, owners):
        if torch.is_tensor(owner):
            assert ptr == owner.data_ptr() + 4 * elem
        else:
            assert ptr == 0 and val == owner
    # a float64 tensor is converted once and kept until the launch
    ptrs, _, keep = tpm.scalar_sources(x, past.double(), loc, action, scale,
                                       *sc)
    assert len(keep) == 1 and ptrs[4] == keep[0].data_ptr() + 8


def test_plain_loop_in_quad_order_matches_jax_at_odd_width(rng):
    """The plain loop (sums in the quad order) against JAX's kernel at a
    particle count on no quad boundary (m = 37), log space."""
    _, _, init = _setup(rng, True, m=37)
    centers = init + 0.02 * rng.normal(size=init.shape).astype(np.float32)
    past = np.array([-9.0, -9.0, 0.4, -0.2], np.float32)
    loc = past + np.array([0.01, -0.01, 0.1, -0.15], np.float32)
    args = (init, centers, past, loc, np.array((3.0, -5.0), np.float32))
    kw = dict(bw=0.5, prior_bw=0.5, lr=1e-2, obs_sigma=0.1, n_steps=20,
              max_acc=10.0, max_speed=5.0, log_space=True)
    want = np.asarray(j_mpf(*(jnp.asarray(a) for a in args), 0.015,
                            interpret=True, **kw))
    got = tpm.fused_particle_mpf_optimize(*(_t(a) for a in args), 0.015,
                                          **kw)
    np.testing.assert_allclose(got.numpy(), want, **K2_TOL)
