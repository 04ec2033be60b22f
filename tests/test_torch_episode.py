"""K4 and its helpers: the port's whole-episode function (whose wrapper
runs the kernel's plain version on CPU tensors) in host-noise mode against
the JAX `fused_pendulum_episode(interpret=True)` and against the port's
own K3 + K2 composition (mirrors tests/test_pallas_episode.py), the exact
Silverman helper against `silvermans_rule`, and the counter-based noise of
the device-RNG mode.

Tolerances are tests/test_pallas_episode.py's (:137-157): over 3 steps
th 1e-5, om 1e-4, action 1e-4, cost 1e-3, bw_sv and bw_mpf 1e-6, theta
1e-3, a_mat 5e-3, mpf_x 1e-5 (the chaotic rollout amplifies ulp-level
particle drift); after one step theta, a_mat and the action at 1e-6. The
noise comes from numpy seed 1."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dust_tpu.ops.pallas_episode import fused_pendulum_episode as j_episode
from dust_tpu_torch.ops import episode as tep
from dust_tpu_torch.ops.bandwidth import silvermans_rule
from dust_tpu_torch.ops.mpf import fused_pendulum_mpf_optimize
from dust_tpu_torch.ops.solve import fused_pendulum_solve

HZ, M, NP, NA, MM = 30, 3, 8, 128, 50
SIG, LR, ALPHA, TEMP, PSIG = 2.0, 2.0, 1.0, 1.0, 2.0
MLR, MSIG, PBW0 = 1e-3, 0.1, 0.05
G_SIM, G_MODEL, DT = 10.0, 9.8, 0.05
TOLS = dict(th=1e-5, om=1e-4, action=1e-4, cost=1e-3, bw_sv=1e-6,
            bw_mpf=1e-6, theta=1e-3, a_mat=5e-3, mpf_x=1e-5)
FIELDS = ("th", "om", "action", "cost", "bw_sv", "bw_mpf")


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


def _setup(steps, seed=1):
    rng = np.random.default_rng(seed)
    theta0 = (0.3 * rng.normal(size=(M, HZ))).astype(np.float32)
    mpfx0 = np.stack([1.0 + 0.1 * rng.normal(size=MM),
                      1.0 + 0.1 * rng.normal(size=MM)], 1).astype(np.float32)
    eps = rng.normal(size=(steps, HZ, 8, 128)).astype(np.float32)
    pdz = rng.normal(size=(steps, 8, 128)).astype(np.float32)
    pdu = rng.uniform(size=(steps, 8, 128)).astype(np.float32)
    return theta0, mpfx0, eps, pdz, pdu


def _args(theta0, mpfx0, conv, length=1.0, mass=1.0):
    return (conv(np.array([np.pi, 0.0], np.float32)), conv(theta0),
            conv(theta0), conv(np.zeros((M, HZ), np.float32)),
            conv(np.zeros(HZ, np.float32)), conv(mpfx0), PBW0, length, mass,
            SIG, LR, ALPHA, TEMP, PSIG, MLR, MSIG)


_STATICS = dict(hz=HZ, m=M, n_params=NP, n_act=NA, m_mpf=MM, mpf_steps=20,
                dt=DT, g_model=G_MODEL, g_sim=G_SIM)


def _jax(steps, warm_up, theta0, mpfx0, eps, pdz, pdu, **kw):
    out = j_episode(jnp.zeros(2, jnp.int32),
                    *_args(theta0, mpfx0, jnp.asarray), steps=steps,
                    warm_up=warm_up, host_eps=eps, host_pdz=pdz,
                    host_pdu=pdu, interpret=True, **_STATICS, **kw)
    return {k: np.asarray(v) for k, v in out.items()}


def _port(steps, warm_up, theta0, mpfx0, eps, pdz, pdu, **kw):
    out = tep.fused_pendulum_episode(
        [0, 0], *_args(theta0, mpfx0, _t), steps=steps, warm_up=warm_up,
        host_eps=_t(eps), host_pdz=_t(pdz), host_pdu=_t(pdu), **_STATICS,
        **kw)
    return {k: v.numpy() for k, v in out.items()}


def _composition(steps, warm_up, theta0, mpfx0, eps, pdz, pdu):
    """The same episode as a host loop over the port's K3 and K2 functions
    (`tests/test_pallas_episode.py:_reference_composition`)."""
    theta = locs = _t(theta0)
    amat = torch.zeros((M, HZ))
    aseq = torch.zeros(HZ)
    x = _t(mpfx0)
    pbw = torch.tensor(PBW0)
    obs = _t([np.pi, 0.0])
    log_mix = torch.full((M,), -np.log(M))
    logs = {k: [] for k in FIELDS}
    for t in range(steps):
        bw_sv = silvermans_rule(theta)
        actions = theta[None] + SIG * _t(eps[t, :, :M, :NA]).permute(2, 1, 0)
        idx = np.minimum(np.floor(pdu[t, :NP, 0] * MM), MM - 1).astype(int)
        draws = x[idx] + pbw * _t(pdz[t, :NP, 0:2])
        theta_opt, theta_fwd, amat, _, a_sel, _, _ = fused_pendulum_solve(
            obs, theta, locs, log_mix, amat, aseq, actions, draws[:, 0],
            draws[:, 1], bw_sv, LR, ALPHA, TEMP, SIG, PSIG, hz=HZ, m=M,
            n_params=NP, n_act=NA, dt=DT, g=G_MODEL)
        if t >= warm_up:
            action, theta, locs = a_sel[0], theta_fwd, theta_fwd
        else:
            action, theta = torch.tensor(0.0), theta_opt
        a_cl = torch.clamp(action, -2.0, 2.0)
        om2 = torch.clamp(
            obs[1] + (-1.5 * G_SIM * torch.sin(obs[0] + np.pi)
                      + 3.0 * a_cl) * DT, -8.0, 8.0)
        th2 = obs[0] + om2 * DT
        new_obs = torch.stack([th2, om2])
        bw_mpf = silvermans_rule(x)
        x = fused_pendulum_mpf_optimize(x, x, obs, new_obs, action[None],
                                        bw_mpf, pbw, MLR, MSIG, n_steps=20,
                                        dt=DT, g=G_MODEL)
        pbw, obs = bw_mpf, new_obs
        for k, v in zip(FIELDS, (th2, om2, action,
                                 50.0 * (torch.cos(th2) - 1.0) ** 2 + om2**2,
                                 bw_sv, bw_mpf)):
            logs[k].append(float(v))
    return ({k: np.array(v) for k, v in logs.items()}, theta.numpy(),
            amat.numpy(), x.numpy())


def _assert_close(out, ref_logs, ref_theta, ref_amat, ref_x, who):
    for k in FIELDS:
        np.testing.assert_allclose(out[k], ref_logs[k], atol=TOLS[k],
                                   err_msg=f"{who} {k}")
    for k, ref in (("theta", ref_theta), ("a_mat", ref_amat),
                   ("mpf_x", ref_x)):
        np.testing.assert_allclose(out[k], ref, atol=TOLS[k],
                                   err_msg=f"{who} {k}")


@pytest.mark.parametrize("warm_up", [0, 2])
def test_episode_plain_matches_jax_and_port_composition(warm_up):
    steps = 3
    data = _setup(steps)
    out = _port(steps, warm_up, *data)
    j = _jax(steps, warm_up, *data)
    _assert_close(out, j, j["theta"], j["a_mat"], j["mpf_x"], "jax")
    _assert_close(out, *_composition(steps, warm_up, *data), "composition")

    # one step: no chaotic amplification yet
    theta0, mpfx0, eps, pdz, pdu = data
    one = (theta0, mpfx0, eps[:1], pdz[:1], pdu[:1])
    out1 = _port(1, warm_up, *one)
    j1 = _jax(1, warm_up, *one)
    c_logs, c_theta, c_amat, _ = _composition(1, warm_up, *one)
    for ref_theta, ref_amat, ref_action in (
            (j1["theta"], j1["a_mat"], j1["action"][0]),
            (c_theta, c_amat, c_logs["action"][0])):
        np.testing.assert_allclose(out1["theta"], ref_theta, atol=1e-6)
        np.testing.assert_allclose(out1["a_mat"], ref_amat, atol=1e-6)
        np.testing.assert_allclose(out1["action"][0], ref_action, atol=1e-6)


def test_plain_delta_sums_in_the_kernels_lane_order(monkeypatch):
    """K4/K5's DISCO delta and likelihood gradient sum over the 128 action
    samples in the kernel's order, 8 lanes per entry
    (csrc/pendulum_episode.cu:kSumLanes): with `lane_sum` replaced by that
    order written out, a 2-step episode gives the same bits (two sums of
    [hz, m, n_act] terms per step, both through that order)."""
    from dust_tpu_torch.ops import particle_mpf

    setup = _setup(2, seed=3)
    want = _port(2, 0, *setup)
    assert tep.SUM_LANES == 8
    calls = []

    def explicit(t, lanes):
        calls.append((tuple(t.shape), lanes))
        return _explicit_lane_sum(t, lanes)

    monkeypatch.setattr(particle_mpf, "lane_sum", explicit)
    got = _port(2, 0, *setup)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert calls == [((1, HZ, M, NA), 8)] * 4


@pytest.mark.parametrize("option", [
    dict(mpf_log_space=True), dict(mpf_fixed_bw=0.07),
    dict(mpf_bw_scale=1.7)])
def test_episode_options_match_jax(option):
    theta0, mpfx0, eps, pdz, pdu = _setup(1)
    if option.get("mpf_log_space"):
        mpfx0 = np.log(mpfx0)
    data = (theta0, mpfx0, eps, pdz, pdu)
    out = _port(1, 0, *data, **option)
    j = _jax(1, 0, *data, **option)
    _assert_close(out, j, j["theta"], j["a_mat"], j["mpf_x"], str(option))
    if "mpf_fixed_bw" in option:
        np.testing.assert_allclose(out["bw_mpf"], 0.07, rtol=1e-7)


def test_episode_true_params_enter_simulator():
    data = _setup(2, seed=3)
    a = tep.fused_pendulum_episode(
        [0, 0], *_args(data[0], data[1], _t, 1.0, 1.0), steps=2,
        host_eps=_t(data[2]), host_pdz=_t(data[3]), host_pdu=_t(data[4]),
        **_STATICS)
    b = tep.fused_pendulum_episode(
        [0, 0], *_args(data[0], data[1], _t, 1.25, 0.8), steps=2,
        host_eps=_t(data[2]), host_pdz=_t(data[3]), host_pdu=_t(data[4]),
        **_STATICS)
    assert not torch.allclose(a["om"], b["om"])
    assert float(a["action"][0]) == float(b["action"][0])


def test_episode_shape_guards():
    data = _setup(1)
    for over, match in ((dict(m=9), "m<=8"), (dict(m_mpf=65), "m_mpf"),
                        (dict(n_params=9), "n_params")):
        kw = dict(_STATICS, **over)
        with pytest.raises(ValueError, match=match):
            tep.fused_pendulum_episode([0, 0], *_args(data[0], data[1], _t),
                                       steps=1, **kw)


def test_silverman_rows_matches_silvermans_rule():
    """Exact order statistics: random rows at several scales, a row of
    duplicates, a row whose IQR is 0 (the std branch) and a constant row
    (the 1e-6 floor)."""
    n = 90
    rng = np.random.default_rng(7)
    vals = (rng.normal(size=(8, n))
            * np.arange(1, 9, dtype=np.float32)[:, None]).astype(np.float32)
    vals[3, 10:20] = vals[3, 0]                      # duplicates
    vals[5, 5:85] = 0.25                             # IQR = 0
    vals[6] = 1.5                                    # collapsed
    got = tep.silverman_rows(_t(vals)).numpy()
    want = np.array([float(silvermans_rule(_t(v))) for v in vals])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[6] == np.float32(1e-6)
    assert tep.percentile_ks(90, 25.0) == (23, 24, 0.25)


def test_rot_sincos_matches_trig():
    x = torch.linspace(-0.4, 0.4, 101)
    s, c = tep.rot_sincos(x, 0.4)
    np.testing.assert_allclose(s.numpy(), np.sin(x.numpy()), atol=1e-7)
    np.testing.assert_allclose(c.numpy(), np.cos(x.numpy()), atol=1e-7)
    x = torch.linspace(-0.9, 0.9, 101)
    s, c = tep.rot_sincos(x, 0.9)
    np.testing.assert_allclose(s.numpy(), np.sin(x.numpy()), atol=1e-6)
    s, c = tep.rot_sincos(x, 2.0)
    np.testing.assert_array_equal(c.numpy(), torch.cos(x).numpy())


def test_counter_rng_streams():
    """Deterministic per (seed, step, scenario), distinct across each, and
    N(0, 1) / U[0, 1) moments of 10^5 draws within 1%."""
    def draw(seed, step, scenario):
        return tep.device_noise(torch.tensor([seed]), torch.tensor([scenario]),
                                step, hz=100, m=8, n_act=128, n_params=8)

    eps, pdz, pdu = draw([3, 7], 0, 0)
    assert eps.shape == (1, 100, 8, 128) and eps.numel() == 102400
    for a, b in zip(draw([3, 7], 0, 0), (eps, pdz, pdu)):
        assert torch.equal(a, b)
    for other in (draw([3, 8], 0, 0), draw([4, 7], 0, 0), draw([3, 7], 1, 0),
                  draw([3, 7], 0, 1)):
        assert not torch.equal(other[0], eps)
    z = draw([1, 7], 0, 0)[0].double().reshape(-1)
    assert abs(float(z.mean())) < 0.01
    assert abs(float(z.var()) - 1.0) < 0.01
    u = tep.bits_to_uniform(tep.counter_bits(
        tep.rng_key(3, 7, 0, 0), torch.arange(100_000))).double()
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.005
    assert abs(float(u.var()) * 12.0 - 1.0) < 0.01
    # the hash is a 32-bit bijection computed exactly in int64
    x = torch.arange(1 << 16, dtype=torch.int64) * 65537
    assert torch.unique(tep._hash32(x)).numel() == x.numel()
    assert int(tep._hash32(torch.tensor(1))) == 0x688990C0


def test_device_rng_episode_is_deterministic_per_seed():
    theta0, mpfx0, *_ = _setup(1)
    run = lambda seed: tep.fused_pendulum_episode(
        seed, *_args(theta0, mpfx0, _t), steps=2, **_STATICS)
    a, b, c = run([3, 7]), run([3, 7]), run([3, 8])
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert torch.isfinite(a["cost"]).all()
    assert not torch.equal(a["action"], c["action"])


def test_megakernel_episode_adapter_runs_the_demo_stack():
    import copy

    from dust_tpu_torch.experiments import (
        PENDULUM_DEMO_CONFIG,
        build_pendulum_stack,
    )
    from dust_tpu_torch.simulation import megakernel_pendulum_episode_fn

    cfg = copy.deepcopy(PENDULUM_DEMO_CONFIG)
    stack = build_pendulum_stack(cfg, torch.Generator().manual_seed(0),
                                 case="dust", device="cpu")
    episode = megakernel_pendulum_episode_fn(stack, cfg["exp_params"],
                                             steps=2)
    a, b = episode([0, 1]), episode([0, 1], true_length=1.2)
    assert a["theta"].shape == (3, 30) and a["mpf_x"].shape == (50, 2)
    assert torch.isfinite(a["cost"]).all() and a["cost"].shape == (2,)
    assert float(a["action"][0]) == float(b["action"][0])
    assert not torch.equal(a["om"], b["om"])
