"""`dust_tpu_torch.parallel.ShardedSVMPC` at world sizes 2 and 4 (gloo
ranks in subprocesses, `tests/test_torch_mesh.py:run_ranks`) against
JAX's `ShardedSVMPC` on `make_mesh(n_devices=world)` and the port's
unsharded `SVMPC.svgd_step`, with the same injected noise and fixed
parameter draws.

Tolerances are tests/test_svmpc_sharded.py's (:85-101): costs and theta
rtol 1e-4, atol 1e-4; a_mat rtol 1e-3, atol 1e-4; a_mix rtol 1e-3, atol
1e-6; the forward's a_seq rtol 1e-4, atol 1e-4 and weights rtol 1e-3,
atol 1e-5. With Adam at 0.1 (the counterpart of
tests/test_svmpc_sharded.py:126), two steps on fresh noise against JAX's
single-device SVMPC and its ShardedSVMPC and the port's unsharded SVMPC:
theta at the same rtol 1e-4, atol 1e-4, Adam's first moment at rtol 1e-3,
atol 1e-5, its second at rtol 2e-3, atol 1e-6, and its count (the scalar
leaf, whole on every rank) exactly. An unknown optimizer name raises."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dust_tpu.distributions import GMM as JGMM
from dust_tpu.parallel import make_mesh as jax_make_mesh
from dust_tpu.parallel.svmpc_sharded import ShardedSVMPC as JSharded
from tests.test_svmpc_sharded import HORIZON, M, N_SAMPLES, _build, \
    _FixedParams
from tests.test_torch_mesh import WORLDS, read_same_on_every_rank, run_ranks

BW = 0.9
STATE = [[3.0, 0.0]]

WORKER = """
from dust_tpu_torch.controllers import MultiDisco
from dust_tpu_torch.distributions import GMM
from dust_tpu_torch.experiments import pendulum_cost_fns
from dust_tpu_torch.inference import SVMPC, ExponentiatedUtility
from dust_tpu_torch.models import PendulumModel
from dust_tpu_torch.parallel import ShardedSVMPC
from dust_tpu_torch.spaces import Box
from dust_tpu_torch.utils import MerweScaledUTF

t = {k: torch.tensor(v) for k, v in inp.items()}
inst, term = pendulum_cost_fns()
mesh = make_mesh(axis_names=("particle",), device="cpu")
counts = count_collectives()


class Fixed:
    def __init__(self, draws):
        self.draws = draws

    def sample(self, generator, shape):
        return self.draws

    def log_prob(self, x):
        return torch.zeros(self.draws.shape[0])


def build(m=8, params_sampling=True, **kw):
    model = PendulumModel(uncertain_params=("length", "mass"))
    ctrl = MultiDisco(Box(dim=2), Box(dim=1, low=-2.0, high=2.0), 10, m, 16,
                      params_samples=4, a_cov=4.0 * torch.eye(1),
                      inst_cost_fn=inst, term_cost_fn=term,
                      params_sampling=params_sampling, device="cpu")
    lik = ExponentiatedUtility(alpha=1.0, n_samples=16, controller=ctrl,
                               model=model)
    return model, ctrl, SVMPC(likelihood=lik, n_particles=m,
                              **{"lr": 1.0, **kw})


model, ctrl, svmpc = build()
sharded = ShardedSVMPC(svmpc, model, mesh)
prior = GMM.from_cov(t["theta0"], torch.ones(8), 4.0 * torch.eye(1))
sv, ds = sharded.shard_states(svmpc.init_state(t["theta0"], prior),
                              ctrl.init_state())
sv, ds, costs = sharded.svgd_step(sv, ds, torch.tensor([[3.0, 0.0]]),
                                  Fixed(t["draws"]), torch.Generator(), 0.9,
                                  noise=t["noise"])
save("collectives", np.array([counts["all_reduce"], counts["all_gather"]]))
for k, v in (("costs", costs), ("theta", sv.theta), ("a_mat", ds.a_mat),
             ("a_mix", ds.a_mix)):
    save(k, v)
sv2, a_seq, w = sharded.forward(sv, costs)
save("a_seq", a_seq)
save("weights", w)

# a per-state learning rate reaches the sharded step
sv_lr = svmpc.init_state(t["theta0"], prior)
sv_lr = type(sv_lr)(theta=sv_lr.theta, prior=sv_lr.prior, lr=0.25)
sv_lr, _, _ = sharded.svgd_step(sv_lr, ctrl.init_state(),
                                torch.tensor([[3.0, 0.0]]), Fixed(t["draws"]),
                                torch.Generator(), 0.9, noise=t["noise"])
save("theta_lr", sv_lr.theta)

# keyed noise: the caller's generator (the same seed on every rank)
sv3, ds3, costs3 = sharded.svgd_step(
    svmpc.init_state(t["theta0"], prior), ctrl.init_state(),
    torch.tensor([[3.0, 0.0]]), Fixed(t["draws"]),
    torch.Generator().manual_seed(3), 0.9)
save("keyed_theta", sv3.theta)
save("keyed_costs", costs3)

# Adam at 0.1: two steps on fresh noise, the moments and the count carried
model_a, ctrl_a, svmpc_a = build(optimizer="adam", lr=0.1)
sharded_a = ShardedSVMPC(svmpc_a, model_a, mesh)
sv_a, ds_a = sharded_a.shard_states(svmpc_a.init_state(t["theta0"], prior),
                                    ctrl_a.init_state())
for i in range(2):
    sv_a, ds_a, costs_a = sharded_a.svgd_step(
        sv_a, ds_a, torch.tensor([[3.0, 0.0]]), Fixed(t["draws"]),
        torch.Generator(), 0.9, noise=t["adam_noise"][i])
    save(f"adam_theta{i}", sv_a.theta)
    save(f"adam_mu{i}", sv_a.opt_state.mu)
    save(f"adam_nu{i}", sv_a.opt_state.nu)
    save(f"adam_count{i}", np.array(sv_a.opt_state.count))
save("adam_costs", costs_a)

raised = []
for make in (
        lambda: ShardedSVMPC(build(kernel="message_passing")[2], model, mesh),
        lambda: ShardedSVMPC(build(reference_compat=True)[2], model, mesh),
        lambda: ShardedSVMPC(build(optimizer="rmsprop")[2], model, mesh),
        lambda: ShardedSVMPC(build(
            m=1, params_sampling=MerweScaledUTF(n=2, alpha=0.5))[2], model,
            mesh),
        lambda: sharded.shard_states(svmpc.init_state(
            t["theta0"][:world + 1], prior), ctrl.init_state()),
        # an optimizer leaf neither per particle nor a scalar
        lambda: sharded_a.shard_states(type(sv_a)(
            theta=sv_a.theta, prior=prior, opt_state=type(sv_a.opt_state)(
                count=0, mu=torch.zeros(3), nu=torch.zeros(3))),
            ctrl_a.init_state())):
    try:
        make()
        raised.append("")
    except ValueError as exc:
        raised.append(str(exc))
save("utf_message", np.array("UTF" in raised[3]))
save("raised", np.array([bool(r) for r in raised]))
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("svmpc")
    rng = np.random.default_rng(0)
    inp = dict(
        theta0=(rng.normal(size=(M, HORIZON, 1)) * 2).astype(np.float32),
        noise=rng.normal(size=(N_SAMPLES, M, HORIZON, 1)).astype(
            np.float32),
        draws=rng.uniform(0.6, 1.3, size=(4, 2)).astype(np.float32),
        adam_noise=rng.normal(size=(2, N_SAMPLES, M, HORIZON, 1)).astype(
            np.float32))
    np.savez(tmp / "inputs.npz", **inp)
    run_ranks(tmp, WORKER)
    return tmp, inp


def _torch_unsharded(inp, lr=None):
    from dust_tpu_torch.controllers import MultiDisco
    from dust_tpu_torch.distributions import GMM
    from dust_tpu_torch.experiments import pendulum_cost_fns
    from dust_tpu_torch.inference import SVMPC, ExponentiatedUtility
    from dust_tpu_torch.models import PendulumModel
    from dust_tpu_torch.spaces import Box

    class Fixed:
        def sample(self, generator, shape):
            return torch.tensor(inp["draws"])

        def log_prob(self, x):
            return torch.zeros(4)

    inst, term = pendulum_cost_fns()
    model = PendulumModel(uncertain_params=("length", "mass"))
    ctrl = MultiDisco(Box(dim=2), Box(dim=1, low=-2.0, high=2.0), HORIZON, M,
                      N_SAMPLES, params_samples=4, a_cov=4.0 * torch.eye(1),
                      inst_cost_fn=inst, term_cost_fn=term,
                      params_sampling=True, device="cpu")
    lik = ExponentiatedUtility(alpha=1.0, n_samples=N_SAMPLES,
                               controller=ctrl, model=model)
    svmpc = SVMPC(likelihood=lik, n_particles=M,
                  lr=1.0 if lr is None else lr)
    theta0 = torch.tensor(inp["theta0"])
    sv = svmpc.init_state(theta0, GMM.from_cov(theta0, torch.ones(M),
                                                4.0 * torch.eye(1)))
    sv, ds, costs = svmpc.svgd_step(sv, ctrl.init_state(),
                                    torch.tensor(STATE), Fixed(),
                                    torch.Generator(), BW,
                                    noise=torch.tensor(inp["noise"]))
    sv2, a_seq, w = svmpc.forward(sv, costs)
    return {"costs": costs, "theta": sv.theta, "a_mat": ds.a_mat,
            "a_mix": ds.a_mix, "a_seq": a_seq, "weights": w}


def _jax_sharded(inp, world):
    model, ctrl, svmpc = _build()
    sharded = JSharded(svmpc, model, jax_make_mesh(
        n_devices=world, axis_names=("particle",)))
    theta0 = jnp.asarray(inp["theta0"])
    prior = JGMM.from_cov(theta0, jnp.ones(M), 4.0 * jnp.eye(1))
    sv, ds = sharded.shard_states(svmpc.init_state(theta0, prior),
                                  ctrl.init_state())
    sv, ds, costs = jax.jit(sharded.svgd_step)(
        sv, ds, jnp.asarray(STATE), _FixedParams(draws=jnp.asarray(
            inp["draws"])), jax.random.key(0), BW,
        noise=jnp.asarray(inp["noise"]))
    sv2, a_seq, w = jax.jit(sharded.forward)(sv, costs)
    return {"costs": costs, "theta": sv.theta, "a_mat": ds.a_mat,
            "a_mix": ds.a_mix, "a_seq": a_seq, "weights": w}


TOL = {"costs": (1e-4, 1e-4), "theta": (1e-4, 1e-4), "a_mat": (1e-3, 1e-4),
       "a_mix": (1e-3, 1e-6), "a_seq": (1e-4, 1e-4),
       "weights": (1e-3, 1e-5)}


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_svmpc_matches_jax_and_unsharded(ranks, world):
    tmp, inp = ranks
    wants = [_jax_sharded(inp, world), _torch_unsharded(inp)]
    for k, (rtol, atol) in TOL.items():
        got = read_same_on_every_rank(tmp, k, world)
        for want in wants:
            np.testing.assert_allclose(got, np.asarray(want[k]), rtol=rtol,
                                       atol=atol, err_msg=k)
    # MIN, MAX, SUM; the gather of the scores and of the rank's outputs
    np.testing.assert_array_equal(
        read_same_on_every_rank(tmp, "collectives", world), [3, 2])


def _adam_runs(inp, world):
    """Two Adam steps (optax.adam(0.1)) on inp["adam_noise"]: JAX's
    single-device SVMPC, JAX's ShardedSVMPC over `world` devices and the
    port's unsharded SVMPC; each a list of (theta, mu, nu, count)."""
    import optax

    from dust_tpu.inference import SVMPC as JSVMPC
    from dust_tpu_torch.controllers import MultiDisco
    from dust_tpu_torch.distributions import GMM
    from dust_tpu_torch.experiments import pendulum_cost_fns
    from dust_tpu_torch.inference import SVMPC, ExponentiatedUtility
    from dust_tpu_torch.models import PendulumModel
    from dust_tpu_torch.spaces import Box

    model, ctrl, sgd = _build()
    jsvmpc = JSVMPC(likelihood=sgd.likelihood, kernel="rbf", n_particles=M,
                    optimizer=optax.adam(0.1), reference_compat=False)
    theta0 = jnp.asarray(inp["theta0"])
    prior = JGMM.from_cov(theta0, jnp.ones(M), 4.0 * jnp.eye(1))
    params = _FixedParams(draws=jnp.asarray(inp["draws"]))
    sharded = JSharded(jsvmpc, model, jax_make_mesh(
        n_devices=world, axis_names=("particle",)))
    runs = {}
    for name, step, (sv, ds) in (
            ("jax", jsvmpc.svgd_step,
             (jsvmpc.init_state(theta0, prior), ctrl.init_state())),
            ("jax_sharded", jax.jit(sharded.svgd_step), sharded.shard_states(
                jsvmpc.init_state(theta0, prior), ctrl.init_state()))):
        out = []
        for i in range(2):
            sv, ds, _ = step(sv, ds, jnp.asarray(STATE), params,
                             jax.random.key(0), BW,
                             noise=jnp.asarray(inp["adam_noise"][i]))
            adam = sv.opt_state[0]
            out.append((np.asarray(sv.theta), np.asarray(adam.mu),
                        np.asarray(adam.nu), int(adam.count)))
        runs[name] = out

    class Fixed:
        def sample(self, generator, shape):
            return torch.tensor(inp["draws"])

        def log_prob(self, x):
            return torch.zeros(4)

    inst, term = pendulum_cost_fns()
    tmodel = PendulumModel(uncertain_params=("length", "mass"))
    tctrl = MultiDisco(Box(dim=2), Box(dim=1, low=-2.0, high=2.0), HORIZON,
                       M, N_SAMPLES, params_samples=4,
                       a_cov=4.0 * torch.eye(1), inst_cost_fn=inst,
                       term_cost_fn=term, params_sampling=True, device="cpu")
    tsvmpc = SVMPC(likelihood=ExponentiatedUtility(
        alpha=1.0, n_samples=N_SAMPLES, controller=tctrl, model=tmodel),
        n_particles=M, optimizer="adam", lr=0.1)
    t0 = torch.tensor(inp["theta0"])
    sv = tsvmpc.init_state(t0, GMM.from_cov(t0, torch.ones(M),
                                            4.0 * torch.eye(1)))
    ds, out = tctrl.init_state(), []
    for i in range(2):
        sv, ds, _ = tsvmpc.svgd_step(sv, ds, torch.tensor(STATE), Fixed(),
                                     torch.Generator(), BW,
                                     noise=torch.tensor(inp["adam_noise"][i]))
        out.append((sv.theta.numpy(), sv.opt_state.mu.numpy(),
                    sv.opt_state.nu.numpy(), sv.opt_state.count))
    runs["torch"] = out
    return runs


ADAM_TOL = ((1e-4, 1e-4), (1e-3, 1e-5), (2e-3, 1e-6))


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_svmpc_adam_matches_jax_and_unsharded(ranks, world):
    tmp, inp = ranks
    for name, want in _adam_runs(inp, world).items():
        for i in range(2):
            for k, w, (rtol, atol) in zip(("theta", "mu", "nu"), want[i],
                                          ADAM_TOL):
                np.testing.assert_allclose(
                    read_same_on_every_rank(tmp, f"adam_{k}{i}", world), w,
                    rtol=rtol, atol=atol, err_msg=f"{name} step {i} {k}")
            assert read_same_on_every_rank(tmp, f"adam_count{i}",
                                           world) == want[i][3] == i + 1
    assert np.isfinite(read_same_on_every_rank(tmp, "adam_costs",
                                               world)).all()


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_svmpc_per_state_learning_rate(ranks, world):
    tmp, inp = ranks
    np.testing.assert_allclose(
        read_same_on_every_rank(tmp, "theta_lr", world),
        _torch_unsharded(inp, lr=0.25)["theta"].numpy(), rtol=1e-4,
        atol=1e-4)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_svmpc_keyed_noise_runs(ranks, world):
    """Per-rank generators (no injected noise): finite costs, moving
    particles, the same whole result on every rank."""
    tmp, inp = ranks
    costs = read_same_on_every_rank(tmp, "keyed_costs", world)
    theta = read_same_on_every_rank(tmp, "keyed_theta", world)
    assert costs.shape == (N_SAMPLES, M) and np.isfinite(costs).all()
    assert np.isfinite(theta).all()
    assert not np.allclose(theta, inp["theta0"])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_svmpc_rejects_what_it_does_not_shard(ranks, world):
    """message_passing, reference_compat, an unknown optimizer name, a UTF
    controller, a particle count that does not split over the ranks, and
    an optimizer-state leaf neither per particle nor a scalar."""
    tmp, _ = ranks
    assert read_same_on_every_rank(tmp, "raised", world).all()
    assert read_same_on_every_rank(tmp, "utf_message", world)
