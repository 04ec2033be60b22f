"""`dust_tpu_torch.parallel.stein` at world sizes 2 and 4 (gloo ranks in
subprocesses, `tests/test_torch_mesh.py:run_ranks`): the particle-sharded
SVGD direction, the row-blocked GMM prior score and `ShardedMPF`, each
against JAX's sharded counterpart on `make_mesh(n_devices=world)` over
the virtual CPU devices and against the port's unsharded function, on
the same numpy-seeded inputs.

Tolerances are tests/test_stein_sharded.py's: rtol 1e-4, atol 1e-5 for
the direction, the score and the particles (:27, :57), rtol 1e-3 for the
gradient norms (:60); with Adam (optax.adam(1e-2), two optimize calls,
the moments carried) the particles and the first moment at rtol 1e-4,
atol 1e-5, the count exactly. The global form and the local body agree
bit for bit (the same row arithmetic), and every rank returns the same
bits."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dust_tpu.inference import GaussianLikelihood as JLik
from dust_tpu.models import PendulumModel as JPendulum
from dust_tpu.parallel import make_mesh as jax_make_mesh
from dust_tpu.parallel.stein import ShardedMPF as JShardedMPF
from dust_tpu.parallel.stein import make_sharded_gmm_score as j_gmm_score
from dust_tpu.parallel.stein import make_sharded_svgd_phi as j_phi
from dust_tpu_torch.distributions import GMM
from dust_tpu_torch.ops.svgd import svgd_phi_reference
from tests.test_torch_mesh import WORLDS, read_same_on_every_rank, run_ranks

RTOL, ATOL = 1e-4, 1e-5
BW, M_PHI, M_GMM, M_MPF = 0.9, 64, 32, 64
MPF_OBS = np.array([2.8, -0.2], np.float32)
MPF_ACTION = np.array([0.8], np.float32)
MPF_NEW_OBS = np.array([2.7, -0.5], np.float32)
MPF_NEW_OBS2 = np.array([2.6, -0.1], np.float32)

WORKER = """
from dust_tpu_torch.inference import MPF, GaussianLikelihood
from dust_tpu_torch.models import PendulumModel
from dust_tpu_torch.parallel import (ShardedMPF, make_sharded_gmm_score,
                                     make_sharded_svgd_phi)
from dust_tpu_torch.parallel.mesh import all_gather_rows, local_rows

t = {k: torch.tensor(v) for k, v in inp.items()}
mesh = make_mesh(axis_names=("particle",), device="cpu")
counts = count_collectives()

phi = make_sharded_svgd_phi(mesh, "particle")
save("phi", phi(t["x"], t["score"], 0.9))
save("phi_collectives", np.array([counts["all_reduce"],
                                  counts["all_gather"]]))
mine = phi.local(local_rows(t["x"], mesh, "particle"),
                 local_rows(t["score"], mesh, "particle"), 0.9)
save("phi_local", all_gather_rows(mine, mesh, "particle"))

score = make_sharded_gmm_score(mesh, "particle")
save("gmm", score(t["gx"], t["locs"], t["logits"], t["tril"]))
mine = score.local(*(local_rows(t[k], mesh, "particle")
                     for k in ("gx", "locs", "logits")), t["tril"])
save("gmm_local", all_gather_rows(mine, mesh, "particle"))

lik = GaussianLikelihood(obs_std=0.1,
                         model=PendulumModel(uncertain_params=("length",
                                                               "mass")))
sharded = ShardedMPF(likelihood=lik, mesh=mesh, lr=1e-3)
ms0 = sharded.shard_state(sharded.init_state(t["init"], t["obs"], dim_a=1,
                                             bw=0.2))
for k in counts:
    counts[k] = 0
ms1, grads, _ = sharded.optimize(ms0, t["action"], t["new_obs"], bw=0.3,
                                 n_steps=5)
save("mpf_x", ms1.x)
save("mpf_grads", grads)
save("mpf_collectives", np.array([counts["all_reduce"],
                                  counts["all_gather"]]))
# Adam: two optimize calls, the moments carried from one to the next
adam = ShardedMPF(likelihood=lik, mesh=mesh, lr=1e-2, optimizer="adam")
ms = adam.shard_state(adam.init_state(t["init"], t["obs"], dim_a=1, bw=0.2))
for i, new_obs in enumerate((t["new_obs"], t["new_obs2"])):
    ms, grads, _ = adam.optimize(ms, t["action"], new_obs, bw=0.3,
                                 n_steps=3)
    save(f"adam_x{i}", ms.x)
    save(f"adam_mu{i}", ms.opt_state.mu)
    save(f"adam_count{i}", np.array(ms.opt_state.count))
try:
    sharded.shard_state(sharded.init_state(t["init"][:world + 1],
                                           t["obs"], dim_a=1, bw=0.2))
    save("mpf_raised", np.array(False))
except ValueError:
    save("mpf_raised", np.array(True))
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stein")
    rng = np.random.default_rng(0)
    a = rng.normal(size=(2, 2)).astype(np.float32)
    inp = dict(
        x=rng.normal(size=(M_PHI, 3)).astype(np.float32),
        score=(rng.normal(size=(M_PHI, 3)) * 4.0).astype(np.float32),
        gx=rng.normal(size=(M_GMM, 2)).astype(np.float32),
        locs=rng.normal(size=(M_GMM, 2)).astype(np.float32),
        logits=rng.normal(size=(M_GMM,)).astype(np.float32),
        tril=np.linalg.cholesky(a @ a.T + 0.5 * np.eye(2)).astype(
            np.float32),
        init=rng.uniform(0.6, 1.3, size=(M_MPF, 2)).astype(np.float32),
        obs=MPF_OBS, action=MPF_ACTION, new_obs=MPF_NEW_OBS,
        new_obs2=MPF_NEW_OBS2)
    np.savez(tmp / "inputs.npz", **inp)
    run_ranks(tmp, WORKER)
    return tmp, inp


def _jax_mesh(world):
    return jax_make_mesh(n_devices=world, axis_names=("particle",))


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_phi_matches_jax_and_unsharded(ranks, world):
    tmp, inp = ranks
    got = read_same_on_every_rank(tmp, "phi", world)
    np.testing.assert_array_equal(
        read_same_on_every_rank(tmp, "phi_local", world), got)
    want = jax.jit(j_phi(_jax_mesh(world), "particle"))(
        jnp.asarray(inp["x"]), jnp.asarray(inp["score"]), jnp.float32(BW))
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    plain = svgd_phi_reference(torch.tensor(inp["x"]),
                               torch.tensor(inp["score"]), BW)
    np.testing.assert_allclose(got, plain.numpy(), rtol=RTOL, atol=ATOL)
    # the global form: the rank's rows, one gather of the direction
    np.testing.assert_array_equal(read_same_on_every_rank(
        tmp, "phi_collectives", world), [0, 1])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_gmm_score_matches_jax_and_unsharded(ranks, world):
    tmp, inp = ranks
    got = read_same_on_every_rank(tmp, "gmm", world)
    np.testing.assert_array_equal(
        read_same_on_every_rank(tmp, "gmm_local", world), got)
    want = jax.jit(j_gmm_score(_jax_mesh(world), "particle"))(
        *(jnp.asarray(inp[k]) for k in ("gx", "locs", "logits", "tril")))
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    plain = GMM(locs=torch.tensor(inp["locs"]),
                scale_tril=torch.tensor(inp["tril"]),
                logits=torch.tensor(inp["logits"])).score(
                    torch.tensor(inp["gx"]))
    np.testing.assert_allclose(got, plain.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_mpf_matches_jax_and_unsharded(ranks, world):
    """ShardedMPF.optimize (5 steps) == JAX's ShardedMPF.optimize and the
    port's MPF(reference_compat=False).optimize on the same particles."""
    from dust_tpu_torch.inference import MPF, GaussianLikelihood
    from dust_tpu_torch.models import PendulumModel

    tmp, inp = ranks
    x = read_same_on_every_rank(tmp, "mpf_x", world)
    grads = read_same_on_every_rank(tmp, "mpf_grads", world)

    jlik = JLik(obs_std=0.1, model=JPendulum(uncertain_params=("length",
                                                               "mass")))
    jsh = JShardedMPF(likelihood=jlik, mesh=_jax_mesh(world),
                      optimizer=optax.sgd(1e-3))
    js0 = jsh.shard_state(jsh.init_state(inp["init"], inp["obs"], dim_a=1,
                                         bw=0.2))
    js1, jgrads, _ = jsh.optimize(js0, jnp.asarray(MPF_ACTION),
                                  jnp.asarray(MPF_NEW_OBS), bw=0.3,
                                  n_steps=5)
    np.testing.assert_allclose(x, np.asarray(js1.x), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(grads, np.asarray(jgrads), rtol=1e-3)

    tlik = GaussianLikelihood(
        obs_std=0.1, model=PendulumModel(uncertain_params=("length",
                                                           "mass")))
    plain = MPF(likelihood=tlik, lr=1e-3)
    ms0 = plain.init_state(torch.tensor(inp["init"]),
                           torch.tensor(MPF_OBS), dim_a=1, bw=0.2)
    ms1, pgrads, _ = plain.optimize(ms0, torch.tensor(MPF_ACTION),
                                    torch.tensor(MPF_NEW_OBS), bw=0.3,
                                    n_steps=5)
    np.testing.assert_allclose(x, ms1.x.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(grads, pgrads.numpy(), rtol=1e-3)
    # per SVGD step: the gather of the scores and of the direction
    np.testing.assert_array_equal(read_same_on_every_rank(
        tmp, "mpf_collectives", world), [0, 2 * 5])
    # 65 particles do not split over the ranks
    assert read_same_on_every_rank(tmp, "mpf_raised", world)



@pytest.mark.parametrize("world", WORLDS)
def test_sharded_mpf_adam_matches_jax_and_unsharded(ranks, world):
    """ShardedMPF(optimizer="adam") over two optimize calls of 3 steps ==
    JAX's ShardedMPF(optimizer=optax.adam(1e-2)) and the port's MPF with
    Adam; the moments are whole and the same on every rank."""
    from dust_tpu_torch.inference import MPF, GaussianLikelihood
    from dust_tpu_torch.models import PendulumModel

    tmp, inp = ranks
    jlik = JLik(obs_std=0.1, model=JPendulum(uncertain_params=("length",
                                                               "mass")))
    jsh = JShardedMPF(likelihood=jlik, mesh=_jax_mesh(world),
                      optimizer=optax.adam(1e-2))
    js = jsh.shard_state(jsh.init_state(inp["init"], inp["obs"], dim_a=1,
                                        bw=0.2))
    plain = MPF(likelihood=GaussianLikelihood(
        obs_std=0.1, model=PendulumModel(uncertain_params=("length",
                                                           "mass"))),
        lr=1e-2, optimizer="adam")
    ps = plain.init_state(torch.tensor(inp["init"]), torch.tensor(MPF_OBS),
                          dim_a=1, bw=0.2)
    for i, new_obs in enumerate((MPF_NEW_OBS, MPF_NEW_OBS2)):
        js, _, _ = jsh.optimize(js, jnp.asarray(MPF_ACTION),
                                jnp.asarray(new_obs), bw=0.3, n_steps=3)
        ps, _, _ = plain.optimize(ps, torch.tensor(MPF_ACTION),
                                  torch.tensor(new_obs), bw=0.3, n_steps=3)
        x = read_same_on_every_rank(tmp, f"adam_x{i}", world)
        mu = read_same_on_every_rank(tmp, f"adam_mu{i}", world)
        for want_x, want_mu in ((np.asarray(js.x),
                                 np.asarray(js.opt_state[0].mu)),
                                (ps.x.numpy(), ps.opt_state.mu.numpy())):
            np.testing.assert_allclose(x, want_x, rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(mu, want_mu, rtol=RTOL, atol=ATOL)
        assert read_same_on_every_rank(tmp, f"adam_count{i}", world) == \
            int(js.opt_state[0].count) == ps.opt_state.count == 3 * (i + 1)
    assert np.abs(x - inp["init"]).max() > 1e-2
