"""`dust_tpu_torch.utils.helper` and `utils.profiling`: checkpoints of an
episode carry with its `torch.Generator` state (a round trip, and a
resumed pendulum episode bit-equal to an uninterrupted one), the
persistence helpers beside `dust_tpu.utils.helper`'s, `Stopwatch`'s
rates, `debug_mode`'s NaN check and `trace`'s Chrome trace."""

import copy
import json
import pickle

import numpy as np
import pytest
import torch

from dust_tpu.utils.helper import from_np as j_from_np
from dust_tpu.utils.helper import to_np as j_to_np
from dust_tpu_torch.experiments import PENDULUM_DEMO_CONFIG, \
    build_pendulum_stack
from dust_tpu_torch.inference import FusedMPF, FusedPendulumMPF
from dust_tpu_torch.inference.optim import AdamState, make_optimizer
from dust_tpu_torch.simulation import PendulumSimulation
from dust_tpu_torch.utils.helper import (
    from_np,
    load_checkpoint,
    save_checkpoint,
    save_progress,
    to_np,
)
from dust_tpu_torch.utils.profiling import Stopwatch, debug_mode, trace

STEPS, CUT = 6, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _harness(adam=False):
    """The reduced `dust` stack on the K1 hook and K2, or with adam=True
    on Adam at 0.1 (SVMPC) and FusedMPF (K11a + K12a) with Adam at the
    config's MPF rate."""
    cfg = copy.deepcopy(PENDULUM_DEMO_CONFIG)
    cfg["exp_params"].update(horizon=8, action_samples=16, params_samples=4,
                             mpf_n_particles=12, mpf_steps=3,
                             fused_rollout=True)
    stack = build_pendulum_stack(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    if adam:
        stack.svmpc.optimizer = make_optimizer("adam", 0.1)
        stack.mpf = FusedMPF(stack.mpf.likelihood, optimizer="adam",
                             lr=stack.mpf.lr, bw_scale=stack.mpf.bw_scale,
                             n_steps=stack.mpf.n_steps)
    else:
        stack.mpf = FusedPendulumMPF.from_mpf(stack.mpf)
    harness = PendulumSimulation(
        controller=stack.controller, svmpc=stack.svmpc, mpf=stack.mpf,
        model=stack.model, steps=STEPS, warm_up=1, mpf_bw=stack.mpf_bw,
        mpf_steps=stack.mpf_steps, device="cpu")
    obs = stack.init_state.reshape(1, -1)
    carry = (torch.Generator().manual_seed(7), obs,
             stack.controller.init_state(stack.init_policies),
             stack.svmpc.init_state(stack.init_policies,
                                    stack.policies_prior),
             stack.mpf.init_state(stack.mpf_init, obs[0], 1))
    return harness, carry


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.Generator):
        return [tree.get_state()]
    if hasattr(tree, "__dataclass_fields__"):
        return [t for f in tree.__dataclass_fields__
                for t in _tensors(getattr(tree, f))]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return []


def _assert_same(a, b):
    assert type(a) is type(b)
    ta, tb = _tensors(a), _tensors(b)
    assert len(ta) == len(tb) > 0
    for x, y in zip(ta, tb):
        assert x.dtype == y.dtype and x.device == y.device
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)


def test_checkpoint_round_trip(tmp_path):
    harness, carry = _harness()
    gen = carry[0]
    torch.randn(3, generator=gen)           # a generator past its seed
    sv = carry[3]
    carry = carry[:3] + (type(sv)(theta=sv.theta, prior=sv.prior,
                                  prior_updated=True, lr=0.25),) + carry[4:]
    extra = {"note": "x", "steps": [1, 2], "bw": torch.tensor(0.5)}
    path = save_checkpoint(tmp_path / "ck" / "carry.pt", carry, step=12,
                           extra=extra)
    back, step, extra_back = load_checkpoint(path)
    assert step == 12 and extra_back["note"] == "x"
    assert extra_back["steps"] == [1, 2]
    _assert_same(back, carry)
    assert back[3].lr == 0.25 and back[3].prior_updated is True
    # the generator goes on from where it was saved
    np.testing.assert_array_equal(torch.randn(5, generator=back[0]).numpy(),
                                  torch.randn(5, generator=gen).numpy())
    with pytest.raises(TypeError, match="checkpoint"):
        save_checkpoint(tmp_path / "bad.pt", (object(),))


def test_resumed_episode_equals_uninterrupted(tmp_path):
    _resume_check(tmp_path, adam=False)


def test_resumed_adam_episode_equals_uninterrupted(tmp_path):
    """With Adam the carry holds both optimizers' AdamState (count,
    moments); the checkpoint keeps them and the resumed run is bit-equal
    to the uninterrupted one."""
    _resume_check(tmp_path, adam=True)


def _resume_check(tmp_path, adam):
    """Saved at step CUT and resumed: bit-equal to the uninterrupted
    run."""
    harness, carry = _harness(adam)
    step = harness.step_fn(None)
    true = {"length": torch.tensor(1.1), "mass": torch.tensor(0.9)}
    full, logs_full = carry, []
    for t in range(STEPS):
        full, log = step(full, t, true)
        logs_full.append(log)

    _, carry2 = _harness(adam)
    for t in range(CUT):
        carry2, _ = step(carry2, t, true)
    path = save_checkpoint(tmp_path / "carry.pt", carry2, step=CUT)
    resumed, start, _ = load_checkpoint(path)
    if adam:
        for state in (resumed[3], resumed[4]):
            assert isinstance(state.opt_state, AdamState)
        # one SVMPC update and mpf_steps MPF updates per step
        assert resumed[3].opt_state.count == CUT
        assert resumed[4].opt_state.count == 3 * CUT
        _assert_same(resumed, carry2)
    logs = []
    for t in range(start, STEPS):
        resumed, log = step(resumed, t, true)
        logs.append(log)
    _assert_same(resumed, full)
    _assert_same(tuple(logs), tuple(logs_full[CUT:]))


def test_persistence_helpers(tmp_path):
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    t = from_np(x, device="cpu")
    assert isinstance(t, torch.Tensor)
    np.testing.assert_array_equal(to_np(t), j_to_np(j_from_np(x)))
    assert [v.tolist() for v in to_np([t, t])] == [x.tolist()] * 2
    folder = save_progress("run", data={"a": t, "b": [t, 1.5]},
                           params={"k": 1}, root=tmp_path)
    assert folder == tmp_path / "data" / "local" / "run"
    with (folder / "data.pkl").open("rb") as fh:
        data = pickle.load(fh)
    np.testing.assert_array_equal(data["a"], x)
    assert data["b"][1] == 1.5
    assert (folder / "config.yaml").read_text().strip() == "k: 1"


def test_stopwatch_rates_and_summary():
    sw = Stopwatch()
    a = torch.ones(64, 64)
    for _ in range(3):
        with sw.phase("solve") as h:
            h.result = a @ a
    out = sw.timed("solve", torch.matmul, a, a)
    assert torch.equal(out, a @ a)
    sw.timed("other", torch.add, a, a)
    assert sw.counts == {"solve": 4, "other": 1}
    rates = sw.rates(10)
    assert rates["solve"] == pytest.approx(4 * 10 / sw.totals["solve"])
    summary = sw.summary()
    assert summary["solve"]["calls"] == 4
    assert summary["other"]["mean_ms"] == pytest.approx(
        1e3 * sw.totals["other"], abs=1e-3)


def test_debug_mode_flags_a_nan():
    x = torch.tensor([-1.0, 4.0])
    assert torch.isnan(torch.log(x)).any()        # no check outside
    with pytest.raises(FloatingPointError, match="NaN"):
        with debug_mode():
            torch.log(x)
    with debug_mode(nans=True, disable_jit=True):
        assert torch.sqrt(x[1:]).item() == 2.0
    with debug_mode(nans=False):
        torch.log(x)
    assert not torch.is_anomaly_enabled()


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(tmp_path / "t", device="cpu") as t:
        torch.ones(8, 8) @ torch.ones(8, 8)
    events = json.loads(t.path.read_text())["traceEvents"]
    assert t.path.parent == tmp_path / "t"
    assert any("mm" in e.get("name", "") for e in events)
