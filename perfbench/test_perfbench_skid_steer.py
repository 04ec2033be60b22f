"""The `skid_steer.sweep` cell's files found by name, its reference's
imports, its frozen counts, and its check: the bfloat16 control, the
frozen MPF and faults planted in the timed path (x_icr's likelihood
gradient zeroed among them) fail it at a size the CPU holds, and, marked
`card`, the control and the frozen MPF fail it at the cell's own size."""

import ast
import json

import pytest
import torch

from perfbench import run, skid_steer_counts
from perfbench.control import fault_readings, readings
from perfbench.harness import ROOT, load_cell
from perfbench.tiny import tiny_cell

CELL = "skid_steer.sweep"


def test_the_cell_is_found_by_its_names():
    """Configuration, traffic, runner, reference, limits and counts, each
    by the name `BENCHMARK.json` gives."""
    cell = load_cell(CELL)
    assert cell.config["task"] == "skid_steer"
    assert cell.config["case"] == "dust"
    assert cell.config_entry["file"] == "perfbench/configs/skid_steer.json"
    assert cell.traffic["kind"] == "sweep"
    assert list(cell.traffic["true_params"]) == [
        "x_icr", "wheel_radius", "axial_distance"]
    assert cell.runner.__module__ == "perfbench.runners.skid_steer_sweep"
    ref = cell.reference
    for name in ("sweep_inputs", "sweep_reference", "simulate",
                 "state_cost", "mpf_chain"):
        assert callable(getattr(ref, name))
    assert set(cell.limits) == {"pos", "th", "speed", "action", "cost",
                                "bw_sv", "sim_state", "sim_cost", "sim_done",
                                "chain_mpf_x"}
    assert {m["name"] for m in cell.per_layer} >= {
        "sweep_roofline", "mfu_pct", "step_rollout_us", "step_mpf_us",
        "rollout_ns_per_traj_step", "mpf_ns_per_pair_iter",
        "rollout_fast_pct", "mpf_reg_loop_pct"}


def test_reference_imports_nothing_of_the_program_and_no_tf32():
    src = (ROOT / "perfbench" / "reference" / "skid_steer.py").read_text()
    names, relative = set(), set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                names.add(node.module.split(".")[0])
            else:
                relative.add(node.module)
    assert names <= {"__future__", "math", "numpy", "torch"}, names
    # the references' own shared pieces, nothing else
    assert relative <= {"_common"}, relative
    from perfbench.reference import skid_steer  # noqa: F401

    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_frozen_counts_at_the_cells_shapes():
    """The counts as they stand at the cell's shapes: they count the
    algorithm's work and move with no change of the program."""
    cfg = json.loads((ROOT / "perfbench" / "configs" / "skid_steer.json")
                     .read_text())["config"]
    exp, env = cfg["exp_params"], cfg["env_params"]
    assert skid_steer_counts.skid_steer_step_ops() == (75, 37)
    assert skid_steer_counts.skid_steer_solve_ops(4, 6, 64, 40) == 4965504
    assert skid_steer_counts.skid_steer_mpf_ops(50, 20) == 1832000
    assert skid_steer_counts.skid_steer_work(exp, env, 200, 51200, 256) == (
        447265382400, 7316480)


def _judged(cell, control=False, seed=2024):
    runner = cell.runner(cell, seed, "cpu")
    runner.plan_samples(0.2, runner.warm_up())
    win = runner.window(0.2)
    correct, rows = run.judge(cell, runner.check(control=control))
    return correct and win.failed == 0, rows


def test_sound_run_is_correct():
    correct, rows = _judged(tiny_cell(CELL))
    assert correct, rows


def test_control_is_not_correct():
    """The reference in bfloat16 in the program's place fails the
    limits."""
    correct, rows = _judged(tiny_cell(CELL), control=True)
    assert not correct, rows


@pytest.mark.parametrize("fault", ["state_unchanged", "x_icr_gradient_zero",
                                   "half_batch", "answer_altered"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    """The MPF step returning its particles unchanged, the likelihood
    gradient's x_icr component zeroed (the posterior then learns nothing of
    the load), half of the batch left out, an answer altered where it is
    produced."""
    from dust_tpu_torch.ops import skid_steer_episode

    plain = skid_steer_episode.episode_plain
    lik_grad = skid_steer_episode.lik_grad

    def zeroed(*args, **kwargs):
        lik = lik_grad(*args, **kwargs)

        def without_x_icr(*x):
            g = lik(*x)
            return (torch.zeros_like(g[0]), *g[1:])

        return without_x_icr

    def broken(inputs, st):
        if fault == "state_unchanged":
            return plain(inputs, dict(st, mpf_steps=0))
        out = list(plain(inputs, st))
        log = out[0].clone()
        if fault == "half_batch":
            b = log.shape[0] // 2
            log[b:] = log[:b].mean(dim=0, keepdim=True)
        else:
            log[:, -1, 1] += 1e-2          # the last step's y
        out[0] = log
        return tuple(out)

    if fault == "x_icr_gradient_zero":
        monkeypatch.setattr(skid_steer_episode, "lik_grad", zeroed)
    else:
        monkeypatch.setattr(skid_steer_episode, "episode_plain", broken)
    correct, rows = _judged(tiny_cell(CELL))
    assert not correct, rows


def test_the_frozen_mpf_fault_of_control_py_is_not_correct():
    """control.py's `--fault state_unchanged` (the adapter built with
    mpf_steps = 0) at the tiny size."""
    r = fault_readings(tiny_cell(CELL), 2025, 0.2, "cpu")
    assert not r["correct"], r["program"]


# -- on the card ------------------------------------------------------------------


@pytest.mark.card
def test_control_on_the_card_at_the_cells_size(card):
    """Three seeds at the cell's own size: every sound run within the
    limits, the control outside them."""
    for seed in (101, 102, 103):
        cell = load_cell(CELL)
        r = readings(cell, seed, 2.0, card)
        ok, rows = run.judge(cell, r["program"])
        assert ok, json.dumps(rows)
        ok, rows = run.judge(cell, r["control"])
        assert not ok, json.dumps(rows)
        torch.cuda.empty_cache()


@pytest.mark.card
def test_frozen_mpf_on_the_card_at_the_cells_size(card):
    """The kernel's MPF step planted to leave its particles unchanged, at
    the cell's own size: not correct."""
    r = fault_readings(load_cell(CELL), 104, 2.0, card)
    assert not r["correct"], json.dumps(r["program"])
