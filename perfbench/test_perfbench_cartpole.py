"""The `cartpole.sweep` cell's files found by name, its reference's
imports, its frozen counts, and its check: the bfloat16 control and faults
planted in the timed path fail it at a size the CPU holds, and, marked
`card`, the control and the frozen MPF fail it at the cell's own size."""

import ast
import json

import pytest
import torch

from perfbench import cartpole_counts, run
from perfbench.control import fault_readings, readings
from perfbench.harness import ROOT, load_cell
from perfbench.tiny import tiny_cell

CELL = "cartpole.sweep"


def test_the_cell_is_found_by_its_names():
    """Configuration, traffic, runner, reference, limits and counts, each
    by the name `BENCHMARK.json` gives."""
    cell = load_cell(CELL)
    assert cell.config["task"] == "cartpole" and cell.config["case"] == "dust"
    assert cell.config_entry["file"] == "perfbench/configs/cartpole.json"
    assert cell.traffic["kind"] == "sweep"
    assert set(cell.traffic["true_params"]) == {"length", "mass_pole"}
    assert cell.runner.__module__ == "perfbench.runners.cartpole_sweep"
    ref = cell.reference
    for name in ("sweep_inputs", "sweep_reference", "simulate", "mpf_chain"):
        assert callable(getattr(ref, name))
    fields = set(ref.LOG_FIELDS)
    assert set(cell.limits) == fields | {"sim_state", "sim_cost",
                                         "chain_bw_mpf", "chain_mpf_x"}
    assert {m["name"] for m in cell.per_layer} >= {
        "sweep_roofline", "step_rollout_us", "step_mpf_us",
        "rollout_ns_per_traj_step"}


def test_reference_imports_nothing_of_the_program_and_no_tf32():
    src = (ROOT / "perfbench" / "reference" / "cartpole.py").read_text()
    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "math", "torch"}, names
    from perfbench.reference import cartpole  # noqa: F401

    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_frozen_counts_at_the_cells_shapes():
    """The counts as they stand at the cell's shapes: they count the
    algorithm's work and move with no change of the program."""
    exp = json.loads((ROOT / "perfbench" / "configs" / "cartpole.json")
                     .read_text())["config"]["exp_params"]
    assert cartpole_counts.rollout_ops(8, 3, 128, 30) == 4637952
    assert cartpole_counts.mpf_ops(50, 20) == 1717015
    assert cartpole_counts.step_ops(8, 3, 128, 30, 50, 20) == 7008203
    assert cartpole_counts.cartpole_work(exp, 200, 256) == (358819993600,
                                                            2415616)


def _judged(cell, control=False, seed=2024):
    runner = cell.runner(cell, seed, "cpu")
    runner.plan_samples(0.2, runner.warm_up())
    win = runner.window(0.2)
    correct, rows = run.judge(cell, runner.check(control=control))
    return correct and win.failed == 0, rows


def _tiny():
    """The tiny cell with the tip load inside its 12 steps."""
    cell = tiny_cell(CELL)
    cell.config["config"]["exp_params"]["load_step"] = 6
    return cell


def test_sound_run_is_correct():
    correct, rows = _judged(_tiny())
    assert correct, rows


def test_control_is_not_correct():
    """The reference in bfloat16 in the program's place fails the
    limits."""
    correct, rows = _judged(_tiny(), control=True)
    assert not correct, rows


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    """The MPF step returning its particles unchanged, half of the batch
    left out, an answer altered where it is produced."""
    from dust_tpu_torch.ops import cartpole_episode

    plain = cartpole_episode.episode_plain

    def broken(inputs, st):
        if fault == "state_unchanged":
            return plain(inputs, dict(st, mpf_steps=0))
        out = list(plain(inputs, st))
        log = out[0].clone()
        if fault == "half_batch":
            b = log.shape[0] // 2
            log[b:] = log[:b].mean(dim=0, keepdim=True)
        else:
            log[:, -1, 0] += 1e-2          # the last step's cart position
        out[0] = log
        return tuple(out)

    monkeypatch.setattr(cartpole_episode, "episode_plain", broken)
    correct, rows = _judged(_tiny())
    assert not correct, rows


def test_the_frozen_mpf_fault_of_control_py_is_not_correct():
    """control.py's `--fault state_unchanged` (the adapter built with
    mpf_steps = 0) at the tiny size."""
    r = fault_readings(_tiny(), 2025, 0.2, "cpu")
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
