"""The check catches what it is there to catch: the lower-precision
control, and a run with the timed path broken underneath (a step that
returns its state unchanged, half of the batch left out, an answer
altered where it is produced), each at a size the CPU holds, with the
committed limits. Two tests, marked `card`, read the control and the
frozen MPF on the card at each cell's own size."""

import json

import pytest
import torch

from perfbench import run
from perfbench.control import fault_readings, readings
from perfbench.harness import load_cell
from perfbench.tiny import tiny_cell

CELLS = ["pendulum.sweep", "particle.sweep"]


def _judged(cell, control=False):
    runner = cell.runner(cell, 2024, "cpu")
    runner.plan_samples(0.2, runner.warm_up())
    win = runner.window(0.2)
    correct, rows = run.judge(cell, runner.check(control=control))
    return correct and win.failed == 0, rows


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    """The reference in bfloat16 in the program's place fails the
    limits."""
    correct, rows = _judged(tiny_cell(workload), control=True)
    assert not correct, rows


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    correct, rows = _judged(tiny_cell(workload))
    assert correct, rows


# -- faults planted in the program --------------------------------------------


def _sweep_fault(monkeypatch, fault, task):
    from dust_tpu_torch.ops import episode, particle_episode

    module = episode if task == "pendulum" else particle_episode
    plain = module.episode_plain

    def broken(inputs, st):
        if fault == "state_unchanged":
            # the MPF step returns its particles unchanged
            return plain(inputs, dict(st, mpf_steps=0))
        out = list(plain(inputs, st))
        log = out[0].clone()
        if fault == "half_batch":
            b = log.shape[0] // 2
            log[b:] = log[:b].mean(dim=0, keepdim=True)
        else:
            log[:, -1, 0] += 1e-2          # the last step's first field
        out[0] = log
        return tuple(out)
    monkeypatch.setattr(module, "episode_plain", broken)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    cell = tiny_cell(workload)
    _sweep_fault(monkeypatch, fault, cell.config["task"])
    correct, rows = _judged(cell)
    assert not correct, rows


# -- on the card ------------------------------------------------------------------


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_on_the_card_at_the_cells_size(card, workload):
    """Three seeds at the cell's own size: every sound run within the
    limits, the control outside them."""
    for seed in (101, 102, 103):
        cell = load_cell(workload)
        r = readings(cell, seed, 2.0, card)
        ok, rows = run.judge(cell, r["program"])
        assert ok, json.dumps(rows)
        ok, rows = run.judge(cell, r["control"])
        assert not ok, json.dumps(rows)
        torch.cuda.empty_cache()


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_frozen_mpf_on_the_card_at_the_cells_size(card, workload):
    """The kernel's MPF step planted to leave its particles unchanged, at
    the cell's own size: not correct."""
    r = fault_readings(load_cell(workload), 104, 2.0, card)
    assert not r["correct"], json.dumps(r["program"])
