"""The plain references against the port's plain paths at a size the CPU
holds, the frozen operation counts, and the references' imports."""

import ast
import json

import pytest
import torch

from perfbench import common, counts
from perfbench.harness import ROOT, load_cell
from perfbench.tiny import tiny_cell

REFERENCE = ROOT / "perfbench" / "reference"


def _config(name):
    return json.loads((ROOT / "perfbench" / "configs"
                       / f"{name}.json").read_text())["config"]


def test_frozen_counts_at_the_cells_shapes():
    """The counts as they stand at the three cells' shapes: they count the
    algorithm's work and move with no change of the program."""
    pend = _config("pendulum")["exp_params"]
    part = _config("particle")
    assert counts.pendulum_work(pend, 1) == (5320440, 3052)
    assert counts.pendulum_work(pend, 200, 256) == (272406528000, 2003968)
    assert counts.solve_ops(8, 3, 128, 30) == 3272508
    assert counts.episode_ops(200, 8, 3, 128, 30, 50, 20) == 1064088000
    assert counts.particle_model_floats(part["env_params"]) == 1539
    assert counts.particle_solve_ops(4, 6, 64, 40) == 4228224
    assert counts.particle_mpf_ops(50, 20) == 1144000
    assert counts.particle_work(part["exp_params"], part["env_params"], 200,
                                256 * 200, 256) == (374266265600,
                                                          7198720)
    assert counts.particle_work(part["exp_params"], part["env_params"], 200,
                                256 * 100, 256)[0] == 344979865600
    t, bound = counts.least_seconds(2003968, 272406528000)
    assert bound == "operations" and t == pytest.approx(4.0657e-3, rel=1e-4)


@pytest.mark.parametrize("workload", ["pendulum.sweep", "particle.sweep"])
def test_reference_equals_the_ports_plain_path(workload):
    """On the CPU the program runs its plain versions; the references
    repeat their arithmetic, so every gap is zero to rounding."""
    cell = tiny_cell(workload)
    runner = cell.runner(cell, 12345, "cpu")
    runner.plan_samples(0.2, runner.warm_up())
    runner.window(0.2)
    gaps = runner.check()
    assert gaps and all(v <= 1e-6 for v in gaps.values()), gaps


def test_particle_map_equals_the_programs():
    """The reference rasterises the config's obstacle map itself; its
    rectangles and grid are the program's."""
    from dust_tpu_torch.experiments import assemble_particle_stack
    from dust_tpu_torch.ops.particle_rollout import particle_kernel_statics
    from perfbench.reference import particle

    cfg = _config("particle")
    gen = torch.Generator().manual_seed(0)
    flat = dict(cfg, dynamics_prior={"kind": "normal"})
    arrays = common.draw_arrays(flat, gen, torch.device("cpu"))
    stack = assemble_particle_stack(
        cfg, common.program_arrays(flat, arrays), device="cpu")
    want = particle_kernel_statics(stack.model)
    got = particle.statics(cfg)
    assert sorted(got["rects"]) == sorted(want["rects"])
    assert got["grid"] == pytest.approx(want["grid"])
    assert got["weights"] == pytest.approx(want["weights"])
    assert got["target"] == pytest.approx(want["target"])


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield ("." * node.level) + (node.module or "")


@pytest.mark.parametrize("path", sorted(REFERENCE.glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    for name in _imports(path):
        assert name.split(".")[0] in ("", "__future__", "math", "numpy",
                                      "torch", "_common"), name
        assert not name.startswith(("dust_tpu", "jax")), name


def test_every_configuration_has_its_reference():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cell = load_cell(next(w["name"] for w in bench["workloads"]
                              if w["config"] == c["name"]))
        assert hasattr(cell.reference, "LOG_FIELDS")


def test_mpf_chain_follows_the_references_own_episodes():
    """The pendulum's MPF alone, driven by the reference's own logged
    episodes, reads every step's bandwidth as those episodes logged it:
    the chain and the sweep share one update. (Both chains are held to
    the port's plain path in the test above.)"""
    cell = tiny_cell("pendulum.sweep")
    runner = cell.runner(cell, 777, "cpu")
    logs, _ = runner.reference_run(runner.seeds(0), 8, torch.float64)
    bw, x = cell.reference.mpf_chain(runner.exp, runner.arrays, logs,
                                     dtype=torch.float64)
    assert torch.equal(bw, logs["bw_mpf"])
    assert x.shape == (runner.B, 8, 2) and torch.isfinite(x).all()
