"""Import hygiene of the port: `dust_tpu_torch` imports `torch` and
`numpy`, never JAX and nothing of `dust_tpu`, and builds nothing at
import."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import dust_tpu_torch

PKG_DIR = Path(dust_tpu_torch.__file__).resolve().parent
REPO = PKG_DIR.parent

_CHECK = """
import importlib, pkgutil, sys
import dust_tpu_torch
for mod in pkgutil.walk_packages(dust_tpu_torch.__path__, "dust_tpu_torch."):
    importlib.import_module(mod.name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "dust_tpu", "triton"))
print("BAD", bad)
from dust_tpu_torch.ops import _build
print("LOADED", _build.load_library.cache_info().currsize)
"""


def _modules():
    return [m.name for m in pkgutil.walk_packages(dust_tpu_torch.__path__,
                                                  "dust_tpu_torch.")]


def test_package_imports_without_jax_or_dust_tpu():
    res = subprocess.run([sys.executable, "-c", _CHECK], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout
    # importing built and loaded no kernel library
    assert "LOADED 0" in res.stdout, res.stdout
    # every module of the slice was imported
    for name in ("ops.rollout", "ops.mpf", "ops._build", "convert",
                 "simulation", "experiments", "inference.mpf",
                 "inference.svmpc", "ops.solve", "ops.episode",
                 "ops.episode_kernel", "ops.sweep_inputs",
                 "ops.sweep_episode", "parallel", "parallel.sweep",
                 "models.obstacle_map", "models.particle",
                 "ops.particle_rollout", "ops.particle_mpf",
                 "ops.particle_episode", "ops.particle_sweep_episode",
                 "ops.cartpole_episode", "ops.cartpole_sweep_episode",
                 "ops.skid_steer_episode", "ops.skid_steer_sweep_episode",
                 "ops.svgd", "ops.gmm", "ops.mpf_stream",
                 "ops.stream_split", "utils", "utils.utf",
                 "controllers.amppi", "controllers.base", "models.cartpole",
                 "models.skid_steer", "inference.svgd", "inference.optim",
                 "parallel.mesh",
                 "parallel.stein", "parallel.rollout",
                 "parallel.svmpc_sharded", "tuning", "utils.helper",
                 "utils.profiling", "utils.plots", "utils.plots_html",
                 "demo", "demo.pendulum_example", "demo.particle_example",
                 "demo.sweep_example", "demo.pendulum_tuning",
                 "demo.particle_tuning"):
        assert f"dust_tpu_torch.{name}" in _modules()


def test_every_c_entry_has_a_signature_and_a_source():
    """Each C entry the wrappers call is declared in `_SIGNATURES` and
    defined in exactly one `csrc/*.cu` file."""
    from dust_tpu_torch.ops import _build

    sources = {p.name: p.read_text() for p in _build.SRC_DIR.glob("*.cu")}
    for name in _build._SIGNATURES:
        defined = [f for f, text in sources.items()
                   if re.search(rf'extern "C" [\w\s*]*\b{name}\(', text)]
        assert len(defined) == 1, (name, defined)
    for name in ("particle_rollout.cu", "particle_mpf.cu", "particle_solve.cu",
                 "particle_episode.cu", "svgd_phi.cu", "gmm_score.cu",
                 "mpf_stream.cu", "skid_steer_episode.cu"):
        assert name in sources
    calls = set()
    for path in sorted(PKG_DIR.rglob("*.py")):
        calls |= set(re.findall(r"load_library\(\)\.(\w+)\(",
                                path.read_text()))
        # the whole-episode kernels' entries (`ops/episode_kernel.py:
        # EpisodeKernel`)
        calls |= set(re.findall(r'entry="(\w+)"', path.read_text()))
    assert calls <= set(_build._SIGNATURES), calls - set(_build._SIGNATURES)
    assert {"dust_particle_rollout_costs", "dust_particle_mpf_optimize",
            "dust_particle_solve", "dust_particle_episodes", "dust_svgd_phi",
            "dust_gmm_score", "dust_mpf_stream_step",
            "dust_pendulum_episodes", "dust_cartpole_episodes",
            "dust_skid_steer_episodes"} <= calls


def test_signatures_match_the_c_entries():
    """Each `_SIGNATURES` entry has as many arguments as its C entry
    point (ctypes would pass a missing pointer as garbage)."""
    from dust_tpu_torch.ops import _build

    text = "\n".join(p.read_text() for p in _build.SRC_DIR.glob("*.cu"))
    for name, argtypes in _build._SIGNATURES.items():
        decl = re.search(rf'extern "C" [\w\s*]*\b{name}\(([^)]*)\)', text)
        assert decl is not None, name
        assert len(decl.group(1).split(",")) == len(argtypes), name


def test_sources_name_no_jax_or_dust_tpu():
    pattern = re.compile(r"import jax|from jax|dust_tpu\.|from dust_tpu ")
    offenders = []
    for path in sorted(PKG_DIR.rglob("*.py")):
        for i, line in enumerate(path.read_text().splitlines(), 1):
            code = line.split("#")[0]
            if pattern.search(code):
                offenders.append(f"{path.relative_to(REPO)}:{i}: {line}")
    assert not offenders, "\n".join(offenders)

