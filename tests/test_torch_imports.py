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
                 "simulation", "experiments", "inference.mpf"):
        assert f"dust_tpu_torch.{name}" in _modules()


def test_sources_name_no_jax_or_dust_tpu():
    pattern = re.compile(r"import jax|from jax|dust_tpu\.|from dust_tpu ")
    offenders = []
    for path in sorted(PKG_DIR.rglob("*.py")):
        for i, line in enumerate(path.read_text().splitlines(), 1):
            code = line.split("#")[0]
            if pattern.search(code):
                offenders.append(f"{path.relative_to(REPO)}:{i}: {line}")
    assert not offenders, "\n".join(offenders)

