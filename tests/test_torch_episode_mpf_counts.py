"""K9/K10's MPF loop and its launch counters, on the CPU.

* The register loop's lane and column constants
  (`csrc/particle_mpf.cuh:kRowLanes`, `kEpisodeRegCols`), read from the
  source text, are those of the Python rule that counts K9's and K10's
  launches (`ops/mpf.py:episode_register_loop`), and the whole-episode
  kernel takes its MPF update through `episode_mass_stein_loop`, which
  picks the register loop by that range.
* `run_episodes`' CUDA branch, driven with a stub library and stream,
  counts each K9 and K10 launch as a register-loop or a shared-walk launch
  by `m_mpf`, in the wrapper that launched it (the wrappers carry both
  counters from import: tests/test_perfbench_program_metrics.py)."""

import re
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from dust_tpu_torch.ops import _build, episode_kernel
from dust_tpu_torch.ops import mpf as tmpf
from dust_tpu_torch.ops import particle_episode as pe
from dust_tpu_torch.ops import particle_sweep_episode as pse

CSRC = Path(pe.__file__).resolve().parents[1] / "csrc"


def _flat(text):
    return " ".join(text.split())


def test_particle_register_range_is_the_kernels():
    """kRowLanes lanes a row, each holding kEpisodeRegCols columns or one
    fewer: 49-52 particles, the rule's range; one row per quad of the
    kernel's 256 threads reaches it."""
    src = (CSRC / "particle_mpf.cuh").read_text()
    cols = re.findall(r"constexpr int kEpisodeRegCols = (\d+);", src)
    lanes = re.findall(r"constexpr int kRowLanes = (\d+);", src)
    assert cols == [str(tmpf.EPISODE_REGISTER_COLS)]
    assert lanes == [str(tmpf.EPISODE_ROW_LANES)]
    assert (tmpf.EPISODE_REGISTER_MIN, tmpf.EPISODE_REGISTER_MAX) == (49, 52)
    assert tmpf.EPISODE_REGISTER_MAX * tmpf.EPISODE_ROW_LANES <= 256


def test_particle_kernel_picks_its_loop_by_the_range():
    """`episode_mass_stein_loop` takes the register loop (kEpisodeRegCols
    columns, the first kEpisodeRegCols - 1 every lane's) exactly where
    kRowLanes * (kEpisodeRegCols - 1) < m <= kRowLanes * kEpisodeRegCols,
    the shared walk otherwise, and K9/K10 call it and no other loop."""
    src = _flat((CSRC / "particle_mpf.cuh").read_text())
    reg = src[src.index("void episode_mass_stein_loop_reg("):]
    reg = reg[:reg.index("} ")]
    assert ("mass_stein_loop_reg<kRowLanes, kEpisodeRegCols, "
            "kEpisodeRegCols - 1>(") in reg
    body = src[src.index("__device__ inline void episode_mass_stein_loop("):]
    body = body[:body.index("} else {")]
    assert ("if (m > kRowLanes * (kEpisodeRegCols - 1) && m <= kRowLanes * "
            "kEpisodeRegCols) { episode_mass_stein_loop_reg(") in body
    kernel = _flat((CSRC / "particle_episode.cu").read_text())
    assert kernel.count("dp::episode_mass_stein_loop(") == 1
    assert "dp::mass_stein_loop(" not in kernel
    assert "mass_stein_loop_reg" not in kernel


def _stub_launches(monkeypatch, wrapper, kernel, m_mpf, n):
    """n launches of `kernel` through `run_episodes`' CUDA branch on a stub
    library (every entry returns 0), stream and argument list."""
    entries = []
    lib = SimpleNamespace(**{kernel.entry: lambda *a: entries.append(a) or 0})
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(episode_kernel, "launch_args",
                        lambda *a, **k: ((), [], ()))
    monkeypatch.setattr(wrapper, "launches", 0)
    monkeypatch.setattr(wrapper, "mpf_reg_launches", 0)
    monkeypatch.setattr(wrapper, "mpf_smem_launches", 0)
    inputs = {"theta0": SimpleNamespace(device=torch.device("cuda"),
                                        shape=(4,)), "ep_i": None}
    for _ in range(n):
        episode_kernel.run_episodes(wrapper, inputs, {"m_mpf": m_mpf},
                                    kernel)
    assert len(entries) == n


@pytest.mark.parametrize("m_mpf,register", [
    (49, True), (50, True), (52, True),
    (1, False), (48, False), (53, False), (64, False)])
@pytest.mark.parametrize("wrapper,kernel", [
    (pe.fused_particle_episode, pe.K9),
    (pse.fused_particle_sweep_episode, pe.K10)], ids=["K9", "K10"])
def test_particle_launches_count_their_loop(monkeypatch, wrapper, kernel,
                                            m_mpf, register):
    """At 49-52 MPF particles (the demo's 50) every launch is a
    register-loop launch; at every other count a shared-walk launch."""
    _stub_launches(monkeypatch, wrapper, kernel, m_mpf, 3)
    assert wrapper.launches == 3
    assert (wrapper.mpf_reg_launches, wrapper.mpf_smem_launches) == (
        (3, 0) if register else (0, 3))
