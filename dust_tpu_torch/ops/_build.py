"""Build and load the port's CUDA kernels.

`load_library()` compiles `dust_tpu_torch/csrc/*.cu` (which include the
shared device code in `csrc/*.cuh`) for Hopper (`sm_90a`) with `nvcc` at
first use — one `nvcc -c` per source, all started together, then one
link — into `dust_tpu_torch/_build/libdust_tpu_torch.so`, and loads it
with `ctypes`. The library is rebuilt when a source or header is newer
than it. Each C entry point launches on the stream it is given and
returns `cudaGetLastError()`.

Importing this module builds nothing; only the wrappers' CUDA branches
call `load_library()`.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

from . import stream_split

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_PATH = BUILD_DIR / "libdust_tpu_torch.so"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # no fused multiply-add contraction: the kernels then round every
    # operation as their plain PyTorch versions do
    "--fmad=false",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
    # the column split of K12/K13 (ops/stream_split.py)
    *stream_split.nvcc_defines(),
]

_VOID_P = ctypes.c_void_p
_INT = ctypes.c_int
_LONG = ctypes.c_longlong
_FLOAT = ctypes.c_float

# K4 and K5 share one entry (csrc/pendulum_episode.cu)
_EPISODE_ARGS = (
    [_VOID_P] * 17                # scal ep_f ep_i theta0 locs0 amat0 aseq mpfx0
                                  # eps pdz pdu log theta locs amat mpfx
                                  # clock (null but inside episode.phase_clock)
    + [_INT] * 9                  # B steps warm_up hz m n_params n_act m_mpf mpf_steps
    + [_FLOAT] * 7                # dt xmax cg ca half3g gs log_n_act
    + [_INT] * 3                  # exp_util log_space fixed_bw
    + [_FLOAT] * 2                # mpf_fixed_bw mpf_bw_scale
    + [_INT, _VOID_P]             # host_noise stream
)

_PENDULUM_ROLLOUT_ARGS = [
    _VOID_P, _VOID_P,                              # state0 actions
    _VOID_P, _LONG, _FLOAT,                        # lengths: ptr stride value
    _VOID_P, _LONG, _FLOAT,                        # masses: ptr stride value
    _VOID_P, _VOID_P,                              # costs cost_mean
    _INT, _INT, _INT,                              # n_params n_traj hz
    _FLOAT, _FLOAT, _FLOAT,                        # c_grav c_act dt
]

_PENDULUM_MPF_ARGS = [
    _VOID_P, _VOID_P, _VOID_P, _VOID_P,            # x centers scal x_out
    _INT, _INT,                                    # m n_steps
    _FLOAT, _FLOAT, _INT,                          # dt half3g log_space
]

_PARTICLE_ROLLOUT_ARGS = [
    _VOID_P, _INT,                                 # model n_model
    _VOID_P, _VOID_P, _VOID_P, _VOID_P,            # state0 acts masses costs
    _INT, _INT, _INT,                              # n_params n_traj hz
]

_PARTICLE_MPF_ARGS = [
    _VOID_P, _VOID_P,                              # x centers
    _VOID_P, _VOID_P,                              # scal_ptrs scal_vals (host arrays)
    _VOID_P,                                       # x_out
    _INT, _INT,                                    # m n_steps
    _FLOAT, _FLOAT, _INT,                          # max_acc max_speed log_space
]

_PENDULUM_SOLVE_ARGS = (
    [_VOID_P] * 9                 # scal theta locs log_mix amat aseq actions lengths masses
    + [_VOID_P] * 7               # theta_opt theta_fwd amat_out a_mix aseq_sel weights costs
    + [_INT] * 4                  # hz m n_params n_act
    + [_FLOAT] * 5                # dt xmax cg ca log_n_act
    + [_INT]                      # exp_util
)

_PARTICLE_SOLVE_ARGS = (
    [_VOID_P] * 9                 # model scal theta locs log_mix amat aseq actions masses
    + [_VOID_P] * 7               # theta_opt theta_fwd amat_out a_mix aseq_sel weights costs
    + [_INT] * 4                  # hz m n_params n_act
    + [_FLOAT, _INT]              # log_n_act exp_util
)

# C signatures: name -> argtypes (every pointer and the stream as void*)
_SIGNATURES = {
    "dust_pendulum_rollout_costs": _PENDULUM_ROLLOUT_ARGS + [_VOID_P],  # stream
    # the clocked build (inside rollout.phase_clock)
    "dust_pendulum_rollout_costs_clock": _PENDULUM_ROLLOUT_ARGS + [_VOID_P, _VOID_P],  # clock stream
    "dust_pendulum_mpf_optimize": _PENDULUM_MPF_ARGS + [_VOID_P],  # stream
    # the clocked build (inside mpf.phase_clock)
    "dust_pendulum_mpf_optimize_clock": _PENDULUM_MPF_ARGS + [_VOID_P, _VOID_P],  # clock stream
    "dust_pendulum_solve": _PENDULUM_SOLVE_ARGS + [_VOID_P],  # stream
    # the clocked build (inside solve.pendulum_phase_clock)
    "dust_pendulum_solve_clock": _PENDULUM_SOLVE_ARGS + [_VOID_P, _VOID_P],  # clock stream
    "dust_pendulum_episodes": _EPISODE_ARGS,
    "dust_particle_rollout_costs": _PARTICLE_ROLLOUT_ARGS + [_VOID_P],  # stream
    # the clocked build (inside particle_rollout.phase_clock)
    "dust_particle_rollout_costs_clock": _PARTICLE_ROLLOUT_ARGS + [_VOID_P, _VOID_P],  # clock stream
    "dust_particle_occupancy": [
        _VOID_P, _VOID_P, _VOID_P, _INT, _VOID_P,      # model pts out n stream
    ],
    "dust_particle_mpf_optimize": _PARTICLE_MPF_ARGS + [_VOID_P],  # stream
    # the clocked build (inside particle_mpf.phase_clock)
    "dust_particle_mpf_optimize_clock": _PARTICLE_MPF_ARGS + [_VOID_P, _VOID_P],  # clock stream
    "dust_particle_solve": _PARTICLE_SOLVE_ARGS + [_VOID_P],  # stream
    # the clocked build (inside solve.phase_clock)
    "dust_particle_solve_clock": _PARTICLE_SOLVE_ARGS + [_VOID_P, _VOID_P],  # clock stream
    "dust_particle_episodes": (
        [_VOID_P] * 20                # model scal base_mass ep_i logmix0 theta0 locs0
                                      # amat0 aseq mpfx0 eps pdz pdu log theta locs amat mpfx
                                      # logmix (null on the K9 path) clock (null but
                                      # inside particle_episode.phase_clock)
        + [_INT] * 10                 # B steps warm_up hz m n_params n_act m_mpf
                                      # mpf_steps change_at
        + [_FLOAT] * 2                # success_dist2 log_n_act
        + [_INT] * 4                  # exp_util weighted_prior log_space fixed_bw
        + [_FLOAT, _INT, _VOID_P]     # mpf_bw_scale host_noise stream
    ),
    "dust_svgd_phi": [
        _VOID_P, _VOID_P, _VOID_P, _VOID_P,            # x score bw phi
        _INT, _INT, _INT,                              # m d bf16
        _VOID_P,                                       # stream
    ],
    "dust_gmm_score": [
        _VOID_P, _VOID_P, _VOID_P, _VOID_P,            # x centers bw out
        _INT, _INT, _INT, _INT,                        # m k d bf16
        _VOID_P,                                       # stream
    ],
    "dust_mpf_stream_step": [
        _VOID_P, _VOID_P, _VOID_P, _VOID_P,            # x score centers scal
        _VOID_P, _VOID_P,                              # x_new gp_new
        _INT, _INT,                                    # m d
        _VOID_P,                                       # stream
    ],
    "dust_cuda_error_string": [_INT],
}


def find_nvcc() -> str:
    """`nvcc` from `CUDA_HOME`, else from `PATH`."""
    root = os.environ.get("CUDA_HOME")
    if root and (Path(root) / "bin" / "nvcc").exists():
        return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME or put the CUDA toolkit's bin/ on PATH"
    )


def _sources():
    return sorted(SRC_DIR.glob("*.cu"))


def is_stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    deps = _sources() + sorted(SRC_DIR.glob("*.cuh")) + [
        Path(stream_split.__file__)]
    return any(src.stat().st_mtime > built for src in deps)


def build() -> dict:
    """Compile the kernels if the library is missing or stale. Returns
    {"built": bool, "seconds": float, "log": compiler output (ptxas
    register/shared-memory report)}."""
    if not is_stale():
        return {"built": False, "seconds": 0.0, "log": ""}
    nvcc = find_nvcc()
    start = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    logs = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((src, obj, proc))
        failed = []
        for src, _, proc in jobs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(
                f"nvcc failed for {failed}:\n" + "\n".join(logs)
            )
        lib_tmp = Path(tmp) / LIB_PATH.name
        link = [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                "-o", str(lib_tmp), *(str(obj) for _, obj, _ in jobs)]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        os.replace(lib_tmp, LIB_PATH)
    return {"built": True, "seconds": time.perf_counter() - start,
            "log": "\n".join(logs)}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load the shared library once per process and
    declare every entry point's C signature."""
    build()
    lib = ctypes.CDLL(str(LIB_PATH))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_char_p if name == "dust_cuda_error_string" \
            else ctypes.c_int
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = load_library().dust_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
