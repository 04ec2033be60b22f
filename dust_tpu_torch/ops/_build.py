"""Build and load the port's CUDA kernels.

`load_library()` compiles `dust_tpu_torch/csrc/*.cu` for Hopper
(`sm_90a`) with `nvcc` at first use — one `nvcc -c` per source, all
started together, then one link — into
`dust_tpu_torch/_build/libdust_tpu_torch.so`, and loads it with `ctypes`.
The library is rebuilt when a source is newer than it. Each C entry point
launches on the stream it is given and returns `cudaGetLastError()`.

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
]

_VOID_P = ctypes.c_void_p
_INT = ctypes.c_int
_FLOAT = ctypes.c_float

# C signatures: name -> argtypes (every pointer and the stream as void*)
_SIGNATURES = {
    "dust_pendulum_rollout_costs": [
        _VOID_P, _VOID_P, _VOID_P, _VOID_P, _VOID_P,   # state0 actions lengths masses costs
        _INT, _INT, _INT,                              # n_params n_traj hz
        _FLOAT, _FLOAT, _FLOAT,                        # c_grav c_act dt
        _VOID_P,                                       # stream
    ],
    "dust_pendulum_mpf_optimize": [
        _VOID_P, _VOID_P, _VOID_P, _VOID_P,            # x centers scal x_out
        _INT, _INT,                                    # m n_steps
        _FLOAT, _FLOAT, _INT,                          # dt half3g log_space
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
    return any(src.stat().st_mtime > built for src in _sources())


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
