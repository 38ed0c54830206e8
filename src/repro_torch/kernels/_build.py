"""Build and load the port's CUDA kernels: nvcc into shared libraries with a
plain C interface, loaded with ctypes.

Each ``csrc/*.cu`` file becomes its own library,
``build/repro_torch_kernels/lib<name>-<hash>.so`` under the repository
root, where the hash covers the source and the compiler flags. The first
call that needs a kernel builds what is missing, one nvcc process per
source, all started together; later calls, and later processes, load what
is there. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("screen", "cm_burst", "chain_suffix", "cm_epochs", "gram_sweep",
           "cm_wide", "group_bcd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# argument types of every exported function, by name with "{dt}" standing
# for "f32" or "f64" (a name without it is float32 only); None is the float
# scalar of that type
_CM = [_P, _P, _P, _P, _P, _P, None, _I, _I, _I, _I, _P, _P, _P, _P]
_CM_PEN = _CM[:6] + [_P] + _CM[6:]
_CM_BATCH = [_P] * 9 + [_I, _I, _I, _P, _P, _P, _P]
_WIDE = [_P] * 9 + [None, _I, _I, _I, _I, _P]
_GROUP = [_P] * 5 + [None, _I, _I, _I, _I, _P, _P]
# the scan: ..., masked, the ub guard (a float of the sums' type), outputs
_SCREEN = [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, None, _P, _P, _P, _P,
           _P, _P, _P]
_SIGNATURES = {
    "screen": {
        "screen_fused_{dt}": _SCREEN,
        "screen_fused_batch_{dt}": _SCREEN,
        # the bf16 mode's tensor-core scan: X, ldx, Theta, ldt, then the
        # scan's arguments from col_norm on (float32)
        "screen_fused_tc": [_P, _I, _P, _I] + _SCREEN[2:],
        "ub_histogram_{dt}": [_P, _P, _I, _I, _I, _P, _P],
        "screen_tail_{dt}": [_P, _P, _P, _I, _P, _P, _I, _P, _I, _I, _I, _I,
                             _P, _P, _P, _P, _P],
        "empty_launch": [_P],
    },
    "cm_burst": {
        "cm_burst_ls_{dt}": _CM,
        "cm_burst_logit_{dt}": _CM,
        "cm_burst_ls_{dt}_pen": _CM_PEN,
        "cm_burst_logit_{dt}_pen": _CM_PEN,
        "cm_burst_batch_ls_{dt}": _CM_BATCH,
        "cm_burst_batch_logit_{dt}": _CM_BATCH,
    },
    "cm_epochs": {      # float32 only, the TPU kernel's type
        "cm_epochs_f32": [_P, _P, _P, _P, _P, None, _I, _I, _I, _P, _P],
    },
    "gram_sweep": {
        "gram_sweep_{dt}": [_P] * 7 + [_I, _I, _P, _P, None, _I, _I, _P],
    },
    "cm_wide": {
        "cm_sweep_wide_ls_{dt}": _WIDE,
        "cm_sweep_wide_logit_{dt}": _WIDE,
    },
    "group_bcd": {      # A, y, slot, beta, L, lam, n_epochs, n, live,
        # gsize, z; the chunked and the register form
        "group_bcd_ls_{dt}": _GROUP,
        "group_bcd_logit_{dt}": _GROUP,
        "group_bcd_reg_ls_{dt}": _GROUP,
        "group_bcd_reg_logit_{dt}": _GROUP,
    },
    "chain_suffix": {
        "chain_suffix_sums_{dt}": [_P, _P, _I, _I, _P],
        "add_latency_{dt}": [_I, _P, _P],
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """A kernel library could not be built (no nvcc, or nvcc refused a
    source). Not transient: the serving runtime passes it up unretried and
    never answers it by switching to the plain path."""


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise KernelBuildError(
            "nvcc not found: the CUDA kernels are built on the machine with "
            "the card (CUDA toolkit needed)")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> float:
    """Compile every missing library among ``names`` in parallel; returns
    the seconds spent (0.0 when everything was built already)."""
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    compiler = nvcc()
    jobs = []
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [compiler, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        jobs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for name, tmp, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed on {name}.cu:\n{out.decode()}")
        else:
            os.replace(tmp, _lib_path(name))
    if errors:
        raise KernelBuildError("\n".join(errors))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build((name,))
    lib = ctypes.CDLL(str(_lib_path(name)))
    for pattern, args in _SIGNATURES[name].items():
        types = (("f32", ctypes.c_float), ("f64", ctypes.c_double))
        for dt, ftype in types if "{dt}" in pattern else types[:1]:
            fn = getattr(lib, pattern.format(dt=dt))
            fn.argtypes = [ftype if a is None else a for a in args]
            fn.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t from a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
