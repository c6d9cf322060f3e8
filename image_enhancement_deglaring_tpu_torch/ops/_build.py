"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, compiled for Hopper (``sm_90a``) on first use into
``build/torch_kernels/`` at the root of the checkout. A library's file
name carries a digest of every source under ``csrc/`` and of the compiler
flags, so an edited source is rebuilt and an unchanged one is reused.
Nothing is compiled when a module is imported: the first CUDA launch, or
an explicit :func:`build`, does it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("gn_silu", "conv_gn_silu", "dec1_output", "batch_norm", "layer_norm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L, _D = ctypes.c_longlong, ctypes.c_double
_GN_ARGS = [_P] * 6 + [_I] * 11 + [_F, _I, _P]
#: C entry points of each library and their argument types
SIGNATURES = {
    "gn_silu": {"gn_silu_flat": _GN_ARGS, "gn_silu_nhwc": _GN_ARGS,
                "gn_silu_train_fwd": [_P] * 7 + [_I] * 11 + [_F, _I, _P],
                "gn_silu_train_bwd": [_P] * 10 + [_I] * 12 + [_P]},
    "conv_gn_silu": {"conv3x3_gn_silu_bf16": [_P] * 7 + [_I] * 10 + [_F, _P],
                     "conv3x3_gn_silu_f32": [_P] * 8 + [_I] * 10 + [_F, _P]},
    "dec1_output": {"dec1_output": [_P] * 15 + [_I] * 4 + [_F, _I, _P]},
    "batch_norm": {"bn_train_stats": [_P] * 4 + [_L] + [_I] * 5 + [_P],
                   "bn_train_apply": [_P] * 9 + [_L] + [_I] * 4 + [_D] + [_F] * 3 + [_I] * 2 + [_P],
                   "bn_train_bwd_sums": [_P] * 9 + [_L] + [_I] * 6 + [_P],
                   "bn_train_bwd_apply": [_P] * 9 + [_L] + [_I] * 4 + [_D] + [_I] * 2 + [_P]},
    "layer_norm": {"channel_layer_norm": [_P] * 4 + [_L, _I, _F, _I, _I, _P]},
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: nvcc's output (ptxas register and shared-memory report) per library
build_log: dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to a CUDA toolkit")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}_{_digest()}.so"


def build(names=SOURCES) -> float:
    """Compile every library of ``names`` not built yet, one nvcc process
    per source, all started together. Returns the wall seconds taken."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out)
    failed = []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib
