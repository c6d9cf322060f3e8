"""ctypes loader for the native host preprocessing library.

The port's copy of the JAX package's ``native/``: ``triptych.cpp`` (split
the thirds, BT.601 luma, half-pixel bilinear resize rounded through
uint8, /255) is compiled with g++ on first use into
``build/native/libtriptych_<digest>.so`` at the root of the checkout,
through a temporary file renamed into place, so an interrupted or
concurrent build never leaves a torn library. The digest covers the
source and the flags, so an edited source is rebuilt. If it cannot be
built or loaded, every entry point raises: ``data.pipeline`` calls it only
when asked (``use_native=True``) and never falls back quietly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "triptych.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: list[ctypes.CDLL] = []


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SRC.read_bytes())
    return BUILD_DIR / f"libtriptych_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        done = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=120)
        if done.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SRC.name}:\n{done.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises if it cannot be."""
    with _lock:
        if _lib:
            return _lib[0]
        path = library_path()
        if not path.exists():
            try:
                _build(path)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise RuntimeError(f"cannot build the native library with g++: {e}") from e
        lib = ctypes.CDLL(str(path))
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i = ctypes.c_int
        lib.triptych_preprocess.argtypes = [u8p, i, i, i, i, f32p, f32p]
        lib.triptych_preprocess.restype = None
        lib.triptych_preprocess_batch.argtypes = [u8p, i, i, i, i, i, f32p, f32p, i]
        lib.triptych_preprocess_batch.restype = None
        lib.inference_preprocess.argtypes = [u8p, i, i, i, i, f32p]
        lib.inference_preprocess.restype = None
        _lib.append(lib)
        return lib


def _channels(img: np.ndarray, lead: int) -> int:
    if img.ndim not in (lead + 2, lead + 3):
        raise ValueError(f"expected an image of {lead + 2} or {lead + 3} dims, got {img.shape}")
    return img.shape[lead + 2] if img.ndim == lead + 3 else 1


def triptych_preprocess(img: np.ndarray, out_size: int):
    """uint8 (H, W[, C]) triptych -> (glared, gt) float32 (out, out)."""
    lib = get_lib()
    img = np.ascontiguousarray(img, np.uint8)
    c = _channels(img, 0)
    h, w = img.shape[:2]
    if h < 1 or w < 3:
        # a third of width 0 would make the C++ resize read out of bounds
        raise ValueError(f"triptych too small to split: {h}x{w}")
    glared = np.empty((out_size, out_size), np.float32)
    gt = np.empty((out_size, out_size), np.float32)
    lib.triptych_preprocess(img, h, w, c, out_size, glared, gt)
    return glared, gt


def triptych_preprocess_batch(imgs: np.ndarray, out_size: int, n_threads: int | None = None):
    """uint8 (N, H, W[, C]) -> (glared, gt) float32 (N, out, out), over a
    pool of at most the CPUs this process may run on."""
    lib = get_lib()
    cpus = len(os.sched_getaffinity(0)) or 1
    n_threads = cpus if n_threads is None else min(n_threads, cpus)
    imgs = np.ascontiguousarray(imgs, np.uint8)
    c = _channels(imgs, 1)
    n, h, w = imgs.shape[:3]
    if h < 1 or w < 3:
        raise ValueError(f"triptychs too small to split: {h}x{w}")
    glared = np.empty((n, out_size, out_size), np.float32)
    gt = np.empty((n, out_size, out_size), np.float32)
    lib.triptych_preprocess_batch(imgs, n, h, w, c, out_size, glared, gt, n_threads)
    return glared, gt


def inference_preprocess(img: np.ndarray, out_size: int) -> np.ndarray:
    """uint8 (H, W[, C]) -> float32 (out, out) grayscale in [0, 1]."""
    lib = get_lib()
    img = np.ascontiguousarray(img, np.uint8)
    c = _channels(img, 0)
    h, w = img.shape[:2]
    if h < 1 or w < 1:
        raise ValueError(f"image too small: {h}x{w}")
    out = np.empty((out_size, out_size), np.float32)
    lib.inference_preprocess(img, h, w, c, out_size, out)
    return out
