"""The native clip preprocessing (the JAX package's data/native.py).

``native/preprocess.cpp`` (the port's own copy of the repository's
``native/preprocess.cpp``) is compiled with ``g++`` and the repository
Makefile's flags at first use, into the package's git-ignored ``_build/``
under a name keyed by a hash of the source, the compiler, the flags and
the target ``-march=native`` stands for on this host (a checkout shared
by hosts of other CPUs builds one library each), and bound with
``ctypes``. The fused ``preprocess_frames_bgr`` replaces
the per-frame cv2 chain of the clip loader (BGR -> RGB, bilinear resize,
[-1, 1]).

A toolchain without OpenMP (no libgomp) fails the first build: its log
is printed, and the source is built again without ``-fopenmp``, one
thread a call (the loops are the same, so are the results). Each entry
point has a plain numpy version (the JAX package's fallbacks), which it
takes when no library can be built. A failed build prints the compiler's
log, to stderr; ``native_available()`` says which path runs and
``build_info`` which library. Nothing is built at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "preprocess.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-fopenmp",
             "-std=c++17", "-Wall"]
# the same without OpenMP (its pragmas then do nothing)
SERIAL_FLAGS = [f for f in CXX_FLAGS if f != "-fopenmp"] + [
    "-Wno-unknown-pragmas"]

_lock = threading.Lock()
_lib = None
_lib_tried = False
# the library loaded: its path and whether it threads with OpenMP
build_info = {"path": None, "openmp": None}


def _cxx() -> Optional[str]:
    return os.environ.get("CXX") or shutil.which("g++")


def _host_target(cxx: str) -> str:
    """The target options -march=native enables here, as the compiler
    lists them ("" where it cannot say)."""
    try:
        return subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.DEVNULL, text=True,
                              timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired):
        return ""


def library_path(cxx: str, flags=CXX_FLAGS) -> Path:
    h = hashlib.sha256(" ".join([cxx, *flags]).encode())
    h.update(_host_target(cxx).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libvst_preprocess_{h.hexdigest()[:16]}.so"


def _build(cxx: str, flags, target: Path) -> bool:
    """Compile into a file of this process and move it into place (two
    processes building at once each finish with a whole library).
    Returns False, after printing the compiler's log, on a failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.stem}.tmp-{os.getpid()}"
                           f"-{threading.get_ident()}.so")
    try:
        out = subprocess.run([cxx, *flags, "-o", str(tmp), str(SOURCE)],
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True,
                             timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        print(f"native preprocessing: {cxx} did not run ({e})",
              file=sys.stderr, flush=True)
        return False
    if out.returncode != 0:
        print(f"native preprocessing: {cxx} {' '.join(flags)} failed (exit "
              f"{out.returncode})\n{out.stdout}", file=sys.stderr,
              flush=True)
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, target)
    return True


def _load() -> Optional[ctypes.CDLL]:
    """The bound library, built on the first call; None (after one
    printed reason) where it cannot be built or loaded."""
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    with _lock:
        if _lib_tried:
            return _lib
        _lib_tried = True
        cxx = _cxx()
        if cxx is None:
            print("native preprocessing: no g++ on PATH; the clip loader "
                  "takes the cv2 path", file=sys.stderr, flush=True)
            return None
        for flags in (CXX_FLAGS, SERIAL_FLAGS):
            target = library_path(cxx, flags)
            if target.exists() or _build(cxx, flags, target):
                break
            if flags is CXX_FLAGS:
                print("native preprocessing: building without OpenMP "
                      "(one thread a call)", file=sys.stderr, flush=True)
        else:
            print("native preprocessing: no library; the clip loader takes "
                  "the cv2 path", file=sys.stderr, flush=True)
            return None
        try:
            lib = ctypes.CDLL(str(target))
        except OSError as e:
            print(f"native preprocessing: loading {target} failed ({e}); "
                  f"the clip loader takes the cv2 path", file=sys.stderr,
                  flush=True)
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.u8_to_unit_range.argtypes = [u8p, f32p, ctypes.c_int64]
        lib.resize_bilinear_u8.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, u8p, ctypes.c_int,
                                           ctypes.c_int]
        lib.preprocess_frames_bgr.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p, f32p,
            ctypes.c_int, ctypes.c_int]
        for fn in (lib.u8_to_unit_range, lib.resize_bilinear_u8,
                   lib.preprocess_frames_bgr):
            fn.restype = None
        build_info.update(path=str(target), openmp=flags is CXX_FLAGS)
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def u8_to_unit_range_plain(frames: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(frames, np.uint8).astype(
        np.float32) / 127.5 - 1.0


def resize_bilinear_plain(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """Half-pixel-centre bilinear resize in numpy (float64 coordinates;
    the native version computes them in float32, so the two may differ
    by one level where a value sits on a rounding boundary)."""
    img = np.ascontiguousarray(img, np.uint8)
    sh, sw, _ = img.shape
    fy = (np.arange(dh) + 0.5) * (sh / dh) - 0.5
    fx = (np.arange(dw) + 0.5) * (sw / dw) - 0.5
    y0 = np.floor(fy).astype(int)
    x0 = np.floor(fx).astype(int)
    wy = (fy - y0)[:, None, None]
    wx = (fx - x0)[None, :, None]
    y0c, y1c = np.clip(y0, 0, sh - 1), np.clip(y0 + 1, 0, sh - 1)
    x0c, x1c = np.clip(x0, 0, sw - 1), np.clip(x0 + 1, 0, sw - 1)
    imgf = img.astype(np.float32)
    v = ((1 - wy) * ((1 - wx) * imgf[y0c][:, x0c] + wx * imgf[y0c][:, x1c])
         + wy * ((1 - wx) * imgf[y1c][:, x0c] + wx * imgf[y1c][:, x1c]))
    return np.clip(np.round(v), 0, 255).astype(np.uint8)


def preprocess_frames_bgr_plain(frames: np.ndarray, dh: int,
                                dw: int) -> np.ndarray:
    frames = np.ascontiguousarray(frames, np.uint8)
    out = np.empty((frames.shape[0], dh, dw, 3), np.float32)
    for i in range(frames.shape[0]):
        r = resize_bilinear_plain(frames[i], dh, dw).astype(np.float32)
        out[i] = r[..., ::-1] / 127.5 - 1.0
    return out


def u8_to_unit_range(frames: np.ndarray) -> np.ndarray:
    """uint8 -> float32 in [-1, 1]."""
    lib = _load()
    if lib is None:
        return u8_to_unit_range_plain(frames)
    frames = np.ascontiguousarray(frames, np.uint8)
    out = np.empty(frames.shape, np.float32)
    lib.u8_to_unit_range(_u8p(frames), _f32p(out), frames.size)
    return out


def resize_bilinear(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """(H, W, C) uint8 -> (dh, dw, C) uint8, half-pixel-centre bilinear
    (cv2.INTER_LINEAR's convention)."""
    lib = _load()
    if lib is None:
        return resize_bilinear_plain(img, dh, dw)
    img = np.ascontiguousarray(img, np.uint8)
    sh, sw, c = img.shape
    out = np.empty((dh, dw, c), np.uint8)
    lib.resize_bilinear_u8(_u8p(img), sh, sw, c, _u8p(out), dh, dw)
    return out


def preprocess_frames_bgr(frames: np.ndarray, dh: int,
                          dw: int) -> np.ndarray:
    """(F, H, W, 3) uint8 BGR -> (F, dh, dw, 3) float32 RGB in [-1, 1]:
    the clip loader's fused resize, channel swap and normalisation."""
    lib = _load()
    if lib is None:
        return preprocess_frames_bgr_plain(frames, dh, dw)
    frames = np.ascontiguousarray(frames, np.uint8)
    f, sh, sw, _ = frames.shape
    scratch = np.empty((f, dh, dw, 3), np.uint8)
    out = np.empty((f, dh, dw, 3), np.float32)

    def run(part: slice):
        lib.preprocess_frames_bgr(_u8p(frames[part]), part.stop - part.start,
                                  sh, sw, _u8p(scratch[part]),
                                  _f32p(out[part]), dh, dw)

    threads = 1 if build_info["openmp"] else min(f, os.cpu_count() or 1)
    if threads <= 1:
        run(slice(0, f))
    else:
        # the one-thread build: a host thread a share of the frames (a
        # ctypes call releases the GIL)
        bounds = np.linspace(0, f, threads + 1).astype(int)
        with ThreadPoolExecutor(threads) as pool:
            list(pool.map(run, [slice(a, b) for a, b in
                                zip(bounds[:-1], bounds[1:]) if b > a]))
    return out
