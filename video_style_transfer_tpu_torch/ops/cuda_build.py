"""Build and bind the hand-written CUDA kernels under ``csrc/``.

At first use, every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) by
its own ``nvcc`` process, all started together, and the objects are
linked into one shared library with a plain C interface, loaded with
``ctypes``. The library lands in ``_build/`` (git-ignored) under a name
keyed by a hash of the sources and flags, so a changed source rebuilds
and an unchanged one is loaded as it is. Nothing here runs at import:
the kernel modules call ``library()`` inside their launchers, so the
package imports on machines with no CUDA toolkit.
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

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C entry points and their argument types (pointers and the stream as
# c_void_p: ctypes would otherwise pass Python ints as 32-bit ints)
SIGNATURES = {
    # K1 takes one struct of its arguments (ops/flash_attention.py packs
    # it: _FWD_POINTERS, _FWD_LAYOUT, _FWD_SCALE)
    "vst_flash_attention_fwd": [_P],
    "vst_flash_attention_bwd": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I,
                                _L, _L, _L, _L, _L, _L, _L, _L, _L,
                                _F, _P],
    "vst_flash_attention_bwd_delta": [_I, _I, _P, _P, _P, _I, _I, _I, _P],
    # K2 too (ops/geglu.py: _POINTERS, _LAYOUT, _GATE)
    "vst_geglu_fwd": [_P],
    # K7 too (ops/layer_norm.py: _POINTERS, _LAYOUT), and its backward's
    # dscale / dbias kernels (_AFFINE_CALL)
    "vst_layer_norm_fwd": [_P],
    "vst_layer_norm_affine_grad": [_P],
    # the GroupNorm kernels too (ops/group_norm.py: _POINTERS, _LAYOUT),
    # and their occupancy query (dtype, affine dtype, silu, threads,
    # device, int* blocks)
    "vst_group_norm_fwd": [_P],
    "vst_group_norm_resident": [_I, _I, _I, _I, _I, _P],
    # K3 and K5 too (ops/temporal_attention.py: _POINTERS, _LAYOUT,
    # _SCALE; _BWD_POINTERS, _LAYOUT, _BWD_PLAN, _SCALE)
    "vst_temporal_attention_fwd": [_P],
    "vst_temporal_attention_bwd": [_P],
}

_lock = threading.Lock()
_lib = None
# filled by the first build in this process: seconds and nvcc's
# register/shared-memory report (-Xptxas -v), which a cached build reads
# back from beside its library
build_info = {"seconds": None, "built": False, "log": ""}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    path = cand if cand and os.path.exists(cand) else shutil.which("nvcc")
    if not path:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return path


def _inputs():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    srcs, hdrs = _inputs()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + hdrs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build(target: Path):
    nvcc = _nvcc()
    srcs, _ = _inputs()
    work = BUILD_DIR / f"tmp-{os.getpid()}-{threading.get_ident()}"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in srcs:
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + "\n"
                           + "\n".join(log))
    tmp = work / target.name
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError("linking the CUDA kernels failed\n" + link.stdout)
    os.replace(tmp, target)
    shutil.rmtree(work, ignore_errors=True)
    build_info.update(seconds=time.perf_counter() - t0, built=True,
                      log="\n".join(log))
    (BUILD_DIR / (target.stem + ".log")).write_text(build_info["log"])


def library():
    """The loaded kernel library, built on first call if needed."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            target = BUILD_DIR / f"libvst_kernels_{source_hash()}.so"
            if not target.exists():
                _build(target)
            elif target.with_suffix(".log").exists():
                # the nvcc report of the build this process reuses
                build_info["log"] = target.with_suffix(".log").read_text()
            lib = ctypes.CDLL(str(target))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check_launch(name: str, err: int):
    """Raise if a C launcher reported a CUDA error (its return value is
    ``cudaGetLastError()`` right after the launch, or a negative code for
    an argument the launcher refused)."""
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with code {err}")


def stream_of(t):
    """The current CUDA stream of t's device, as the raw handle a launcher
    takes (the lookup ``torch.cuda.current_stream`` wraps, without the
    Stream object it builds)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(t.get_device())

