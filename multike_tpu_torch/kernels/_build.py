"""Build and load the package's CUDA kernels.

The sources in ``multike_tpu_torch/csrc/`` have a plain C interface. At
first use they are compiled for Hopper (``sm_90a``) by ``nvcc``, one
process per source started together, linked into one shared library under
``multike_tpu_torch/build/`` and loaded with ``ctypes``. The library's name
carries a hash of the sources and flags, so an edited source is rebuilt and
an unchanged one is reused. ``nvcc`` is looked up on ``PATH``, then under
``$CUDA_HOME/bin`` and ``/usr/local/cuda/bin``.

Each C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on anything but 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
SOURCES = ("apply_kernel.cu", "rank_kernel.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
# name -> argtypes of each C entry point (all return int: a cudaError_t)
_SIGNATURES = {
    "row_adagrad": [_P, _P, _P, ctypes.c_longlong, _P, ctypes.c_int,
                    ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                    ctypes.c_float, ctypes.c_float, _P, _P, _P, _P],
    "rank_count": [_P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P],
    "rank_count_plan": [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, _P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            candidates.append(os.path.join(root, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        with open(os.path.join(CSRC_DIR, src), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libmultike_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sources (if this exact build is absent) and return the
    library's path. The compiler's resource report (``-Xptxas -v``) is kept
    beside the library as ``<library>.log``."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tmp = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        procs = []
        for src in SOURCES:
            obj = os.path.join(tmp, src + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC_DIR, src),
                   "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        for src, _, p in procs:
            out, _ = p.communicate()
            log.append(f"== {src}\n{out}")
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{out}")
        tmp_so = os.path.join(tmp, "lib.so")
        link = subprocess.run([nvcc, "-shared", "-o", tmp_so,
                               *(obj for _, obj, _ in procs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        with open(so + ".log", "w") as f:
            f.write("\n".join(log))
        os.replace(tmp_so, so)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return so


def load() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")
