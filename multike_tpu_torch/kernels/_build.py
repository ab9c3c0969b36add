"""Build and load the package's native libraries.

Two libraries, both from sources in ``multike_tpu_torch/csrc/`` with a
plain C interface, built at first use into ``multike_tpu_torch/build/`` and
loaded with ``ctypes``. Each library's name carries a hash of its sources
and flags, so an edited source is rebuilt and an unchanged one is reused.
Each is compiled in a temporary directory and moved into place, so
processes that race to build it all load one sound library.

  * The CUDA kernels (:func:`build`, :func:`load`): compiled for Hopper
    (``sm_90a``) by ``nvcc``, one process per source started together, and
    linked into one library. ``nvcc`` is looked up on ``PATH``, then under
    ``$CUDA_HOME/bin`` and ``/usr/local/cuda/bin``. Each C entry point
    returns ``cudaGetLastError()`` after its launch; :func:`check` raises on
    anything but 0.
  * The host helpers (:func:`build_host`, :func:`load_host`): the
    Levenshtein matrix and the ``.vec`` reader of ``utils/native.py``,
    compiled by the host C++ compiler (``c++``, else ``g++``, on ``PATH``).
    They need neither ``nvcc`` nor a card.
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
SOURCES = ("apply_kernel.cu", "rank_kernel.cu", "chunk_loss_kernel.cu",
           "conv_score_kernel.cu", "per_slot_loss_kernel.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_SOURCES = ("host_helpers.cpp",)
HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

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
    "chunk_loss": [_P] * 8 + [ctypes.c_float] + [ctypes.c_int] * 4
                  + [_P] * 9,
    "conv_score_rows": [_P] * 8 + [ctypes.c_float] + [ctypes.c_int] * 2
                       + [_P] * 6,
    "conv_score_out": [_P] * 4 + [ctypes.c_int] * 2 + [_P] * 3,
    "conv_score_t": [_P] * 2 + [ctypes.c_int] + [_P] * 2,
    "conv_score_backward": [_P] * 8 + [ctypes.c_float] + [ctypes.c_int] * 2
                           + [_P] * 5 + [ctypes.c_int] * 2 + [_P] * 10,
    "per_slot_loss": [_P] * 7 + [ctypes.c_int] * 3 + [_P] * 7,
}
_PCHAR = ctypes.POINTER(ctypes.c_char_p)
# name -> (restype, argtypes) of each host entry point
_HOST_SIGNATURES = {
    "lev_ratio_matrix": (None, [_PCHAR, ctypes.c_int, _PCHAR, ctypes.c_int,
                                ctypes.POINTER(ctypes.c_double),
                                ctypes.c_int]),
    "vec_scan": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_int,
                                ctypes.POINTER(ctypes.c_longlong),
                                ctypes.POINTER(ctypes.c_longlong)]),
    "vec_parse": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_float),
                                 ctypes.c_char_p, ctypes.c_longlong,
                                 ctypes.c_longlong]),
}

_lock = threading.Lock()
_lib = None
_host_lib = None


def _nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            candidates.append(os.path.join(root, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _cxx() -> str:
    for name in ("c++", "g++"):
        c = shutil.which(name)
        if c:
            return c
    raise RuntimeError("no host C++ compiler (c++ or g++) on PATH: the host "
                       "helpers cannot be built")


def _hashed_path(stem: str, flags, sources) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        with open(os.path.join(CSRC_DIR, src), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")


def library_path() -> str:
    return _hashed_path("multike_kernels", NVCC_FLAGS, SOURCES)


def host_library_path() -> str:
    return _hashed_path("multike_host", HOST_FLAGS, HOST_SOURCES)


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


def build_host() -> str:
    """Compile the host helpers (if this exact build is absent) and return
    the library's path. A missing compiler or a failed compile raises
    ``RuntimeError`` with the compiler's output."""
    so = host_library_path()
    if os.path.exists(so):
        return so
    cxx = _cxx()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        tmp_so = os.path.join(tmp, "lib.so")
        cmd = [cxx, *HOST_FLAGS, "-o", tmp_so,
               *(os.path.join(CSRC_DIR, src) for src in HOST_SOURCES)]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"the host compiler {cxx} did not run: {e}"
                               ) from e
        if r.returncode != 0:
            raise RuntimeError(f"{cxx} failed on {', '.join(HOST_SOURCES)}:"
                               f"\n{r.stdout}{r.stderr}")
        os.replace(tmp_so, so)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return so


def load_host() -> ctypes.CDLL:
    """The host helper library, built on first call; ``ctypes`` keeps
    ``errno`` of each call (:func:`ctypes.get_errno`)."""
    global _host_lib
    with _lock:
        if _host_lib is None:
            lib = ctypes.CDLL(build_host(), use_errno=True)
            for name, (restype, argtypes) in _HOST_SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _host_lib = lib
    return _host_lib


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
