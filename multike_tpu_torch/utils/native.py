"""Host-side file and string helpers (counterpart of
multike_tpu/utils/native.py).

  * ``tsv_read_triples(path)``: a TSV file as a list of column lists;
  * ``levenshtein_ratio_matrix(names1, names2)``: the dense
    Levenshtein-ratio matrix that seeds predicate alignment;
  * ``read_word2vec(path, dim)``: a fastText-style ``.vec`` file as
    ``{word: float32 vector}``.

The last two always run the package's host helpers
(``csrc/host_helpers.cpp``, built at first use by
``kernels/_build.load_host``); a failed build raises, and nothing falls
back to Python. ``lev_ratio_matrix_py`` and ``read_word2vec_py`` are their
plain versions, bitwise equal, for the tests.
"""
from __future__ import annotations

import ctypes
import os
from typing import Dict, List, Sequence

import numpy as np

from multike_tpu_torch.kernels import _build


def tsv_read_triples(path: str) -> List[List[str]]:
    """Read a TSV file into a list of column lists (no cleaning)."""
    rows: List[List[str]] = []
    with open(path, "r", encoding="utf8") as f:
        for line in f:
            rows.append(line.strip("\n").split("\t"))
    return rows


# ---------------------------------------------------------------------------
# Levenshtein ratio
# ---------------------------------------------------------------------------

def lev_ratio_py(a: str, b: str) -> float:
    """python-Levenshtein's ``ratio``: (|a| + |b| - D) / (|a| + |b|), D the
    edit distance with insert/delete cost 1 and substitution cost 2."""
    la, lb = len(a), len(b)
    total = la + lb
    if total == 0:
        return 1.0
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        cur = [i] + [0] * lb
        ca = a[i - 1]
        for j in range(1, lb + 1):
            sub = prev[j - 1] + (0 if ca == b[j - 1] else 2)
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, sub)
        prev = cur
    return (total - prev[lb]) / total


def lev_ratio_matrix_py(names1: Sequence[str],
                        names2: Sequence[str]) -> np.ndarray:
    out = np.zeros((len(names1), len(names2)), dtype=np.float64)
    for i, s1 in enumerate(names1):
        for j, s2 in enumerate(names2):
            out[i, j] = lev_ratio_py(s1, s2)
    return out


def levenshtein_ratio_matrix(names1: Sequence[str],
                             names2: Sequence[str]) -> np.ndarray:
    """(n1, n2) float64 matrix of Levenshtein ratios."""
    n1, n2 = len(names1), len(names2)
    out = np.zeros((n1, n2), dtype=np.float64)
    if n1 == 0 or n2 == 0:
        return out
    lib = _build.load_host()
    arr1 = (ctypes.c_char_p * n1)(*[s.encode("utf-8") for s in names1])
    arr2 = (ctypes.c_char_p * n2)(*[s.encode("utf-8") for s in names2])
    lib.lev_ratio_matrix(arr1, n1, arr2, n2,
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                         min(8, os.cpu_count() or 1))
    return out


# ---------------------------------------------------------------------------
# .vec word-embedding files
# ---------------------------------------------------------------------------

def read_word2vec_py(file_path: str,
                     vector_dimension: int = 300) -> Dict[str, np.ndarray]:
    """Lines with exactly ``vector_dimension + 1`` space-separated fields;
    the header and malformed lines are skipped, later duplicates win."""
    word2vec: Dict[str, np.ndarray] = {}
    with open(file_path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.strip("\n").split(" ")
            if len(parts) != vector_dimension + 1:
                continue
            word2vec[parts[0]] = np.array(list(map(float, parts[1:])),
                                          dtype=np.float32)
    return word2vec


def _oserror(path: str) -> OSError:
    err = ctypes.get_errno()
    return OSError(err, os.strerror(err), path)  # FileNotFoundError etc.


def read_word2vec(file_path: str,
                  vector_dimension: int = 300) -> Dict[str, np.ndarray]:
    """``{word: float32 vector}`` of a ``.vec`` file: a line is a word and
    exactly ``vector_dimension`` floats, later duplicates win, the header
    and malformed lines are skipped. Equal to :func:`read_word2vec_py`
    where fields are separated by single spaces; where a line has runs of
    spaces (a trailing one included) it reads the floats between them, as
    the JAX package's native reader does, and the Python version skips the
    line. A file that cannot be opened raises its ``OSError``
    (``FileNotFoundError`` for a missing one); a file that changes between
    the two passes raises ``RuntimeError``."""
    lib = _build.load_host()
    n, wb = ctypes.c_longlong(), ctypes.c_longlong()
    path_b = os.fsencode(file_path)
    if lib.vec_scan(path_b, vector_dimension, ctypes.byref(n),
                    ctypes.byref(wb)) != 0:
        raise _oserror(file_path)
    if n.value == 0:
        return {}
    mat = np.empty((n.value, vector_dimension), np.float32)
    words_buf = ctypes.create_string_buffer(wb.value)
    rc = lib.vec_parse(path_b, vector_dimension,
                       mat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                       words_buf, n.value, wb.value)
    if rc == 1:
        raise _oserror(file_path)
    if rc != 0:
        raise RuntimeError(f"{file_path} changed while it was read "
                           f"(vec_parse returned {rc})")
    words = words_buf.raw[:wb.value].decode("utf-8").split("\n")[:-1]
    if len(words) != n.value:
        raise RuntimeError(f"{file_path}: {len(words)} words parsed, "
                           f"{n.value} lines scanned")
    return {w: mat[i] for i, w in enumerate(words)}
