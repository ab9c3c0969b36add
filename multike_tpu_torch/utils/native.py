"""Host-side file helpers (counterpart of multike_tpu/utils/native.py).

Only ``tsv_read_triples`` is needed by the data layer so far; the ctypes
Levenshtein helpers arrive with predicate alignment.
"""
from __future__ import annotations

from typing import List


def tsv_read_triples(path: str) -> List[List[str]]:
    """Read a TSV file into a list of column lists (no cleaning)."""
    rows: List[List[str]] = []
    with open(path, "r", encoding="utf8") as f:
        for line in f:
            rows.append(line.strip("\n").split("\t"))
    return rows
