"""Small host utilities (counterpart of multike_tpu/utils/misc.py).

The JAX module's ``enable_persistent_compile_cache`` has no counterpart:
the port compiles nothing with XLA (its two CUDA kernels are built once
into ``multike_tpu_torch/build/``), so ``Config.compile_cache_dir`` is
accepted and ignored.
"""
from __future__ import annotations

from typing import Dict, List, Sequence


def merge_dic(dic1: Dict, dic2: Dict) -> Dict:
    return {**dic1, **dic2}


def task_divide(idx: Sequence, n: int) -> List[List]:
    """Split a list into n chunks; the last chunk takes the remainder."""
    idx = list(idx)
    total = len(idx)
    if n <= 0 or total == 0 or n > total:
        return [idx]
    if n == total:
        return [[i] for i in idx]
    j = total // n
    tasks = [idx[i:i + j] for i in range(0, (n - 1) * j, j)]
    tasks.append(idx[(n - 1) * j:])
    return tasks
