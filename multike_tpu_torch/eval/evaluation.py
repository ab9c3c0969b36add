"""Thin evaluation wrappers (counterpart of multike_tpu/eval/evaluation.py)."""
from __future__ import annotations

import numpy as np
import torch

from multike_tpu_torch.eval.alignment import greedy_alignment


def _map(embeds1, mapping):
    if mapping is None:
        return embeds1
    if torch.is_tensor(embeds1):
        return embeds1 @ torch.as_tensor(mapping, dtype=embeds1.dtype,
                                         device=embeds1.device)
    return np.asarray(embeds1) @ np.asarray(mapping)


def valid(embeds1, embeds2, mapping, top_k, threads_num, metric: str = "inner",
          normalize: bool = False, csls_k: int = 0, accurate: bool = False,
          **engine_kw):
    _, hits1_12, _, mrr_12 = greedy_alignment(
        _map(embeds1, mapping), embeds2, top_k, threads_num, metric,
        normalize, csls_k, accurate, **engine_kw)
    return hits1_12, mrr_12


def test(embeds1, embeds2, mapping, top_k, threads_num, metric: str = "inner",
         normalize: bool = False, csls_k: int = 0, accurate: bool = True,
         **engine_kw):
    alignment_rest_12, hits1_12, _, mrr_12 = greedy_alignment(
        _map(embeds1, mapping), embeds2, top_k, threads_num, metric,
        normalize, csls_k, accurate, **engine_kw)
    return alignment_rest_12, hits1_12, mrr_12


def early_stop(flag1, flag2, flag):
    """Two-step metric-decline rule (the reference defines it but never
    arms it)."""
    if flag <= flag2 <= flag1:
        print("\n == should early stop == \n")
        return flag2, flag, True
    return flag2, flag, False
