"""Pairwise similarity API (counterpart of multike_tpu/eval/similarity.py).

``sim`` materializes the n1 x n2 matrix on the host, like the reference; it
is the compatibility surface for external callers and non-inner metrics.
The evaluation path (eval/alignment.py) never materializes the matrix.
"""
from __future__ import annotations

import numpy as np
import torch


def _normalize_rows(x: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(x, axis=1, keepdims=True)
    return np.where(n > 0, x / np.maximum(n, 1e-30), x)


def sim(embed1, embed2, metric: str = "inner", normalize: bool = False,
        csls_k: int = 0) -> np.ndarray:
    """Metrics: inner, cosine, euclidean, manhattan, or any scipy cdist
    name (as 1 - distance)."""
    embed1 = np.asarray(embed1, np.float32)
    embed2 = np.asarray(embed2, np.float32)
    if normalize:
        embed1 = _normalize_rows(embed1)
        embed2 = _normalize_rows(embed2)
    if metric == "inner" or (metric == "cosine" and normalize):
        mat = (embed1 @ embed2.T).astype(np.float32)
    elif metric == "euclidean":
        sq1 = np.sum(embed1 ** 2, axis=1)[:, None]
        sq2 = np.sum(embed2 ** 2, axis=1)[None, :]
        d2 = np.maximum(sq1 + sq2 - 2.0 * (embed1 @ embed2.T), 0.0)
        mat = (1.0 - np.sqrt(d2)).astype(np.float32)
    elif metric == "cosine":
        mat = (_normalize_rows(embed1) @ _normalize_rows(embed2).T).astype(
            np.float32)
    elif metric == "manhattan":
        mat = np.zeros((len(embed1), len(embed2)), np.float32)
        for i in range(len(embed1)):
            mat[i] = 1.0 - np.abs(embed1[i][None, :] - embed2).sum(axis=1)
    else:
        from scipy.spatial.distance import cdist

        mat = (1.0 - cdist(embed1, embed2, metric=metric)).astype(np.float32)
    if csls_k > 0:
        mat = csls_sim(mat, csls_k)
    return mat


def calculate_nearest_k(sim_mat: np.ndarray, k: int) -> np.ndarray:
    """Row-wise mean of the k largest entries."""
    sorted_mat = -np.partition(-sim_mat, k + 1, axis=1)
    return np.mean(sorted_mat[:, 0:k], axis=1)


def csls_sim(sim_mat: np.ndarray, k: int) -> np.ndarray:
    """CSLS correction 2*sim - r1 - r2."""
    nearest1 = calculate_nearest_k(sim_mat, k)
    nearest2 = calculate_nearest_k(sim_mat.T, k)
    out = 2.0 * sim_mat.T - nearest1
    return (out.T - nearest2).astype(np.float32)


def csls_sim_multi_threads(sim_mat: np.ndarray, k: int,
                           nums_threads: int = 1) -> np.ndarray:
    """The reference helper's signature: the row means of the k largest
    entries (its only output), computed vectorized, so ``nums_threads`` is
    accepted and unused."""
    return calculate_nearest_k(sim_mat, k)


def csls_penalties_blockwise(e1: torch.Tensor, e2: torch.Tensor, k: int,
                             col_block: int = 8192):
    """(r1, r2): row and column mean-top-k terms of ``e1 @ e2.T``, computed
    over column blocks with a running top-k, so the full matrix never
    exists."""

    def topk_means(a, b):
        buf = torch.full((a.shape[0], k), float("-inf"), dtype=a.dtype,
                         device=a.device)
        for c0 in range(0, b.shape[0], col_block):
            s = a @ b[c0:c0 + col_block].T
            buf = torch.topk(torch.cat([buf, s], dim=1), k, dim=1).values
        return buf.mean(dim=1)

    return topk_means(e1, e2), topk_means(e2, e1)
