"""Ring-decomposed rank computation (counterpart of multike_tpu/eval/ring.py).

For evaluation where neither side is replicated: both embedding matrices
are split in row blocks over a group of ranks. Each rank keeps its resident
left rows and a rotating right block; at every ring step it launches the
rank kernel (K2, ``kernels/rank_kernel.rank_count``) on the resident block

    count_i += #{ j in block : s_ij > gold_i, j != gold_col_i }
    best_i   = running argmax

then passes the block to the next rank (``batch_isend_irecv`` to rank + 1,
from rank - 1). After P steps every row has met every column. Blocks merge
by the JAX ring's rule: counts add, and a block's best replaces the running
one only where it is strictly greater, so on a tie across blocks the block
met first wins.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from multike_tpu_torch.kernels.rank_kernel import rank_count
from multike_tpu_torch.parallel import distributed
from multike_tpu_torch.utils.device import resolve_device


def make_ring_rank(group=None, n2_valid: int | None = None,
                   use_csls: bool = False):
    """Returns ``ranker(e1, gold, gold_idx, e2[, r2]) -> (count, best_idx)``
    (int64, this rank's rows).

    Every argument is this rank's block: rows of e1 with their gold scores
    and gold column ids, and a block of e2 rows (all ranks' e2 blocks of one
    size, block i on group rank i), with its CSLS penalties ``r2`` when
    ``use_csls`` (scores are then ``2 s_ij - r2_j``, and ``gold`` must be
    adjusted likewise). Columns from ``n2_valid`` on (padding) are left out:
    K2 sees only a block's valid rows, since a zero row would score 0 and
    beat a negative gold."""
    P = dist.get_world_size(group)
    me = dist.get_rank(group)

    def ranker(e1, gold, gold_idx, e2_blk, r2_blk=None):
        n1, nb = e1.shape[0], e2_blk.shape[0]
        count = torch.zeros(n1, dtype=torch.int64, device=e1.device)
        best_val = torch.full((n1,), float("-inf"), device=e1.device)
        best_idx = torch.zeros(n1, dtype=torch.int64, device=e1.device)
        blk = [e2_blk, r2_blk] if use_csls else [e2_blk]
        for p in range(P):
            # blocks move forward, so at step p the resident block is the
            # one that started on rank me - p
            col0 = ((me - p) % P) * nb
            nv = nb if n2_valid is None else max(0, min(nb, n2_valid - col0))
            if nv > 0 and n1 > 0:
                cnt, bi, bv = rank_count(
                    e1, gold, (gold_idx - col0).to(torch.int32),
                    blk[0][:nv].contiguous(),
                    blk[1][:nv].contiguous() if use_csls else None)
                count += cnt
                take = bv > best_val
                best_val = torch.where(take, bv, best_val)
                best_idx = torch.where(take, bi.long() + col0, best_idx)
            if p < P - 1:
                blk = distributed.ring_shift(blk, group)
        return count, best_idx

    return ranker


def make_ring_topk_means(group=None, k: int = 1, n_valid: int | None = None,
                         col_block: int = 4096):
    """Returns ``f(a, b) -> (len(a),)``: the mean of each of this rank's
    ``a`` rows' top-k similarities against ALL ranks' ``b`` blocks (the CSLS
    neighbourhood term). Each rank folds the rotating b block, ``col_block``
    rows at a time, into a running top-k; b rows from ``n_valid`` on
    (padding) never enter it."""
    P = dist.get_world_size(group)
    me = dist.get_rank(group)

    def f(a, b_blk):
        nb = b_blk.shape[0]
        buf = torch.full((a.shape[0], k), float("-inf"), device=a.device)
        blk = [b_blk]
        for p in range(P):
            col0 = ((me - p) % P) * nb
            nv = nb if n_valid is None else max(0, min(nb, n_valid - col0))
            for c0 in range(0, nv, col_block):
                s = a @ blk[0][c0:min(c0 + col_block, nv)].T
                buf = torch.topk(torch.cat([buf, s], dim=1), k, dim=1).values
            if p < P - 1:
                blk = distributed.ring_shift(blk, group)
        return buf.mean(dim=1)

    return f


def _pad_rows(x: np.ndarray, mult: int) -> np.ndarray:
    pad = (-len(x)) % mult
    if pad == 0:
        return x
    return np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])


def ring_rank_and_align(group, e1, e2, normalize: bool = True,
                        csls_k: int = 0, device=None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Rank and argmax of every row of ``e1`` (gold: column i), the rows and
    columns split over the group's ranks; each rank passes the whole
    ``e1``/``e2`` and gets the whole (n1,) int64 vectors back. Pads both
    sides to the group size and strips the padding. ``normalize`` divides
    each row by ``max(||x||, 1e-30)`` on the host. ``csls_k`` > 0 first
    computes the column penalties r2 with a ring top-k pass."""
    P = dist.get_world_size(group)
    me = dist.get_rank(group)
    dev = resolve_device(device)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    n1, n2 = len(e1), len(e2)
    if n2 < n1:
        raise ValueError("gold column must exist for every row")
    if normalize:
        def nrm(x):
            n = np.linalg.norm(x, axis=1, keepdims=True)
            return np.where(n > 0, x / np.maximum(n, 1e-30), x)

        e1, e2 = nrm(e1), nrm(e2)
    d1 = torch.as_tensor(_pad_rows(e1, P), device=dev)
    d2 = torch.as_tensor(_pad_rows(e2, P), device=dev)
    m1 = d1.shape[0]
    gold = torch.sum(d1 * d2[:m1], dim=1)
    gold_idx = torch.arange(m1, dtype=torch.int32, device=dev)
    b1 = distributed.block_slice(m1, P, me)
    b2 = distributed.block_slice(d2.shape[0], P, me)
    r2_blk = None
    if csls_k > 0:
        # r2_j: mean top-k of column j of s, i.e. of row j of e2 @ e1.T
        r2_blk = make_ring_topk_means(group, csls_k, n_valid=n1)(d2[b2],
                                                                d1[b1])
        r2 = distributed.all_gather(r2_blk, group)
        gold = 2.0 * gold - r2[:m1]
    ranker = make_ring_rank(group, n2_valid=n2, use_csls=csls_k > 0)
    count, best = ranker(d1[b1].contiguous(), gold[b1].contiguous(),
                         gold_idx[b1].contiguous(), d2[b2].contiguous(),
                         r2_blk)
    count = distributed.all_gather(count, group)[:n1]
    best = distributed.all_gather(best, group)[:n1]
    return count.cpu().numpy(), best.cpu().numpy()
