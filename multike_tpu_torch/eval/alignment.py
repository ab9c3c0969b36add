"""Greedy alignment evaluation: Hits@k / MR / MRR without materializing the
n1 x n2 similarity matrix (counterpart of multike_tpu/eval/alignment.py).

For each left entity i, whose gold is column i:

    rank_index(i) = #{ j != i : s_ij > s_ii }     (exact, no sort)
    best(i)       = argmax_j s_ij                 (the greedy alignment pair)

Hits@k = rank_index < k, MR = mean(rank_index + 1), MRR = mean(1 / (rank_index
+ 1)). Both come from one call of the rank kernel (kernels/rank_kernel.py):
the CUDA kernel on the card, its blockwise plain version on the CPU.

CSLS (csls_k > 0) ranks the adjusted scores 2 s_ij - r2_j (the row term
r1_i does not change ranks within a row).

Gale-Shapley stable matching is kept as a host-side auxiliary API.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from multike_tpu_torch.eval.similarity import csls_penalties_blockwise
from multike_tpu_torch.kernels.rank_kernel import plain_row_block, rank_count
from multike_tpu_torch.params import l2_normalize
from multike_tpu_torch.utils.device import resolve_device
from multike_tpu_torch.utils.profiling import span


def _normalize_np(x: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(x, axis=1, keepdims=True)
    return np.where(n > 0, x / np.maximum(n, 1e-30), x)


def _to_numpy(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def rank_and_align(embed1, embed2, normalize: bool = True, csls_k: int = 0,
                   row_block: Optional[int] = None, col_block: int = 4096,
                   matmul_dtype=torch.float32, device=None, mesh=None):
    """Returns (rank_index (n1,), best_idx (n1,)) as int64 numpy arrays.

    Gold for row i is column i (requires n2 >= n1), as in the reference's
    evaluation layout.

    Tensor inputs stay on their device (``device`` moves them) and are
    normalized with ``l2_normalize``; numpy inputs are normalized on the
    host and sent to ``device`` (default: the card). Only the two (n1,)
    result vectors cross back. ``matmul_dtype=torch.bfloat16`` ranks as the
    JAX engine does: the normalized inputs are rounded to bf16, the gold
    score is the sum of their products in bf16 (then float32), and the
    ranking and the CSLS penalties take float32 copies of the rounded
    inputs. ``row_block`` sizes the plain version's row blocks on the CPU.

    ``mesh`` (a ``parallel.context.MeshContext``): the ranking goes through
    the ring over the mesh's dp ranks (eval/ring.py), both sides split over
    them and normalized on the host; ``matmul_dtype`` is not applied there,
    as in the JAX package."""
    with span("eval.rank"):
        if embed2.shape[0] < embed1.shape[0]:
            raise ValueError("gold column must exist for every row")
        if mesh is not None:
            from multike_tpu_torch.eval.ring import ring_rank_and_align

            return ring_rank_and_align(mesh.dp_group, _to_numpy(embed1),
                                       _to_numpy(embed2), normalize=normalize,
                                       csls_k=csls_k, device=mesh.device)
        if torch.is_tensor(embed1) and torch.is_tensor(embed2):
            dev = embed1.device if device is None else resolve_device(device)
            d1 = embed1.to(dev, torch.float32)
            d2 = embed2.to(dev, torch.float32)
            if normalize:
                d1 = l2_normalize(d1, axis=1)
                d2 = l2_normalize(d2, axis=1)
        else:
            dev = resolve_device(device)
            e1 = np.asarray(_to_numpy(embed1), np.float32)
            e2 = np.asarray(_to_numpy(embed2), np.float32)
            if normalize:
                e1 = _normalize_np(e1)
                e2 = _normalize_np(e2)
            d1 = torch.as_tensor(e1, dtype=torch.float32, device=dev)
            d2 = torch.as_tensor(e2, dtype=torch.float32, device=dev)
        n1 = d1.shape[0]
        if matmul_dtype != torch.float32:
            h1, h2 = d1.to(matmul_dtype), d2.to(matmul_dtype)
            gold = torch.sum(h1 * h2[:n1], dim=1).float()
            d1, d2 = h1.float(), h2.float()
        else:
            gold = torch.sum(d1 * d2[:n1], dim=1)
        d1, d2 = d1.contiguous(), d2.contiguous()

        r2 = None
        if csls_k > 0:
            _, r2 = csls_penalties_blockwise(d1, d2, csls_k,
                                             col_block=col_block)
            # adjusted gold: 2*s_ii - r2_i (r1_i is constant within the row)
            gold = 2.0 * gold - r2[:n1]
            r2 = r2.contiguous()
        gold_idx = torch.arange(n1, dtype=torch.int32, device=dev)
        rb = row_block or plain_row_block(n1, d2.shape[0])
        cnt, bidx, _ = rank_count(d1, gold.contiguous(), gold_idx, d2, r2,
                                  row_block=min(rb, max(n1, 1)))
        return (cnt.cpu().numpy().astype(np.int64),
                bidx.cpu().numpy().astype(np.int64))


def greedy_alignment(embed1, embed2, top_k: Sequence[int], nums_threads: int,
                     metric: str = "inner", normalize: bool = False,
                     csls_k: int = 0, accurate: bool = False,
                     verbose: bool = True, matmul_dtype=None,
                     row_block: Optional[int] = None, col_block: int = 4096,
                     device=None, mesh=None):
    """API parity with the reference's greedy_alignment; ``nums_threads`` is
    accepted for compatibility; ``mesh`` routes the ranking through the ring
    (see :func:`rank_and_align`). Returns (alignment_rest, hits1, mr,
    mrr)."""
    t = time.time()
    assert 1 in top_k
    if metric == "cosine":
        normalize = True  # cosine == normalized inner product
    elif metric != "inner":
        # other metrics go through the host sim matrix + calculate_rank:
        # O(n1 * n2) host memory, fine at valid-set sizes
        from multike_tpu_torch.eval.similarity import sim as sim_fn

        sim_mat = sim_fn(_to_numpy(embed1), _to_numpy(embed2), metric=metric,
                         normalize=normalize, csls_k=csls_k)
        n1 = sim_mat.shape[0]
        mr, mrr, hits_n, hits1_rest = calculate_rank(
            list(range(n1)), sim_mat, top_k, accurate, n1)
        hits = [round(h / n1 * 100, 3) for h in hits_n]
        if verbose:
            mode = "accurate" if accurate else "quick"
            print(f"{mode} results ({metric}): hits@{list(top_k)} = {hits}%, "
                  f"mr = {mr:.3f}, mrr = {mrr:.6f}, "
                  f"time = {time.time() - t:.3f} s")
        return hits1_rest, hits[0], mr, mrr
    ranks, best = rank_and_align(
        embed1, embed2, normalize=normalize, csls_k=csls_k,
        row_block=row_block, col_block=col_block,
        matmul_dtype=matmul_dtype if matmul_dtype is not None
        else torch.float32, device=device, mesh=mesh)
    num = len(ranks)
    mr = float(np.mean(ranks + 1))
    mrr = float(np.mean(1.0 / (ranks + 1)))
    hits = [round(float(np.mean(ranks < k)) * 100, 3) for k in top_k]
    alignment_rest = {(i, int(best[i])) for i in range(num)}
    if verbose:
        mode = "accurate" if accurate else "quick"
        csls = f" with csls: csls={csls_k}," if csls_k > 0 else ":"
        print(f"{mode} results{csls} hits@{list(top_k)} = {hits}%, "
              f"mr = {mr:.3f}, mrr = {mrr:.6f}, time = {time.time() - t:.3f} s")
    return alignment_rest, hits[0], mr, mrr


def calculate_rank(idx: List[int], sim_mat: np.ndarray, top_k: Sequence[int],
                   accurate: bool, total_num: int):
    """Host-side rank computation over an explicit sim matrix."""
    assert 1 in top_k
    mr, mrr = 0.0, 0.0
    hits = [0] * len(top_k)
    hits1_rest = set()
    for i in range(len(idx)):
        gold = idx[i]
        row = sim_mat[i, :]
        rank = (-row).argsort(kind="stable")
        hits1_rest.add((gold, int(rank[0])))
        rank_index = int(np.where(rank == gold)[0][0])
        mr += rank_index + 1
        mrr += 1.0 / (rank_index + 1)
        for j, k in enumerate(top_k):
            if rank_index < k:
                hits[j] += 1
    mr /= total_num
    mrr /= total_num
    return mr, mrr, hits, hits1_rest


# ---------------------------------------------------------------------------
# Stable matching (auxiliary API) - host side.
# ---------------------------------------------------------------------------

def galeshapley(suitor_pref_dict, reviewer_pref_dict, max_iteration: int):
    """Deferred-acceptance stable matching over integer rank tables: each
    round every free suitor proposes to the next reviewer on its list and
    each reviewer keeps the proposer it ranks best. ``max_iteration`` bounds
    the rounds. Returns {suitor: reviewer}."""
    suitors = list(suitor_pref_dict)
    reviewers = list(reviewer_pref_dict)
    sid = {s: i for i, s in enumerate(suitors)}
    rid = {r: j for j, r in enumerate(reviewers)}
    prefs = [[rid[r] for r in suitor_pref_dict[s]] for s in suitors]
    rank_of = [{sid[s]: k for k, s in enumerate(reviewer_pref_dict[r])}
               for r in reviewers]
    unranked = float("inf")

    nxt = [0] * len(suitors)             # next list position to propose to
    holds = [-1] * len(reviewers)        # reviewer j -> tentatively held suitor
    free = list(range(len(suitors)))
    for _ in range(max_iteration):
        if not free:
            break
        still_free = []
        for i in free:
            if nxt[i] >= len(prefs[i]):
                continue                 # exhausted list: permanently unmatched
            j = prefs[i][nxt[i]]
            cur = holds[j]
            if cur < 0:
                holds[j] = i
            elif rank_of[j].get(i, unranked) < rank_of[j].get(cur, unranked):
                holds[j] = i             # displace: cur can never win j back
                nxt[cur] += 1
                still_free.append(cur)
            else:
                nxt[i] += 1
                still_free.append(i)
        free = still_free
    return {suitors[i]: reviewers[j] for j, i in enumerate(holds) if i >= 0}


def stable_alignment(embed1, embed2, metric: str = "inner",
                     normalize: bool = False, csls_k: int = 0,
                     nums_threads: int = 1, cut: int = 100, sim_mat=None,
                     verbose: bool = True) -> float:
    """Stable-matching precision. Materializes the similarity matrix on the
    host, as the reference does; auxiliary API only."""
    from multike_tpu_torch.eval.similarity import sim as sim_fn

    t = time.time()
    if sim_mat is None:
        sim_mat = sim_fn(_to_numpy(embed1), _to_numpy(embed2), metric=metric,
                         normalize=normalize, csls_k=csls_k)
    kg1_candidates = {f"x_{i}": [f"y_{j}" for j in (-sim_mat[i]).argsort()]
                      for i in range(sim_mat.shape[0])}
    kg2_candidates = {f"y_{j}": [f"x_{i}" for i in (-sim_mat[:, j]).argsort()]
                      for j in range(sim_mat.shape[1])}
    matching = galeshapley(kg1_candidates, kg2_candidates, cut)
    n = sum(1 for i, j in matching.items()
            if int(i.split("_")[-1]) == int(j.split("_")[-1]))
    precision = n / max(len(matching), 1) * 100
    if verbose:
        print(f"stable alignment precision = {precision:.3f}%, "
              f"time = {time.time() - t:.3f} s")
    return precision
