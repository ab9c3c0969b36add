"""Fused similarity + rank count + argmax (K2): the CUDA kernel in
``csrc/rank_kernel.cu`` and its plain PyTorch version.

Replaces multike_tpu/kernels/rank_kernel.py::rank_count_pallas. For every
row i of ``e1``, with ``s_ij = e1_i . e2_j`` (or ``2 s_ij - r2_j`` when the
CSLS column penalty ``r2`` is given):

    count_i    = #{ j != gold_idx_i : s_ij > gold_i }
    best_idx_i = first j of max_j s_ij,   best_val_i = that max

:func:`rank_count` follows its tensors' device: on the CPU it runs the plain
version, on a CUDA device it launches the kernel (or raises). ``launches``
counts the kernel launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from multike_tpu_torch.kernels import _build

launches = 0

# Element budget of one (rows, n2) score block of the plain version.
_PLAIN_TILE_ELEMS = 256 * 1024 * 1024
# Largest d the kernel's shared-memory staging takes (see rank_kernel.cu).
MAX_DIM = 416


def plain_row_block(n1: int, n2: int) -> int:
    return int(min(max(n1, 1), max(1, _PLAIN_TILE_ELEMS // max(n2, 1))))


def rank_count_plain(e1, gold, gold_idx, e2, r2: Optional[torch.Tensor] = None,
                     row_block: Optional[int] = None):
    """Plain PyTorch version: row blocks of full-width score tiles, each
    reduced at once, so the whole n1 x n2 matrix never exists."""
    n1, n2 = e1.shape[0], e2.shape[0]
    rb = row_block or plain_row_block(n1, n2)
    cols = torch.arange(n2, device=e1.device)
    counts, idxs, vals = [], [], []
    for i0 in range(0, n1, rb):
        s = e1[i0:i0 + rb] @ e2.T
        if r2 is not None:
            s = 2.0 * s - r2[None, :]
        beats = (s > gold[i0:i0 + rb, None]) & \
            (cols[None, :] != gold_idx[i0:i0 + rb, None])
        counts.append(beats.sum(dim=1))
        v, i = s.max(dim=1)          # first index of the max on ties
        vals.append(v)
        idxs.append(i)
    if not counts:
        empty = torch.zeros(0, dtype=torch.int32, device=e1.device)
        return empty, empty.clone(), torch.zeros(0, device=e1.device)
    return (torch.cat(counts).to(torch.int32), torch.cat(idxs).to(torch.int32),
            torch.cat(vals))


def _check(e1, gold, gold_idx, e2, r2):
    n1, d = e1.shape
    tensors = {"e1": e1, "gold": gold, "e2": e2}
    if r2 is not None:
        tensors["r2"] = r2
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    tensors["gold_idx"] = gold_idx
    if gold_idx.dtype != torch.int32:
        raise TypeError(f"gold_idx must be int32, got {gold_idx.dtype}")
    if e2.dim() != 2 or e2.shape[1] != d:
        raise ValueError(f"e1 {tuple(e1.shape)} and e2 {tuple(e2.shape)} "
                         "must share d")
    if gold.shape != (n1,) or gold_idx.shape != (n1,):
        raise ValueError("gold and gold_idx must be (n1,)")
    if r2 is not None and r2.shape != (e2.shape[0],):
        raise ValueError("r2 must be (n2,)")
    if d > MAX_DIM:
        raise ValueError(f"d = {d} exceeds the kernel's {MAX_DIM}")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != e1.device:
            raise ValueError(f"{name} is on {t.device}, e1 on {e1.device}")


def rank_count(e1, gold, gold_idx, e2, r2: Optional[torch.Tensor] = None,
               row_block: Optional[int] = None):
    """Returns ``(count int32, best_idx int32, best_val float32)``, each
    (n1,). ``row_block`` sizes the plain version's blocks on the CPU; the
    kernel picks its own tiles."""
    global launches
    if e1.device.type == "cpu":
        return rank_count_plain(e1, gold, gold_idx, e2, r2, row_block)
    if e1.device.type != "cuda":
        raise ValueError(f"unsupported device {e1.device}")
    _check(e1, gold, gold_idx, e2, r2)
    n1 = e1.shape[0]
    count = torch.empty(n1, dtype=torch.int32, device=e1.device)
    best_idx = torch.empty(n1, dtype=torch.int32, device=e1.device)
    best_val = torch.empty(n1, dtype=torch.float32, device=e1.device)
    lib = _build.load()
    with torch.cuda.device(e1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rank_count(
            e1.data_ptr(), e2.data_ptr(), gold.data_ptr(), gold_idx.data_ptr(),
            None if r2 is None else r2.data_ptr(), n1, e2.shape[0],
            e1.shape[1], count.data_ptr(), best_idx.data_ptr(),
            best_val.data_ptr(), stream)
    _build.check(err, "rank_count")
    launches += 1
    return count, best_idx, best_val
