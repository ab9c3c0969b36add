"""Fused similarity + rank count + argmax (K2): the CUDA kernel in
``csrc/rank_kernel.cu`` and its plain PyTorch version.

Replaces multike_tpu/kernels/rank_kernel.py::rank_count_pallas. For every
row i of ``e1``, with ``s_ij = e1_i . e2_j`` (or ``2 s_ij - r2_j`` when the
CSLS column penalty ``r2`` is given):

    count_i    = #{ j != gold_idx_i : s_ij > gold_i }
    best_idx_i = first j of max_j s_ij,   best_val_i = that max

:func:`rank_count` follows its tensors' device: on the CPU it runs the plain
version, on a CUDA device it launches the kernel (or raises). ``launches``
counts the calls that launch it, one per call (the C entry point launches
a small kernel that lays out the inputs, the rank kernel, and a small
kernel that unpacks its argmax keys).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from multike_tpu_torch.kernels import _build

launches = 0

# Element budget of one (rows, columns) score block of the plain version.
_PLAIN_TILE_ELEMS = 256 * 1024 * 1024
# Largest d the kernel's shared memory takes: a CTA holds its row block of
# e1 (128 x d rounded up to 4, float32) beside its 51,712 bytes of ring,
# gold scores and columns and per-thread row state, within 227 KB
# (rank_kernel.cu).
MAX_DIM = 352


def plain_row_block(n1: int, n2: int) -> int:
    return int(min(max(n1, 1), max(1, _PLAIN_TILE_ELEMS // max(n2, 1))))


def rank_count_plain(e1, gold, gold_idx, e2, r2: Optional[torch.Tensor] = None,
                     row_block: Optional[int] = None,
                     col_block: Optional[int] = None):
    """Plain PyTorch version: (row block, column slice) score tiles, each
    reduced at once, so the whole n1 x n2 matrix never exists. A row
    block's slices merge by the kernel's rule: counts add up, and the best
    is the larger value, or the smaller column on equal values (+0.0 and
    -0.0 are equal). ``col_block`` (default: all columns) sizes the
    slices."""
    n1, n2 = e1.shape[0], e2.shape[0]
    rb = row_block or plain_row_block(n1, n2)
    cb = col_block or max(n2, 1)
    counts, idxs, vals = [], [], []
    for i0 in range(0, n1, rb):
        a, g = e1[i0:i0 + rb], gold[i0:i0 + rb, None]
        gi = gold_idx[i0:i0 + rb, None]
        cnt = torch.zeros(a.shape[0], dtype=torch.int64, device=e1.device)
        val = torch.full((a.shape[0],), float("-inf"), device=e1.device)
        idx = torch.zeros(a.shape[0], dtype=torch.int64, device=e1.device)
        for c0 in range(0, n2, cb):
            s = a @ e2[c0:c0 + cb].T
            if r2 is not None:
                s = 2.0 * s - r2[None, c0:c0 + cb]
            cols = torch.arange(c0, c0 + s.shape[1], device=e1.device)
            cnt += ((s > g) & (cols[None, :] != gi)).sum(dim=1)
            v, i = s.max(dim=1)          # first index of the max on ties
            i = i + c0
            take = (v > val) | ((v == val) & (i < idx))
            val = torch.where(take, v, val)
            idx = torch.where(take, i, idx)
        counts.append(cnt)
        idxs.append(idx)
        vals.append(val)
    if not counts:
        empty = torch.zeros(0, dtype=torch.int32, device=e1.device)
        return empty, empty.clone(), torch.zeros(0, device=e1.device)
    return (torch.cat(counts).to(torch.int32), torch.cat(idxs).to(torch.int32),
            torch.cat(vals))


def _check(e1, gold, gold_idx, e2, r2, max_dim: Optional[int] = MAX_DIM):
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
    if n1 > 0 and e2.shape[0] == 0:
        raise ValueError("e2 has no rows to rank against")
    if gold.shape != (n1,) or gold_idx.shape != (n1,):
        raise ValueError("gold and gold_idx must be (n1,)")
    if r2 is not None and r2.shape != (e2.shape[0],):
        raise ValueError("r2 must be (n2,)")
    if max_dim is not None and d > max_dim:
        raise ValueError(f"d = {d} exceeds the kernel's {max_dim}")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != e1.device:
            raise ValueError(f"{name} is on {t.device}, e1 on {e1.device}")


@functools.lru_cache(maxsize=64)
def _plan(n1: int, n2: int, d: int, csls: bool, device_index: int):
    out = (ctypes.c_longlong * 5)()
    lib = _build.load()
    with torch.cuda.device(device_index):
        err = lib.rank_count_plan(n1, n2, d, int(csls), out)
    _build.check(err, "rank_count_plan")
    return tuple(out)


def plan(n1: int, n2: int, d: int, csls: bool = False, device=None) -> dict:
    """The kernel's launch on a CUDA device: ``tiles`` (128 x 128 (row
    block, column tile) pairs), ``ctas`` (the grid: one CTA per resident
    slot, at most one per tile), ``resident`` (CTA slots the card holds at
    once), ``waves`` (1 by construction), the most and fewest tiles a CTA
    takes, ``smem`` bytes per CTA and ``workspace`` bytes."""
    index = torch.device("cuda" if device is None else device).index
    tiles, ctas, resident, smem, workspace = _plan(
        n1, n2, d, csls,
        torch.cuda.current_device() if index is None else index)
    return dict(tiles=tiles, ctas=ctas, resident=resident,
                waves=-(-ctas // resident), tiles_per_cta_max=-(-tiles // ctas),
                tiles_per_cta_min=tiles // ctas, smem=smem,
                workspace=workspace)


def rank_count(e1, gold, gold_idx, e2, r2: Optional[torch.Tensor] = None,
               row_block: Optional[int] = None):
    """Returns ``(count int32, best_idx int32, best_val float32)``, each
    (n1,). ``row_block`` sizes the plain version's blocks on the CPU; the
    kernel picks its own tiles. On the card the call allocates a workspace
    for the kernel's k-major copies of e1 and e2 (``plan()["workspace"]``
    bytes). The checks are the same on both devices, but for the kernel's
    limit on d."""
    global launches
    if e1.device.type == "cpu":
        _check(e1, gold, gold_idx, e2, r2, max_dim=None)
        return rank_count_plain(e1, gold, gold_idx, e2, r2, row_block)
    if e1.device.type != "cuda":
        raise ValueError(f"unsupported device {e1.device}")
    _check(e1, gold, gold_idx, e2, r2)
    (n1, d), n2 = e1.shape, e2.shape[0]
    count = torch.empty(n1, dtype=torch.int32, device=e1.device)
    best_idx = torch.empty(n1, dtype=torch.int32, device=e1.device)
    best_val = torch.empty(n1, dtype=torch.float32, device=e1.device)
    if n1 == 0:
        return count, best_idx, best_val
    workspace = torch.empty(
        plan(n1, n2, d, r2 is not None, e1.device)["workspace"],
        dtype=torch.uint8, device=e1.device)
    lib = _build.load()
    with torch.cuda.device(e1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rank_count(
            e1.data_ptr(), e2.data_ptr(), gold.data_ptr(), gold_idx.data_ptr(),
            None if r2 is None else r2.data_ptr(), n1, n2, d,
            workspace.data_ptr(), count.data_ptr(), best_idx.data_ptr(),
            best_val.data_ptr(), stream)
    _build.check(err, "rank_count")
    launches += 1
    return count, best_idx, best_val
