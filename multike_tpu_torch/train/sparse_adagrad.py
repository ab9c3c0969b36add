"""Row-sparse Adagrad (counterpart of multike_tpu/train/sparse_adagrad.py).

The reference's TF1 sparse Adagrad touches only the rows a step gathered.
Dense Adagrad over a whole (E, d) table is the same math (zero-gradient
rows keep their accumulators) but moves O(E * d) bytes per step; this
module applies the identical update to the touched rows only:

  1. sort the (possibly duplicated) batch ids and segment-sum duplicate
     occurrences' gradients (dense Adagrad squares the SUM);
  2. hand the unique rows and their summed gradients to the fused apply
     (kernels/apply_kernel.py: the CUDA kernel on the card, its plain
     version on the CPU):
         acc_row += gsum^2
         param_row -= lr * gsum * where(acc_row > 0, rsqrt(acc_row + eps), 0)
     which is optax.adagrad's ``scale_by_rss`` + ``scale(-lr)``, not
     ``torch.optim.Adagrad`` (that one divides by ``sqrt(acc) + 1e-10``).

Slots that hold no unique id carry distinct out-of-range sentinel rows,
which the apply drops.

Unlike the JAX package, which returns new arrays (in place only through
buffer donation), every function here updates ``param`` and ``acc`` IN
PLACE and returns them.
"""
from __future__ import annotations

import torch

from multike_tpu_torch.kernels.apply_kernel import fused_row_adagrad

ADAGRAD_EPS = 1e-7            # optax.adagrad default
ADAGRAD_ACC0 = 0.1            # reference initial_accumulator_value


def init_acc(param, a0: float = ADAGRAD_ACC0):
    """Adagrad accumulators matching ``param`` (a tensor or nested dict)."""
    if isinstance(param, dict):
        return {k: init_acc(v, a0) for k, v in param.items()}
    return torch.full_like(param, a0)


def dedup_rows(ids: torch.Tensor, g_rows: torch.Tensor, rows: int,
               row_offset: int = 0, total_rows: int | None = None):
    """(loc int32 (N,), gsum (N, d)) for the fused apply: one slot per
    unique id with its summed gradient, in sorted order; the remaining slots
    and ids outside ``[row_offset, row_offset + rows)`` get distinct
    sentinels ``>= rows``.

    Row-sharded tables: ``rows`` is the local shard's row count,
    ``row_offset`` its first global row and ``total_rows`` the global count;
    ``ids`` stay global."""
    n = ids.shape[0]
    total = total_rows or rows
    sid, order = torch.sort(ids, stable=True)
    sg = g_rows[order]
    is_start = torch.ones_like(sid, dtype=torch.bool)
    is_start[1:] = sid[1:] != sid[:-1]
    seg = torch.cumsum(is_start, dim=0) - 1                    # (N,) in [0, U)
    gsum = torch.zeros_like(g_rows).index_add_(0, seg, sg)
    arange = torch.arange(n, device=ids.device, dtype=sid.dtype)
    rep = total + arange
    rep[seg] = sid
    loc = rep - row_offset
    valid = (loc >= 0) & (loc < rows)
    loc = torch.where(valid, loc, rows + arange)
    return loc.to(torch.int32), gsum


def row_apply(param: torch.Tensor, acc: torch.Tensor, ids: torch.Tensor,
              g_rows: torch.Tensor, lr: float, eps: float = ADAGRAD_EPS,
              row_offset: int = 0, total_rows: int | None = None):
    """One Adagrad step on ``param`` touching only ``ids``' rows, in place.

    ``g_rows`` (N, d): per-OCCURRENCE gradients of the gathered rows
    ``param[ids]``. Returns ``(param, acc)``."""
    loc, gsum = dedup_rows(ids, g_rows, param.shape[0], row_offset,
                           total_rows)
    return fused_row_adagrad(param, acc, loc, gsum.contiguous(), lr, eps)


def dense_apply(param, acc, grads, lr: float, eps: float = ADAGRAD_EPS):
    """Dense Adagrad, in place, over a tensor or nested dict of tensors
    (relation/attribute tables, conv scorers, mappings)."""
    if isinstance(param, dict):
        for k in param:
            dense_apply(param[k], acc[k], grads[k], lr, eps)
        return param, acc
    acc.add_(torch.square(grads))
    param.sub_(lr * torch.where(acc > 0, torch.rsqrt(acc + eps), 0.0) * grads)
    return param, acc
