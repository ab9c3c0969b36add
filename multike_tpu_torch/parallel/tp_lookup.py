"""Table-parallel embedding lookup (counterpart of
multike_tpu/parallel/tp_lookup.py).

An entity table row-sharded over a group of ranks: a batch gather of
arbitrary ids moves only the batch, O(B * d) bytes a rank, whatever the
table's size:

    local = where(owned(ids), my_shard[ids - lo], 0)     # local masked gather
    rows  = all_reduce(local, group)                     # (B, d)

``normalize`` applies the reference's normalize-on-read after the sum.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from multike_tpu_torch.params import l2_normalize
from multike_tpu_torch.parallel.context import masked_row_gather


def make_tp_lookup(group=None, normalize: bool = False):
    """Returns ``lookup(shard, ids) -> (B, d)``: ``shard`` is this rank's
    block of rows (block ``i`` of the group's rank ``i``, all of one size),
    ``ids`` global row ids, the same on every rank of the group."""
    def lookup(shard: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        rows = masked_row_gather(shard, ids, group,
                                 dist.get_rank(group) * shard.shape[0])
        return l2_normalize(rows, axis=-1) if normalize else rows
    return lookup


def tp_lookup(group, shard: torch.Tensor, ids: torch.Tensor,
              normalize: bool = False) -> torch.Tensor:
    """One-shot form of :func:`make_tp_lookup`."""
    return make_tp_lookup(group, normalize)(shard, ids)
