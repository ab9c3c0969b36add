"""The ('dp', 'tp') mesh as ``torch.distributed`` process groups
(counterpart of multike_tpu/parallel/mesh.py).

  * 'dp' - data parallel: each step's batch is split over the dp ranks;
    dense gradients are summed over dp, the (row id, row gradient) pairs of
    the row tables are gathered over dp.
  * 'tp' - table parallel: the entity tables are row-sharded over the tp
    ranks; a gather of rows is a masked local gather summed over tp.

Ranks are laid out process-major, as the JAX package lays out devices:
rank = dp_index * tp + tp_index. A rank's dp group holds the ranks with its
tp index, its tp group those with its dp index.
"""
from __future__ import annotations

import dataclasses

import torch.distributed as dist

from multike_tpu_torch.parallel import distributed


@dataclasses.dataclass(frozen=True)
class Mesh:
    dp: int
    tp: int
    rank: int
    dp_group: object
    tp_group: object

    @property
    def dp_index(self) -> int:
        return self.rank // self.tp

    @property
    def tp_index(self) -> int:
        return self.rank % self.tp


def make_mesh(dp: int, tp: int = 1) -> Mesh:
    """The groups of a dp x tp mesh over an initialized process group of
    exactly dp * tp ranks; every rank must call it."""
    world = distributed.world_size() if dist.is_initialized() else 0
    if world != dp * tp:
        raise RuntimeError(
            f"mesh {dp}x{tp} needs a process group of {dp * tp} ranks, "
            f"found {world or 'none'} (launch one process per rank, for "
            "example with torchrun, and call init_distributed first)")
    me = dist.get_rank()
    dp_group = tp_group = None
    for j in range(tp):          # every rank creates every group, in order
        g = dist.new_group([i * tp + j for i in range(dp)])
        if me % tp == j:
            dp_group = g
    for i in range(dp):
        g = dist.new_group([i * tp + j for j in range(tp)])
        if me // tp == i:
            tp_group = g
    return Mesh(dp, tp, me, dp_group, tp_group)
