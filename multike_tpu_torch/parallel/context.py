"""Parallel execution context: the ('dp', 'tp') mesh wiring of the trainer
(counterpart of multike_tpu/parallel/context.py).

A ``MeshContext`` holds the mesh's process groups, the rank's device and
the placement rules every training stream uses:

  * 'dp': every rank draws the same whole batch (one generator per rank,
    seeded alike, so the draws equal those of one rank) and takes its block
    of the loss's leading axis (``dp_block``). The losses are sums, so the
    rank losses and dense gradients sum over dp to the one-rank ones. The
    row tables' gradients travel as (row id, row gradient) pairs gathered
    over dp (:func:`row_apply_sharded`), O(batch * d) bytes a step.
  * 'tp': the entity tables and their accumulators are row-sharded over tp,
    padded with zero rows to split evenly. A gather of rows is a masked
    local gather summed over tp (:func:`gather_rows`); the row-sparse apply
    updates the rank's own rows only.

Everything else (relation and attribute tables, conv scorers, mappings,
constants) is a full copy on every rank.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from multike_tpu_torch.parallel import distributed
from multike_tpu_torch.parallel.mesh import Mesh, make_mesh

# Tables large enough to row-shard over 'tp' (entity-indexed).
ROW_SHARDED_TABLES = ("rv_ent", "av_ent", "ent")


def pad_rows(table: torch.Tensor, multiple: int) -> torch.Tensor:
    """Rows padded with zeros to a multiple of ``multiple``."""
    pad = (-table.shape[0]) % multiple
    if pad == 0:
        return table
    return torch.cat([table, table.new_zeros((pad,) + table.shape[1:])])


def _map(tree, fn, name):
    if isinstance(tree, dict):
        return {k: _map(v, fn, name) for k, v in tree.items()}
    return fn(tree, name)


class MeshContext:
    """The mesh's groups and placement helpers for one rank."""

    def __init__(self, mesh: Mesh, device):
        self.mesh = mesh
        self.dp, self.tp = mesh.dp, mesh.tp
        self.dp_index, self.tp_index = mesh.dp_index, mesh.tp_index
        self.dp_group, self.tp_group = mesh.dp_group, mesh.tp_group
        self.device = torch.device(device)

    @staticmethod
    def from_config(cfg, device=None) -> Optional["MeshContext"]:
        """The context of ``cfg.mesh_dp`` x ``cfg.mesh_tp``; None when the
        mesh is trivial. Raises unless the process group has exactly
        dp * tp ranks."""
        dp, tp = cfg.mesh_dp, cfg.mesh_tp
        if dp < 1 or tp < 1:
            raise ValueError(f"mesh {dp}x{tp}: both axes must be >= 1")
        if dp * tp == 1:
            return None
        return MeshContext(make_mesh(dp, tp),
                           distributed.rank_device(device))

    # ------------------------------------------------------------------
    def sharded(self, name: str) -> bool:
        return name in ROW_SHARDED_TABLES and self.tp > 1

    def table_spec(self, name: str) -> str:
        """"rows" (row-sharded over tp) or "replicated": the one placement
        rule of the port. (The JAX package's ``mesh.param_sharding`` would
        also shard ``rel`` and ``attr``; its trainer follows this rule.)"""
        return "rows" if self.sharded(name) else "replicated"

    def pad_table_rows(self, table: torch.Tensor) -> torch.Tensor:
        """Rows padded with zeros to a multiple of tp (never addressed by a
        valid entity id)."""
        return pad_rows(table, self.tp)

    def _place(self, t: torch.Tensor, name: str) -> torch.Tensor:
        if self.sharded(name):
            return distributed.local_block(t, self.tp, self.tp_index,
                                           self.device)
        return distributed.full_copy(t, self.device)

    def shard_params(self, params) -> Dict:
        """This rank's part of a params-shaped dict: its row block of each
        row-sharded table (padded first), a copy of the rest."""
        return {k: _map(v, self._place, k) for k, v in params.items()}

    def dp_block(self, n: int) -> slice:
        """This rank's block of a length-``n`` batch axis."""
        return distributed.block_slice(n, self.dp, self.dp_index)

    def round_batch(self, n: int) -> int:
        """``n`` rounded up to a multiple of dp."""
        return int(-(-n // self.dp) * self.dp)

    def gather_table(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """The whole (padded) table of a row-sharded one, gathered over tp;
        any other tensor as it is. Every rank of the tp group must call
        it."""
        if not self.sharded(name):
            return t
        return distributed.all_gather(t.contiguous(), self.tp_group)

    def to_host(self, t: torch.Tensor, name: str = "") -> np.ndarray:
        return self.gather_table(t, name).detach().cpu().numpy()

    def gather_tree(self, tree):
        """Whole tables of a params- or state-shaped dict (collective)."""
        return {k: _map(v, self.gather_table, k) for k, v in tree.items()}

    def put_edge_partitioned(self, triples: np.ndarray):
        """This rank's dp block of a host triple array, padded by wraparound
        so every block is equal; returns ``(block, true_n)``. (The trainer
        keeps the whole arrays on every rank instead, see its docstring.)"""
        n = len(triples)
        rows = self.round_batch(n)
        if rows > n:
            triples = np.concatenate([triples, triples[:rows - n]])
        per = rows // self.dp
        block = triples[self.dp_index * per:(self.dp_index + 1) * per]
        return torch.as_tensor(np.ascontiguousarray(block),
                               device=self.device), n


def masked_row_gather(shard: torch.Tensor, ids: torch.Tensor, group,
                      row0: int) -> torch.Tensor:
    """Rows of global ids from a row-sharded table: each rank gathers the
    rows it owns (``shard`` holds rows ``[row0, row0 + len(shard))``),
    zeros elsewhere, and the group sums them. ``ids`` may have any shape;
    returns ``ids.shape + (d,)``."""
    rows = shard.shape[0]
    local = ids - row0
    owned = (local >= 0) & (local < rows)
    out = torch.where(owned[..., None], shard[local.clamp(0, rows - 1)],
                      shard.new_zeros(()))
    return distributed.all_reduce(out.contiguous(), group)


def gather_rows(pctx: Optional[MeshContext], name: str, table: torch.Tensor,
                ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of a table, as the mesh places it: a plain gather of a
    full table, a masked gather summed over tp of a row-sharded one."""
    if pctx is None or not pctx.sharded(name):
        return table[ids]
    return masked_row_gather(table, ids, pctx.tp_group,
                             pctx.tp_index * table.shape[0])


def row_apply_sharded(pctx: MeshContext, name: str, param, acc, ids, g_rows,
                      lr: float, sizes=None):
    """Mesh-mode row-sparse Adagrad apply, in place.

    Gathers every dp rank's (row id, row gradient) pairs, then applies the
    deduplicated update to the rows this rank holds, through
    ``sparse_adagrad.row_apply`` and so K1 on every rank (with tp > 1 the
    other shards' ids do nothing there). dp replicas stay equal; tp
    shards update disjoint row ranges. ``sizes``: every dp rank's id count,
    if the caller knows them (else they are gathered first)."""
    from multike_tpu_torch.train import sparse_adagrad

    all_ids, all_g = distributed.all_gather_ragged(
        [ids, g_rows.contiguous()], pctx.dp_group, sizes)
    rows = param.shape[0]
    offset = pctx.tp_index * rows if pctx.sharded(name) else 0
    return sparse_adagrad.row_apply(param, acc, all_ids, all_g, lr,
                                    row_offset=offset)
