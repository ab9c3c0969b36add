"""Mesh validation entry points (counterpart of multike_tpu/parallel/spmd.py).

:func:`dryrun` runs the trainer's real epoch builders (train/streams.py,
with a live ``MeshContext``) at tiny shapes: one epoch of each of the 8
loss streams, plus the sharded rank check of :func:`make_sharded_rank`.
With dp = tp = 1 it runs without a mesh, the one-rank reference.

As a script, one process per rank (torchrun's or the JAX package's
variables, see parallel/distributed.py):

    torchrun --nproc-per-node 4 -m multike_tpu_torch.parallel.spmd \\
        --dp 2 --tp 2 [--device cpu] [--dist-backend gloo] [--out metrics.json]

Rank 0 prints the metrics as one JSON line and writes them to ``--out``.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

import numpy as np
import torch

from multike_tpu_torch.config import Config
from multike_tpu_torch.kernels.rank_kernel import rank_count
from multike_tpu_torch.parallel import distributed
from multike_tpu_torch.parallel.context import (ROW_SHARDED_TABLES,
                                                MeshContext, pad_rows)
from multike_tpu_torch.params import init_params
from multike_tpu_torch.train import streams
from multike_tpu_torch.utils.device import resolve_device


def make_sharded_rank(group=None):
    """Evaluation with the left rows split over the group's ranks and the
    right table whole on each: ``ranker(e1, e2, gold_idx) -> (count,
    best_idx)``, each rank passing the whole inputs and getting the whole
    (n1,) vectors back. Each rank launches the rank kernel (K2) on its
    rows; rows are independent, so nothing merges but the gather."""
    P = torch.distributed.get_world_size(group)
    me = torch.distributed.get_rank(group)

    def ranker(e1, e2, gold_idx):
        n1 = e1.shape[0]
        e1p = pad_rows(e1, P)
        gidx = pad_rows(gold_idx, P)
        sl = distributed.block_slice(e1p.shape[0], P, me)
        rows, gi = e1p[sl].contiguous(), gidx[sl].contiguous()
        gold = torch.sum(rows * e2[gi.long()], dim=1)
        cnt, best, _ = rank_count(rows, gold, gi, e2.contiguous())
        return (distributed.all_gather(cnt, group)[:n1],
                distributed.all_gather(best, group)[:n1])

    return ranker


def run_streams(cfg: Config, pctx: Optional[MeshContext], device,
                entities: int = 64, relations: int = 8, attributes: int = 5,
                literals: int = 16, n_tri: int = 48, n_ents: int = 32,
                seed: int = 0):
    """One epoch of each of the 8 training streams, on the mesh ``pctx``
    or (None) on one rank, from seeded tables and random data of the given
    sizes. Returns ``(losses, tables)``; the tables are whole (gathered
    over tp, padding rows included)."""
    params = init_params(cfg, entities, relations, attributes, device=device)
    if pctx is not None:
        for t in ROW_SHARDED_TABLES:
            params[t] = pctx.pad_table_rows(params[t])
        params = pctx.shard_params(params)
    opt_states = streams.init_stream_opt_states(cfg, params, pctx)

    rng = np.random.RandomState(seed)
    half = entities // 2

    def tensor(a, dtype=torch.long):
        return torch.as_tensor(a, dtype=dtype, device=device)

    t1 = tensor(np.stack([rng.randint(0, half, n_tri),
                          rng.randint(0, relations, n_tri),
                          rng.randint(0, half, n_tri)], 1))
    t2 = tensor(np.stack([rng.randint(half, entities, n_tri),
                          rng.randint(0, relations, n_tri),
                          rng.randint(half, entities, n_tri)], 1))
    attr_t = tensor(np.stack([rng.randint(0, entities, n_tri),
                              rng.randint(0, attributes, n_tri),
                              rng.randint(0, literals, n_tri)], 1))
    weights = tensor(np.abs(rng.randn(n_tri)), torch.float32)
    ents = tensor(rng.permutation(entities)[:n_ents])
    constants = {
        "name_embeds": tensor(rng.randn(entities, cfg.dim), torch.float32),
        "literal_embeds": tensor(rng.randn(literals, cfg.dim),
                                 torch.float32)}
    gen = torch.Generator(device=device).manual_seed(seed)
    ranges = ((0, half), (half, entities))
    runs = {
        "rel_view": (streams.build_rel_view_epoch(
            cfg, n_tri, n_tri, ranges, pctx=pctx), (t1, t2), None),
        "attr_view": (streams.build_attr_view_epoch(cfg, n_tri, n_tri, pctx),
                      (constants, attr_t, weights, attr_t, weights), None),
        "ckge_rel": (streams.build_ckge_rel_epoch(cfg, n_tri, pctx), (t1,),
                     None),
        "ckgp_rel": (streams.build_ckgp_rel_epoch(cfg, n_tri, pctx),
                     (t1, weights), None),
        "ckge_attr": (streams.build_ckge_attr_epoch(cfg, n_tri, pctx),
                      (attr_t,), constants),
        "ckga_attr": (streams.build_ckga_attr_epoch(cfg, n_tri, pctx),
                      (attr_t, weights), constants),
        "common_space": (streams.build_common_space_epoch(
            cfg, len(ents), pctx), (ents,), constants),
        "space_mapping": (streams.build_space_mapping_epoch(
            cfg, len(ents), pctx), (ents,), constants),
    }
    losses: Dict[str, float] = {}
    for stream, ((epoch, _, _), data, consts) in runs.items():
        kw = {} if consts is None else {"constants": consts}
        losses[stream] = float(epoch(params, opt_states[stream], gen,
                                     *data, **kw))
    for k, v in losses.items():
        if not np.isfinite(v):
            raise RuntimeError(f"{k}: loss {v} is not finite ({losses})")
    if pctx is not None:
        params = pctx.gather_tree(params)
    return losses, params


def dryrun(dp: int = 1, tp: int = 1, device=None, dim: int = 8,
           entities: int = 64, relations: int = 8, attributes: int = 5,
           literals: int = 16) -> Dict[str, float]:
    """One epoch of each of the 8 training streams on a dp x tp mesh (an
    initialized process group of dp * tp ranks) or, at 1 x 1, without one.
    Returns the per-stream losses (all must be finite) and, on a mesh,
    ``eval_rows`` after the sharded rank check."""
    cfg = Config(dim=dim, batch_size=16, entity_batch_size=16,
                 attribute_batch_size=16, neg_triple_num=2,
                 learning_rate=0.05, mesh_dp=dp, mesh_tp=tp)
    dev = resolve_device(distributed.rank_device(device) if dp * tp > 1
                         else device)
    pctx = MeshContext.from_config(cfg, dev)
    metrics, _ = run_streams(cfg, pctx, dev, entities, relations, attributes,
                             literals)
    if pctx is None:
        return metrics

    # sharded evaluation: rows split over every rank of the mesh
    rng = np.random.RandomState(1)
    batch = 32
    e1 = rng.randn(batch, dim).astype(np.float32)
    e2 = np.concatenate([e1, rng.randn(batch, dim).astype(np.float32)])
    ranks, _ = make_sharded_rank()(
        torch.as_tensor(e1, device=dev), torch.as_tensor(e2, device=dev),
        torch.arange(batch, dtype=torch.int32, device=dev))
    s = e1 @ e2.T
    want = [np.sum((s[i] > s[i, i]) & (np.arange(2 * batch) != i))
            for i in range(batch)]
    if ranks.cpu().tolist() != want:
        raise RuntimeError("sharded eval mismatch")
    metrics["eval_rows"] = float(len(ranks))
    return metrics


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dp", type=int, required=True)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="the rank's device (default cuda:LOCAL_RANK)")
    ap.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None)
    ap.add_argument("--dist-init", default=None, metavar="URL",
                    help="rendezvous (default: from the environment)")
    ap.add_argument("--out", default=None)
    ns = ap.parse_args(argv)
    distributed.init_distributed(backend=ns.dist_backend, device=ns.device,
                                 init_method=ns.dist_init)
    metrics = dryrun(ns.dp, ns.tp, device=ns.device)
    if distributed.rank() == 0:
        print(json.dumps(metrics), flush=True)
        if ns.out:
            with open(ns.out, "w") as f:
                json.dump(metrics, f)
    distributed.shutdown()
    return metrics


if __name__ == "__main__":
    main()
