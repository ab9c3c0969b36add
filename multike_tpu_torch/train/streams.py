"""Per-loss training streams (counterpart of multike_tpu/train/streams.py).

Ported so far: the relation-view stream in its uniform (pre-neighbor-
refresh) phase with chunk-shared negatives, and the cross-KG entity
inference stream of the relation view (ckge_rel), which trains the swapped
supervision triples and so carries the view's only cross-KG signal. The
relation-view epoch draws every step's positives, tail masks and candidate
pools up front, then runs one step function per batch; the step function
is public so the tests can hold it against a step composed from the JAX
package.

Each stream is written as ``(prep, loss_fn)``: ``prep`` builds the row-id
vectors, ``loss_fn`` consumes the RAW gathered rows, so the update can run
on either of two same-math paths:

  * row-sparse Adagrad (train/sparse_adagrad.py): gradients are taken with
    respect to the gathered rows and applied to those rows only;
  * dense Adagrad: gradients flow through the gather to the full tables.

Parameters and accumulators are updated in place.

Stream variable ownership (row-sparse tables | dense):

  rel_view        rv_ent | rel
  ckge_rel        rv_ent | rel
  ckgp_rel        rv_ent | rel
  attr_view       av_ent | attr, conv_av
  ckge_attr       av_ent | attr, conv_ckge
  ckga_attr       av_ent | attr, conv_ckga
  common_space    ent, rv_ent, av_ent | -
  space_mapping   ent | nv/rv/av_mapping
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from multike_tpu_torch.config import Config
from multike_tpu_torch.losses import (chunk_shared_relation_logistic_loss,
                                      relation_logistic_loss_wo_negs)
from multike_tpu_torch.params import l2_normalize, lookup_norm_fast
from multike_tpu_torch.sampling import sample_shared_corruptions
from multike_tpu_torch.train import sparse_adagrad

STREAM_SPEC: Dict[str, Tuple[Tuple[str, ...], Tuple[str, ...]]] = {
    "rel_view": (("rv_ent",), ("rel",)),
    "ckge_rel": (("rv_ent",), ("rel",)),
    "ckgp_rel": (("rv_ent",), ("rel",)),
    "attr_view": (("av_ent",), ("attr", "conv_av")),
    "ckge_attr": (("av_ent",), ("attr", "conv_ckge")),
    "ckga_attr": (("av_ent",), ("attr", "conv_ckga")),
    "common_space": (("ent", "rv_ent", "av_ent"), ()),
    "space_mapping": (("ent",), ("nv_mapping", "rv_mapping", "av_mapping")),
}

STREAM_VARS: Dict[str, Tuple[str, ...]] = {
    s: rows + dense for s, (rows, dense) in STREAM_SPEC.items()}

# "auto" row-sparse thresholds: (min table rows, max touched fraction). The
# JAX package's fallback for device kinds it has no measurement for; no
# crossover has been measured on the card yet.
ROW_SPARSE_THRESHOLDS = (150_000, 0.25)

_LATER = "arrives in a later slice of the port"


def use_row_sparse(cfg: Config, table_rows: int,
                   ids_count: int | None = None) -> bool:
    """Row-sparse vs dense Adagrad. "auto" picks row-sparse when the step
    touches a small fraction of a big table, or the table is very big."""
    if cfg.optimizer != "Adagrad":
        return False
    mode = cfg.row_sparse_updates
    if mode in (True, "on", "true"):
        return True
    if mode in (False, "off", "false"):
        return False
    min_rows, max_frac = ROW_SPARSE_THRESHOLDS
    if ids_count is not None and ids_count <= max_frac * table_rows \
            and table_rows >= min_rows:
        return True
    return table_rows >= cfg.row_sparse_min_rows


def stream_lr(cfg: Config, stream: str) -> float:
    return cfg.ITC_learning_rate if stream == "common_space" \
        else cfg.learning_rate


def _require_adagrad(cfg: Config):
    if cfg.optimizer != "Adagrad":
        raise NotImplementedError(
            f"optimizer {cfg.optimizer!r}: only Adagrad is ported; the other "
            f"optimizers {_LATER}")


def init_stream_opt_states(cfg: Config, params) -> Dict:
    """Per-stream Adagrad accumulator dicts (format-compatible with both the
    row-sparse and the dense apply)."""
    _require_adagrad(cfg)
    return {stream: {k: sparse_adagrad.init_acc(params[k]) for k in names}
            for stream, names in STREAM_VARS.items()}


def _make_stream_update(cfg: Config, stream: str, prep, loss_fn):
    """Build ``update(params, opt_state, *batch) -> loss`` (a detached
    0-dim tensor); ``params`` and ``opt_state`` are updated in place.

    ``prep(*batch) -> (ids, aux)``: ``ids`` maps each row-sparse table name
    to its (N,) id vector.
    ``loss_fn(rows, dense, aux, *batch) -> loss``: ``rows[t]`` are the RAW
    gathered rows ``table[ids[t]]``, ``dense[k]`` the full small tables."""
    _require_adagrad(cfg)
    row_tables, dense_names = STREAM_SPEC[stream]
    names = row_tables + dense_names
    lr = stream_lr(cfg, stream)

    def update(params, opt_state, *batch):
        ids, aux = prep(*batch)
        sparse = use_row_sparse(cfg, params[row_tables[0]].shape[0],
                                ids_count=ids[row_tables[0]].shape[0])
        if sparse:
            rows = {t: params[t][ids[t]].requires_grad_() for t in row_tables}
            dense = {k: params[k].detach().requires_grad_()
                     for k in dense_names}
            loss = loss_fn(rows, dense, aux, *batch)
            grads = torch.autograd.grad(
                loss, [*rows.values(), *dense.values()])
            with torch.no_grad():
                for t, g in zip(row_tables, grads):
                    sparse_adagrad.row_apply(params[t], opt_state[t], ids[t],
                                             g, lr)
                for k, g in zip(dense_names, grads[len(row_tables):]):
                    sparse_adagrad.dense_apply(params[k], opt_state[k], g, lr)
            return loss.detach()

        leaves = {k: params[k].detach().requires_grad_() for k in names}
        rows = {t: leaves[t][ids[t]] for t in row_tables}
        dense = {k: leaves[k] for k in dense_names}
        loss = loss_fn(rows, dense, aux, *batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            for k, g in zip(names, grads):
                sparse_adagrad.dense_apply(params[k], opt_state[k], g, lr)
        return loss.detach()

    return update


# ---------------------------------------------------------------------------
# Batch plumbing helpers
# ---------------------------------------------------------------------------

def proportional_sizes(n1: int, n2: int, batch_size: int) -> Tuple[int, int]:
    bs1 = int(n1 / (n1 + n2) * batch_size)
    return bs1, batch_size - bs1


def _chunk_layout(bs: int, chunk_size: int) -> Tuple[int, int]:
    """(num_chunks, chunk_rows) with num_chunks * chunk_rows >= bs."""
    nc = max(1, -(-bs // max(1, chunk_size)))
    return nc, -(-bs // nc)


def _padded_epoch_indices(gen: torch.Generator, n: int, bs: int, bsp: int,
                          steps: int):
    """Shuffled wraparound index matrix (steps, bsp) + float mask. Real slots
    j < bs follow the reference's sequential epoch slicing (global position
    i*bs+j, tail masked); slots j >= bs are chunk padding, always masked.

    Invariant relied on downstream: within every row the mask is
    NONINCREASING (1s then 0s), so after reshaping a row into chunks the
    invalid slots form a contiguous suffix of each chunk (the neighbor-pool
    sampler of the truncated phase draws donors from each chunk's prefix)."""
    dev = gen.device
    perm = torch.randperm(n, generator=gen, device=dev)
    posg = torch.arange(steps * bs, device=dev)
    idx = perm[posg % max(n, 1)].reshape(steps, bs)
    m = (posg < n).to(torch.float32).reshape(steps, bs)
    if bsp > bs:
        idx = F.pad(idx, (0, bsp - bs))
        m = F.pad(m, (0, bsp - bs))
    return idx, m


def _split(rows, sizes):
    out, off = [], 0
    for sz in sizes:
        out.append(rows[off:off + sz])
        off += sz
    return out


# ---------------------------------------------------------------------------
# Relation view
# ---------------------------------------------------------------------------

class RelViewEpoch:
    """Relation-view TransE epoch with chunk-shared negatives.

    Each KG's sub-batch is split into chunks that share two candidate pools
    of C = ``cfg.neg_pool_size`` uniform draws from that KG's id range
    (head- and tail-corruption); every positive scores against all 2C pool
    members at pair weight K / (2C)
    (losses.chunk_shared_relation_logistic_loss).

    All entity-row reads of a step (both KGs' heads, tails and pools) go
    through ONE gather, so on the row-sparse path the step's gradient is ONE
    (ids, row-gradient) pair for one fused apply.

    ``epoch(params, opt_state, gen, triples1, triples2) -> loss sum`` trains
    in place; ``step(params, opt_state, pos1, m1, ch1, ct1, pos2, m2, ch2,
    ct2) -> loss`` is one batch with injected positives (bsp, 3), masks
    (bsp,) and pools (nc, C)."""

    def __init__(self, cfg: Config, n1: int, n2: int,
                 ranges: Tuple[Tuple[int, int], Tuple[int, int]]):
        self.n1, self.n2, self.ranges = n1, n2, ranges
        self.steps = int(np.ceil((n1 + n2) / cfg.batch_size))
        self.bs1, self.bs2 = proportional_sizes(n1, n2, cfg.batch_size)
        self.pool = cfg.neg_pool_size or cfg.neg_triple_num
        self.neg_w = cfg.neg_triple_num / (2.0 * self.pool)
        self.nc1, self.s1 = _chunk_layout(self.bs1, cfg.neg_chunk_size)
        self.nc2, self.s2 = _chunk_layout(self.bs2, cfg.neg_chunk_size)
        self.bsp1, self.bsp2 = self.nc1 * self.s1, self.nc2 * self.s2
        self.sizes = [self.bsp1, self.bsp1, self.nc1 * self.pool,
                      self.nc1 * self.pool, self.bsp2, self.bsp2,
                      self.nc2 * self.pool, self.nc2 * self.pool]
        self.trained_per_epoch = min(n1, self.steps * self.bs1) + \
            min(n2, self.steps * self.bs2)
        self._update = _make_stream_update(cfg, "rel_view", self._prep,
                                           self._loss)

    def _prep(self, pos1, m1, ch1, ct1, pos2, m2, ch2, ct2):
        parts = [pos1[:, 0], pos1[:, 2], ch1.reshape(-1), ct1.reshape(-1),
                 pos2[:, 0], pos2[:, 2], ch2.reshape(-1), ct2.reshape(-1)]
        return {"rv_ent": torch.cat(parts)}, None

    def _loss(self, rows, dense, aux, pos1, m1, ch1, ct1, pos2, m2, ch2, ct2):
        rv_rows = l2_normalize(rows["rv_ent"], axis=-1)
        dim = rv_rows.shape[-1]
        prs_all = lookup_norm_fast(dense["rel"],
                                   torch.cat([pos1[:, 1], pos2[:, 1]]))
        prs1, prs2 = prs_all[:pos1.shape[0]], prs_all[pos1.shape[0]:]
        ph1, pt1, ch1r, ct1r, ph2, pt2, ch2r, ct2r = _split(rv_rows,
                                                            self.sizes)
        loss = torch.zeros((), dtype=rv_rows.dtype, device=rv_rows.device)
        for bs, nc, s, ph, pr, pt, chr_, ctr, m in (
                (self.bs1, self.nc1, self.s1, ph1, prs1, pt1, ch1r, ct1r, m1),
                (self.bs2, self.nc2, self.s2, ph2, prs2, pt2, ch2r, ct2r, m2)):
            if bs > 0:
                loss = loss + chunk_shared_relation_logistic_loss(
                    ph.reshape(nc, s, dim), pr.reshape(nc, s, dim),
                    pt.reshape(nc, s, dim), chr_.reshape(nc, self.pool, dim),
                    ctr.reshape(nc, self.pool, dim), neg_weight=self.neg_w,
                    pos_mask=m.reshape(nc, s))
        return loss

    def step(self, params, opt_state, pos1, m1, ch1, ct1, pos2, m2, ch2, ct2):
        return self._update(params, opt_state, pos1, m1, ch1, ct1, pos2, m2,
                            ch2, ct2)

    def draw(self, gen: torch.Generator, triples1, triples2):
        """Every step's inputs for one epoch, each stacked over steps:
        positives, masks and both pools of each KG."""
        (lo1, hi1), (lo2, hi2) = self.ranges
        steps = self.steps
        idx1, m1 = _padded_epoch_indices(gen, self.n1, self.bs1, self.bsp1,
                                         steps)
        idx2, m2 = _padded_epoch_indices(gen, self.n2, self.bs2, self.bsp2,
                                         steps)
        ch1, ct1 = sample_shared_corruptions(gen, steps * self.nc1, self.pool,
                                             lo1, hi1)
        ch2, ct2 = sample_shared_corruptions(gen, steps * self.nc2, self.pool,
                                             lo2, hi2)
        shape1, shape2 = (steps, self.nc1, self.pool), (steps, self.nc2,
                                                        self.pool)
        return (triples1[idx1], m1, ch1.reshape(shape1), ct1.reshape(shape1),
                triples2[idx2], m2, ch2.reshape(shape2), ct2.reshape(shape2))

    def __call__(self, params, opt_state, gen: torch.Generator, triples1,
                 triples2):
        xs = self.draw(gen, triples1, triples2)
        total = torch.zeros((), dtype=torch.float32, device=gen.device)
        for i in range(self.steps):
            total += self.step(params, opt_state, *(x[i] for x in xs))
        return total


class SampledEpoch:
    """Epoch of a stream that draws each step's batch without replacement
    from ``n`` items (the reference's ``random.sample``).
    ``epoch(params, opt_state, gen, data) -> loss sum`` trains in place;
    ``step(params, opt_state, batch) -> loss`` is one injected batch."""

    def __init__(self, cfg: Config, stream: str, n: int, batch_size: int,
                 prep, loss_fn):
        self.n = n
        self.steps = max(1, int(np.ceil(n / batch_size)))
        self.bs = batch_size if self.steps > 1 else n
        self.trained_per_epoch = self.steps * self.bs
        self.step = _make_stream_update(cfg, stream, prep, loss_fn)

    def __call__(self, params, opt_state, gen: torch.Generator, data):
        total = torch.zeros((), dtype=torch.float32, device=gen.device)
        for _ in range(self.steps):
            sel = torch.randperm(self.n, generator=gen,
                                 device=gen.device)[:self.bs]
            total += self.step(params, opt_state, data[sel])
        return total


def build_ckge_rel_epoch(cfg: Config, n: int):
    """Cross-KG entity inference in the relation view: the swapped
    supervision triples, positives only, loss weight 2. Returns ``(epoch,
    steps, trained_per_epoch)``; ``epoch(params, opt_state, gen, triples)``.
    """
    def prep(pos):
        # one fused entity gather -> one row-sparse apply
        return {"rv_ent": torch.cat([pos[:, 0], pos[:, 2]])}, None

    def loss_fn(rows, dense, aux, pos):
        hrows = l2_normalize(rows["rv_ent"], axis=-1)
        phs, pts = hrows[:pos.shape[0]], hrows[pos.shape[0]:]
        prs = lookup_norm_fast(dense["rel"], pos[:, 1])
        return 2.0 * relation_logistic_loss_wo_negs(phs, prs, pts)

    epoch = SampledEpoch(cfg, "ckge_rel", n, cfg.batch_size, prep, loss_fn)
    return epoch, epoch.steps, epoch.trained_per_epoch


def build_rel_view_epoch(cfg: Config, n1: int, n2: int,
                         ranges: Tuple[Tuple[int, int], Tuple[int, int]],
                         with_neighbors: bool = False):
    """Relation-view epoch of the uniform phase. Returns ``(epoch, steps,
    trained_per_epoch)``; ``epoch`` is a :class:`RelViewEpoch`."""
    if cfg.truncated_neg_scheme not in ("per_slot", "chunk_shared"):
        raise ValueError(f"truncated_neg_scheme must be 'per_slot' or "
                         f"'chunk_shared', got {cfg.truncated_neg_scheme!r}")
    if cfg.neg_scheme not in ("per_slot", "chunk_shared"):
        raise ValueError(f"neg_scheme must be 'per_slot' or 'chunk_shared', "
                         f"got {cfg.neg_scheme!r}")
    if with_neighbors:
        raise NotImplementedError(
            f"neighbor-truncated sampling {_LATER} (the truncated phase)")
    if cfg.neg_scheme == "per_slot":
        raise NotImplementedError(
            f"neg_scheme='per_slot' {_LATER} (per-slot sampling with the "
            "Bloom TripleFilter)")
    if cfg.chunk_exact_rejection:
        raise NotImplementedError(
            f"chunk_exact_rejection {_LATER} (the Bloom TripleFilter)")
    epoch = RelViewEpoch(cfg, n1, n2, ranges)
    return epoch, epoch.steps, epoch.trained_per_epoch
