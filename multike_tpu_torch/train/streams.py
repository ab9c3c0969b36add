"""Per-loss training streams (counterpart of multike_tpu/train/streams.py).

All eight streams are ported: the relation view (``rel_view``, in the
uniform phase and, after the first neighbor refresh, in the truncated
phase, with chunk-shared pools or per-slot draws, and optional Bloom
rejection of true triples), the attribute view (``attr_view``), the
cross-KG inference streams (``ckge_rel``, ``ckgp_rel``, ``ckge_attr``,
``ckga_attr``), the ITC combination (``common_space``) and the SSL
combination (``space_mapping``).

Each epoch draws its indices (and the rel_view negatives) up front, then
runs one public step function per batch, so the tests can hold a step with
injected inputs against a step composed from the JAX package.

Each stream is written as ``(prep, loss_fn)``: ``prep`` builds the row-id
vectors, ``loss_fn`` consumes the RAW gathered rows, so the update can run
on either of two same-math paths:

  * row-sparse Adagrad (train/sparse_adagrad.py): gradients are taken with
    respect to the gathered rows and applied to those rows only, one K1
    launch per row table;
  * dense: gradients flow through the gather to the full tables, then
    dense Adagrad, or Adam, Adadelta or SGD (train/optimizers.py), which
    always take this path, as in the JAX package.

With a ``MeshContext`` (``pctx``, parallel/context.py) a step runs on a
('dp', 'tp') mesh of ranks: every rank draws the whole batch with its own
generator, seeded alike, takes its dp block of the loss's leading axis (a
stream's ``shard``), gathers the rows that block uses (over tp when the
table is row-sharded), and sums its loss and dense gradients with the other
dp ranks in one all-reduce; the row gradients go to
``row_apply_sharded``. The losses are sums over the batch but for two
whole-batch norms (the conv scorer's and space_mapping's), summed over the
ranks by a differentiable all-reduce, and space_mapping's
batch-independent terms, counted on the first dp rank only.

Parameters and accumulators are updated in place. Unlike the JAX package,
the sampled streams draw from their lists' true length: there are no
capacity buckets (those only spared XLA a recompile, and their wrap
padding repeated triples).

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
from multike_tpu_torch.losses import (alignment_loss,
                                      chunk_shared_relation_logistic_loss,
                                      lean_relation_logistic_loss,
                                      logistic_loss_wo_negs,
                                      positive_logistic_from_scores,
                                      relation_logistic_loss_wo_negs,
                                      space_mapping_loss)
from multike_tpu_torch.parallel import distributed
from multike_tpu_torch.parallel.context import gather_rows, row_apply_sharded
from multike_tpu_torch.params import l2_normalize, lookup_norm
from multike_tpu_torch.sampling import (TripleFilter, sample_corruptions,
                                        sample_shared_corruptions,
                                        sample_shared_neighbor_corruptions,
                                        triple_filter_contains)
from multike_tpu_torch.train import optimizers, sparse_adagrad
from multike_tpu_torch.utils.profiling import count, span
from multike_tpu_torch.views.attr_conv import conv_score

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


def init_stream_opt_states(cfg: Config, params, pctx=None) -> Dict:
    """Per-stream optimizer states: Adagrad accumulator dicts
    (format-compatible with both the row-sparse and the dense apply), or
    the Adam / Adadelta / SGD states of ``train/optimizers.py`` over the
    stream's variables. A mesh (``pctx``) always takes the accumulators."""
    if pctx is not None or cfg.optimizer == "Adagrad":
        return {stream: {k: sparse_adagrad.init_acc(params[k])
                         for k in names}
                for stream, names in STREAM_VARS.items()}
    return {stream: optimizers.init_state(cfg.optimizer,
                                          {k: params[k] for k in names})
            for stream, names in STREAM_VARS.items()}


def _leaves(tree):
    """The tensors of a tensor or nested dict, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _rebuild(tree, it):
    """``tree``'s structure filled from the iterator ``it``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    return next(it)


def _grad_leaf(tree):
    if isinstance(tree, dict):
        return {k: _grad_leaf(v) for k, v in tree.items()}
    return tree.detach().requires_grad_()


def _dp_shard(pctx, *batch):
    """The rank's dp block of each batch tensor's leading axis (constants
    dicts and None pass through)."""
    return tuple(x if x is None or isinstance(x, dict)
                 else x[pctx.dp_block(x.shape[0])] for x in batch)


def _batch_sum(pctx):
    """The differentiable sum over the dp ranks that the whole-batch norms
    take (None without a mesh)."""
    if pctx is None:
        return None
    return lambda x: distributed.all_reduce_sum(x, pctx.dp_group)


def _make_stream_update(cfg: Config, stream: str, prep, loss_fn,
                        frozen: Tuple[str, ...] = (), pctx=None, shard=None):
    """Build ``update(params, opt_state, *batch) -> loss`` (a detached
    0-dim tensor); ``params`` and ``opt_state`` are updated in place.

    ``prep(*batch) -> (ids, aux)``: ``ids`` maps each row-sparse table name
    to its (N,) id vector.
    ``loss_fn(rows, dense, aux, *batch) -> loss``: ``rows[t]`` are the RAW
    gathered rows ``table[ids[t]]``, ``dense[k]`` the full small tables
    (a nested dict for a conv scorer).
    ``frozen``: tables the loss reads without training them (the JAX
    package's ``stopped`` reads). The loss then gets, in place of prep's
    ``aux``, their RAW rows at the first row table's ids, without
    gradient: ``aux[t]``.
    ``pctx``: the mesh (row-sparse Adagrad only). ``batch`` is then the
    whole batch and ``shard(pctx, *batch)`` (default: the dp block of every
    tensor's leading axis) this rank's part; the returned loss is the whole
    batch's."""
    row_tables, dense_names = STREAM_SPEC[stream]
    names = row_tables + dense_names
    lr = stream_lr(cfg, stream)
    adagrad = cfg.optimizer == "Adagrad"
    if pctx is not None and (not adagrad or cfg.row_sparse_updates in
                             (False, "off", "false")):
        raise ValueError("mesh training runs on the row-sparse Adagrad path: "
                         "optimizer must be Adagrad and row_sparse_updates "
                         "not off")
    shard = shard or _dp_shard

    def step(params, opt_state, *batch):
        with span("step.gather"):
            if pctx is not None:
                batch = shard(pctx, *batch)
            ids, aux = prep(*batch)
            if frozen:
                with torch.no_grad():
                    aux = {t: gather_rows(pctx, t, params[t],
                                          ids[row_tables[0]])
                           for t in frozen}
            sparse = pctx is not None or use_row_sparse(
                cfg, params[row_tables[0]].shape[0],
                ids_count=ids[row_tables[0]].shape[0])
            if sparse:
                rows = {t: gather_rows(pctx, t, params[t], ids[t])
                        .requires_grad_() for t in row_tables}
                dense = {k: _grad_leaf(params[k]) for k in dense_names}
            else:
                leaves = {k: _grad_leaf(params[k]) for k in names}
                rows = {t: leaves[t][ids[t]] for t in row_tables}
                dense = {k: leaves[k] for k in dense_names}
        with span("step.forward"):
            loss = loss_fn(rows, dense, aux, *batch)
        if not sparse:
            with span("step.backward"):
                grads = _rebuild(leaves, iter(torch.autograd.grad(
                    loss, _leaves(leaves))))
            with span("step.apply"), torch.no_grad():
                if adagrad:
                    for k in names:
                        sparse_adagrad.dense_apply(params[k], opt_state[k],
                                                   grads[k], lr)
                else:
                    optimizers.apply(cfg.optimizer,
                                     {k: params[k] for k in names},
                                     opt_state, grads, lr)
            return loss.detach()

        with span("step.backward"):
            grads = torch.autograd.grad(
                loss, list(rows.values()) + _leaves(dense))
        loss = loss.detach()
        g_dense = grads[len(row_tables):]
        sizes = {}
        if pctx is not None:
            # one sum over dp: the whole batch's loss, every rank's id
            # count of each row table (in its own slot) and the dense
            # gradients
            with span("step.allreduce"):
                counts = torch.zeros(len(row_tables), pctx.dp,
                                     device=loss.device)
                for i, t in enumerate(row_tables):
                    counts[i, pctx.dp_index] = ids[t].shape[0]
                flat = distributed.all_reduce(torch.cat(
                    [loss.reshape(1), counts.reshape(-1)]
                    + [g.reshape(-1) for g in g_dense]), pctx.dp_group)
                loss = flat[0]
                for i, t in enumerate(row_tables):
                    sizes[t] = flat[1 + i * pctx.dp:1 + (i + 1) * pctx.dp
                                    ].long().tolist()
                g_dense = [x.view_as(g) for x, g in zip(
                    flat[1 + counts.numel():].split(
                        [g.numel() for g in g_dense]), g_dense)]
        g_dense = iter(g_dense)
        with span("step.apply"), torch.no_grad():
            for t, g in zip(row_tables, grads):
                if pctx is not None:
                    row_apply_sharded(pctx, t, params[t], opt_state[t],
                                      ids[t], g, lr, sizes[t])
                else:
                    sparse_adagrad.row_apply(params[t], opt_state[t],
                                             ids[t], g, lr)
            for k in dense_names:
                sparse_adagrad.dense_apply(
                    params[k], opt_state[k], _rebuild(dense[k], g_dense),
                    lr)
        return loss

    step_span = stream + ".step"

    def update(params, opt_state, *batch):
        with span(step_span):
            return step(params, opt_state, *batch)

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


# ---------------------------------------------------------------------------
# Relation view
# ---------------------------------------------------------------------------

class RelViewEpoch:
    """Relation-view TransE epoch with chunk-shared negatives.

    Each KG's sub-batch is split into chunks that share two candidate pools
    of C draws from that KG's id range (head- and tail-corruption); every
    positive scores against all 2C pool members at pair weight K / (2C)
    (losses.chunk_shared_relation_logistic_loss). In the uniform phase the
    pools are uniform, with chunks of ``neg_chunk_size`` and C =
    ``neg_pool_size``; in the truncated phase (``with_neighbors``) they are
    drawn from the chunk members' neighbor rows
    (sampling.sample_shared_neighbor_corruptions), with chunks of
    ``truncated_chunk_size`` and C = ``truncated_pool_size``.

    With a Bloom filter and ``chunk_exact_rejection``, each step masks out
    the (positive, pool candidate) pairs that test positive as true triples
    (:meth:`chunk_keep_masks`).

    All entity-row reads of a step (both KGs' heads, tails and pools) go
    through ONE gather, so on the row-sparse path the step's gradient is ONE
    (ids, row-gradient) pair for one fused apply.

    ``epoch(params, opt_state, gen, triples1, triples2, neighbors=None) ->
    loss sum`` trains in place; ``step(params, opt_state, pos1, m1, ch1,
    ct1, pos2, m2, ch2, ct2) -> loss`` is one batch with injected positives
    (bsp, 3), masks (bsp,) and pools (nc, C).

    On a mesh each dp rank takes its block of every chunk's rows, with the
    chunk's whole pools (:meth:`shard`): the pool rows' gradients of the
    ranks sum in the sparse apply, as the positives' terms sum in the
    loss."""

    scheme = "chunk_shared"
    dropped = None            # no per-slot drop count in this scheme

    def __init__(self, cfg: Config, n1: int, n2: int,
                 ranges: Tuple[Tuple[int, int], Tuple[int, int]],
                 with_neighbors: bool = False,
                 tfilter: TripleFilter | None = None, pctx=None):
        self.n1, self.n2, self.ranges = n1, n2, ranges
        self.with_neighbors = with_neighbors
        self.tfilter = tfilter if cfg.chunk_exact_rejection else None
        self.steps = int(np.ceil((n1 + n2) / cfg.batch_size))
        self.bs1, self.bs2 = proportional_sizes(n1, n2, cfg.batch_size)
        self.pool = cfg.neg_pool_size or cfg.neg_triple_num
        chunk = cfg.neg_chunk_size
        if with_neighbors:
            self.pool = cfg.truncated_pool_size or self.pool
            chunk = cfg.truncated_chunk_size
        self.neg_w = cfg.neg_triple_num / (2.0 * self.pool)
        self.nc1, self.s1 = _chunk_layout(self.bs1, chunk)
        self.nc2, self.s2 = _chunk_layout(self.bs2, chunk)
        self.bsp1, self.bsp2 = self.nc1 * self.s1, self.nc2 * self.s2
        self.sizes = [self.bsp1, self.bsp1, self.nc1 * self.pool,
                      self.nc1 * self.pool, self.bsp2, self.bsp2,
                      self.nc2 * self.pool, self.nc2 * self.pool]
        self.trained_per_epoch = min(n1, self.steps * self.bs1) + \
            min(n2, self.steps * self.bs2)
        self._update = _make_stream_update(cfg, "rel_view", self._prep,
                                           self._loss, pctx=pctx,
                                           shard=self.shard)

    def shard(self, pctx, pos1, m1, ch1, ct1, pos2, m2, ch2, ct2):
        """This dp rank's block of the rows of every chunk, with all the
        pools."""
        out = []
        for pos, m, ch, ct, nc, s in ((pos1, m1, ch1, ct1, self.nc1, self.s1),
                                      (pos2, m2, ch2, ct2, self.nc2, self.s2)):
            sl = pctx.dp_block(s)
            out += [pos.reshape(nc, s, 3)[:, sl].reshape(-1, 3),
                    m.reshape(nc, s)[:, sl].reshape(-1), ch, ct]
        return out

    def chunk_keep_masks(self, pos, ch, ct, nc, s):
        """Bloom keep masks of one KG's two pools, each (nc, s, C):
        ``keep_h[c, i, j]`` is 0 iff (ch[c, j], r_i, t_i) tests positive,
        ``keep_t[c, i, j]`` is 0 iff (h_i, r_i, ct[c, j]) does; (None, None)
        without exact rejection."""
        if self.tfilter is None:
            return None, None
        h, r, t = (pos[:, k].reshape(nc, s, 1) for k in range(3))
        bad_h = triple_filter_contains(self.tfilter, ch[:, None, :], r, t)
        bad_t = triple_filter_contains(self.tfilter, h, r, ct[:, None, :])
        return (1.0 - bad_h.to(torch.float32),
                1.0 - bad_t.to(torch.float32))

    def _prep(self, pos1, m1, ch1, ct1, pos2, m2, ch2, ct2):
        parts = [pos1[:, 0], pos1[:, 2], ch1.reshape(-1), ct1.reshape(-1),
                 pos2[:, 0], pos2[:, 2], ch2.reshape(-1), ct2.reshape(-1)]
        # (a mesh rank holds s / dp rows of each chunk)
        keep = tuple(self.chunk_keep_masks(pos, ch, ct, ch.shape[0],
                                           pos.shape[0] // ch.shape[0])
                     for pos, ch, ct in ((pos1, ch1, ct1), (pos2, ch2, ct2)))
        return {"rv_ent": torch.cat(parts)}, keep

    def _loss(self, rows, dense, aux, pos1, m1, ch1, ct1, pos2, m2, ch2, ct2):
        rv_rows = l2_normalize(rows["rv_ent"], axis=-1)
        dim = rv_rows.shape[-1]
        prs_all = lookup_norm(dense["rel"],
                              torch.cat([pos1[:, 1], pos2[:, 1]]))
        prs1, prs2 = prs_all[:pos1.shape[0]], prs_all[pos1.shape[0]:]
        # the sizes of the rows in hand: a mesh rank holds s / dp rows of
        # each chunk
        sizes = [n for pos, ch in ((pos1, ch1), (pos2, ch2))
                 for n in (pos.shape[0], pos.shape[0], ch.numel(), ch.numel())]
        # one split: one backward node, where slices would each write a
        # zero-filled gradient of all the rows
        ph1, pt1, ch1r, ct1r, ph2, pt2, ch2r, ct2r = torch.split(rv_rows,
                                                                 sizes)
        loss = torch.zeros((), dtype=rv_rows.dtype, device=rv_rows.device)
        for bs, nc, ph, pr, pt, chr_, ctr, m, (keep_h, keep_t) in (
                (self.bs1, self.nc1, ph1, prs1, pt1, ch1r, ct1r, m1, aux[0]),
                (self.bs2, self.nc2, ph2, prs2, pt2, ch2r, ct2r, m2, aux[1])):
            s = ph.shape[0] // nc
            if bs > 0:
                loss = loss + chunk_shared_relation_logistic_loss(
                    ph.reshape(nc, s, dim), pr.reshape(nc, s, dim),
                    pt.reshape(nc, s, dim), chr_.reshape(nc, self.pool, dim),
                    ctr.reshape(nc, self.pool, dim), neg_weight=self.neg_w,
                    pos_mask=m.reshape(nc, s), keep_h=keep_h, keep_t=keep_t)
        return loss

    def step(self, params, opt_state, pos1, m1, ch1, ct1, pos2, m2, ch2, ct2):
        return self._update(params, opt_state, pos1, m1, ch1, ct1, pos2, m2,
                            ch2, ct2)

    def _pools(self, gen, pos, m, nc, s, lo, hi, neighbors):
        steps = self.steps
        if self.with_neighbors:
            # every step's chunks in one draw: a chunk's donors never leave
            # the chunk, whichever step it belongs to
            ch, ct = sample_shared_neighbor_corruptions(
                gen, pos.reshape(-1, 3), steps * nc, s, self.pool, lo, hi,
                neighbors, mask=m.reshape(-1))
        else:
            ch, ct = sample_shared_corruptions(gen, steps * nc, self.pool,
                                               lo, hi)
        shape = (steps, nc, self.pool)
        return ch.reshape(shape), ct.reshape(shape)

    def draw(self, gen: torch.Generator, triples1, triples2, neighbors=None):
        """Every step's inputs for one epoch, each stacked over steps:
        positives, masks and both pools of each KG."""
        if self.with_neighbors and neighbors is None:
            raise ValueError("the truncated phase needs a NeighborState")
        (lo1, hi1), (lo2, hi2) = self.ranges
        steps = self.steps
        with span("rel_view.draw"):
            with span("draw.positives"):
                idx1, m1 = _padded_epoch_indices(gen, self.n1, self.bs1,
                                                 self.bsp1, steps)
                idx2, m2 = _padded_epoch_indices(gen, self.n2, self.bs2,
                                                 self.bsp2, steps)
                pos1, pos2 = triples1[idx1], triples2[idx2]
            with span("draw.negatives"):
                ch1, ct1 = self._pools(gen, pos1, m1, self.nc1, self.s1,
                                       lo1, hi1, neighbors)
                ch2, ct2 = self._pools(gen, pos2, m2, self.nc2, self.s2,
                                       lo2, hi2, neighbors)
        return pos1, m1, ch1, ct1, pos2, m2, ch2, ct2

    def __call__(self, params, opt_state, gen: torch.Generator, triples1,
                 triples2, neighbors=None):
        with span("rel_view.epoch"):
            xs = self.draw(gen, triples1, triples2, neighbors)
            total = torch.zeros((), dtype=torch.float32, device=gen.device)
            for i in range(self.steps):
                total += self.step(params, opt_state, *(x[i] for x in xs))
        return total


class PerSlotRelViewEpoch:
    """Relation-view TransE epoch with per-slot negatives, the reference's
    regime: every positive has ``neg_triple_num`` slots, each flipping its
    own head-or-tail coin and drawing its own candidate from the KG's id
    range or, in the truncated phase, from the corrupted entity's neighbor
    row (sampling.sample_corruptions). The loss is
    ``losses.lean_relation_logistic_loss``: negatives reuse the positive
    rows for the uncorrupted side, so a step gathers B * (2 + K) rows.

    With a Bloom filter (``tfilter``), true triples are rejected as the JAX
    package does. The whole epoch's draws are presampled in one pass unless
    ``neg_reject_mode == "resample"`` and ``neg_rejection_tries > 0``; the
    presampled pass always uses "drop" (a keep mask of 0.0 on the slots
    that test positive), whatever ``neg_reject_mode`` says. Otherwise every
    step draws its own candidates and redraws the positives in up to
    ``neg_rejection_tries`` rounds, each with a host sync.

    ``epoch(params, opt_state, gen, triples1, triples2, neighbors=None) ->
    loss sum`` trains in place; ``step(params, opt_state, pos1, m1, cand1,
    hb1, keep1, pos2, m2, cand2, hb2, keep2) -> loss`` is one batch with
    injected positives (bs, 3), masks (bs,), candidates (bs, K),
    corrupt-head coins (bs, K) and keep masks (bs, K) or None. After each
    epoch, ``dropped`` holds the count of real slots the filter dropped
    (a device scalar; None without "drop" rejection) out of ``slots``."""

    scheme = "per_slot"

    def __init__(self, cfg: Config, n1: int, n2: int,
                 ranges: Tuple[Tuple[int, int], Tuple[int, int]],
                 with_neighbors: bool = False,
                 tfilter: TripleFilter | None = None, pctx=None):
        self.n1, self.n2, self.ranges = n1, n2, ranges
        self.with_neighbors = with_neighbors
        self.tfilter = tfilter
        self.neg_num = cfg.neg_triple_num
        self.retries = cfg.neg_rejection_tries
        self.reject_mode = cfg.neg_reject_mode
        self.steps = int(np.ceil((n1 + n2) / cfg.batch_size))
        self.bs1, self.bs2 = proportional_sizes(n1, n2, cfg.batch_size)
        self.sizes = [self.bs1, self.bs1, self.bs1 * self.neg_num,
                      self.bs2, self.bs2, self.bs2 * self.neg_num]
        self.trained_per_epoch = min(n1, self.steps * self.bs1) + \
            min(n2, self.steps * self.bs2)
        self.slots = self.trained_per_epoch * self.neg_num
        self.presample = (tfilter is None or self.retries == 0
                          or self.reject_mode == "drop")
        self.dropped = None
        self._update = _make_stream_update(cfg, "rel_view", self._prep,
                                           self._loss, pctx=pctx)

    def _prep(self, pos1, m1, cand1, hb1, keep1, pos2, m2, cand2, hb2,
              keep2):
        parts = [pos1[:, 0], pos1[:, 2], cand1.reshape(-1),
                 pos2[:, 0], pos2[:, 2], cand2.reshape(-1)]
        return {"rv_ent": torch.cat(parts)}, None

    def _loss(self, rows, dense, aux, pos1, m1, cand1, hb1, keep1, pos2, m2,
              cand2, hb2, keep2):
        rv_rows = l2_normalize(rows["rv_ent"], axis=-1)
        dim = rv_rows.shape[-1]
        prs_all = lookup_norm(dense["rel"],
                              torch.cat([pos1[:, 1], pos2[:, 1]]))
        prs1, prs2 = prs_all[:pos1.shape[0]], prs_all[pos1.shape[0]:]
        # the rows in hand: a mesh rank holds its dp block of each KG's
        sizes = [n for pos, cand in ((pos1, cand1), (pos2, cand2))
                 for n in (pos.shape[0], pos.shape[0], cand.numel())]
        # one split: one backward node, where slices would each write a
        # zero-filled gradient of all the rows
        ph1, pt1, c1, ph2, pt2, c2 = torch.split(rv_rows, sizes)
        loss = torch.zeros((), dtype=rv_rows.dtype, device=rv_rows.device)
        for bs, ph, pr, pt, c, hb, keep, m in (
                (self.bs1, ph1, prs1, pt1, c1, hb1, keep1, m1),
                (self.bs2, ph2, prs2, pt2, c2, hb2, keep2, m2)):
            if bs > 0:
                loss = loss + lean_relation_logistic_loss(
                    ph, pr, pt, c.reshape(ph.shape[0], self.neg_num, dim),
                    hb, m, neg_keep=keep)
        return loss

    def step(self, params, opt_state, pos1, m1, cand1, hb1, keep1, pos2, m2,
             cand2, hb2, keep2):
        return self._update(params, opt_state, pos1, m1, cand1, hb1, keep1,
                            pos2, m2, cand2, hb2, keep2)

    def _positives(self, gen, triples1, triples2, neighbors):
        if self.with_neighbors and neighbors is None:
            raise ValueError("the truncated phase needs a NeighborState")
        with span("draw.positives"):
            idx1, m1 = _padded_epoch_indices(gen, self.n1, self.bs1,
                                             self.bs1, self.steps)
            idx2, m2 = _padded_epoch_indices(gen, self.n2, self.bs2,
                                             self.bs2, self.steps)
            return triples1[idx1], m1, triples2[idx2], m2

    def _corrupt(self, gen, pos, lo, hi, neighbors, mode):
        with span("draw.negatives"):
            cand, hb, keep = sample_corruptions(
                gen, pos.reshape(-1, 3), lo, hi, self.neg_num,
                neighbors if self.with_neighbors else None,
                tfilter=self.tfilter, retries=self.retries, reject_mode=mode)
        shape = pos.shape[:-1] + (self.neg_num,)
        return (cand.reshape(shape), hb.reshape(shape),
                None if keep is None else keep.reshape(shape))

    def draw(self, gen: torch.Generator, triples1, triples2, neighbors=None):
        """Every step's inputs for one presampled epoch, each stacked over
        steps: positives, masks, candidates, coins and keep masks of each
        KG (all-ones keep masks without a filter)."""
        mode = "drop" if self.tfilter is not None else "resample"
        with span("rel_view.draw"):
            pos1, m1, pos2, m2 = self._positives(gen, triples1, triples2,
                                                 neighbors)
            (lo1, hi1), (lo2, hi2) = self.ranges
            out = []
            self.dropped = None
            for pos, m, lo, hi in ((pos1, m1, lo1, hi1),
                                   (pos2, m2, lo2, hi2)):
                cand, hb, keep = self._corrupt(gen, pos, lo, hi, neighbors,
                                               mode)
                if keep is None:
                    keep = torch.ones(cand.shape, dtype=torch.float32,
                                      device=cand.device)
                else:
                    drop = ((1.0 - keep) * m[..., None]).sum()
                    self.dropped = drop if self.dropped is None \
                        else self.dropped + drop
                out += [pos, m, cand, hb, keep]
        if self.dropped is not None:
            count("sampling.dropped", self.dropped)
            count("sampling.slots", self.slots)
        return tuple(out)

    def __call__(self, params, opt_state, gen: torch.Generator, triples1,
                 triples2, neighbors=None):
        with span("rel_view.epoch"):
            return self._epoch(params, opt_state, gen, triples1, triples2,
                               neighbors)

    def _epoch(self, params, opt_state, gen, triples1, triples2, neighbors):
        total = torch.zeros((), dtype=torch.float32, device=gen.device)
        if self.presample:
            xs = self.draw(gen, triples1, triples2, neighbors)
            for i in range(self.steps):
                total += self.step(params, opt_state, *(x[i] for x in xs))
            return total
        # in-step resampling: each step draws, then redraws its offenders
        self.dropped = None
        with span("rel_view.draw"):
            pos1, m1, pos2, m2 = self._positives(gen, triples1, triples2,
                                                 neighbors)
        (lo1, hi1), (lo2, hi2) = self.ranges
        for i in range(self.steps):
            with span("rel_view.draw"):
                c1 = self._corrupt(gen, pos1[i], lo1, hi1, neighbors,
                                   "resample")
                c2 = self._corrupt(gen, pos2[i], lo2, hi2, neighbors,
                                   "resample")
            total += self.step(params, opt_state, pos1[i], m1[i], *c1,
                               pos2[i], m2[i], *c2)
        return total


def build_rel_view_epoch(cfg: Config, n1: int, n2: int,
                         ranges: Tuple[Tuple[int, int], Tuple[int, int]],
                         with_neighbors: bool = False,
                         tfilter: TripleFilter | None = None, pctx=None):
    """Relation-view epoch, uniform phase or (``with_neighbors``) truncated
    phase, in the phase's scheme (``neg_scheme`` / ``truncated_neg_scheme``).
    ``tfilter``: the Bloom filter of the true triples, read by per-slot
    rejection and by ``chunk_exact_rejection``. ``pctx``: the mesh, if
    any. Returns ``(epoch, steps, trained_per_epoch)``; ``epoch`` is a
    :class:`RelViewEpoch` or a :class:`PerSlotRelViewEpoch`."""
    if cfg.truncated_neg_scheme not in ("per_slot", "chunk_shared"):
        raise ValueError(f"truncated_neg_scheme must be 'per_slot' or "
                         f"'chunk_shared', got {cfg.truncated_neg_scheme!r}")
    if cfg.neg_scheme not in ("per_slot", "chunk_shared"):
        raise ValueError(f"neg_scheme must be 'per_slot' or 'chunk_shared', "
                         f"got {cfg.neg_scheme!r}")
    if cfg.neg_reject_mode not in ("drop", "resample"):
        raise ValueError(f"neg_reject_mode must be 'drop' or 'resample', "
                         f"got {cfg.neg_reject_mode!r}")
    scheme = cfg.truncated_neg_scheme if with_neighbors else cfg.neg_scheme
    cls = PerSlotRelViewEpoch if scheme == "per_slot" else RelViewEpoch
    epoch = cls(cfg, n1, n2, ranges, with_neighbors, tfilter, pctx)
    return epoch, epoch.steps, epoch.trained_per_epoch


# ---------------------------------------------------------------------------
# Attribute view
# ---------------------------------------------------------------------------

class AttrViewEpoch:
    """Attribute-view epoch: weighted positives only, scored by the conv
    scorer. A reference quirk is kept: steps are counted with
    ``batch_size`` but each KG's slice is sized from
    ``attribute_batch_size``.

    ``epoch(params, opt_state, gen, constants, trips1, w1, trips2, w2)``
    trains in place; ``step(params, opt_state, constants, trip, w, mask)``
    is one injected batch of both KGs' triples (B, 3), weights and mask."""

    def __init__(self, cfg: Config, n1: int, n2: int, pctx=None):
        self.n1, self.n2 = n1, n2
        self.steps = int(np.ceil((n1 + n2) / cfg.batch_size))
        self.bs1, self.bs2 = proportional_sizes(n1, n2,
                                                cfg.attribute_batch_size)
        self.trained_per_epoch = min(n1, self.steps * self.bs1) + \
            min(n2, self.steps * self.bs2)

        def prep(constants, trip, w, mask):
            return {"av_ent": trip[:, 0]}, None

        def loss_fn(rows, dense, aux, constants, trip, w, mask):
            phs = l2_normalize(rows["av_ent"], axis=-1)
            pas = dense["attr"][trip[:, 1]]          # unnormalized
            pvs = constants["literal_embeds"][trip[:, 2]]
            score = conv_score(dense["conv_av"], phs, pas, pvs, mask=mask,
                               batch_sum=_batch_sum(pctx))
            return positive_logistic_from_scores(score, weights=w, mask=mask)

        self.step = _make_stream_update(cfg, "attr_view", prep, loss_fn,
                                        pctx=pctx)

    def draw(self, gen: torch.Generator, trips1, w1, trips2, w2):
        """Every step's (triples, weights, mask) for one epoch, each stacked
        over steps (the JAX package's _mixed_epoch_indices: one shuffle per
        KG)."""
        idx1, m1 = _padded_epoch_indices(gen, self.n1, self.bs1, self.bs1,
                                         self.steps)
        idx2, m2 = _padded_epoch_indices(gen, self.n2, self.bs2, self.bs2,
                                         self.steps)
        return (torch.cat([trips1[idx1], trips2[idx2]], dim=1),
                torch.cat([w1[idx1], w2[idx2]], dim=1),
                torch.cat([m1, m2], dim=1))

    def __call__(self, params, opt_state, gen: torch.Generator, constants,
                 trips1, w1, trips2, w2):
        with span("attr_view.epoch"):
            xs = self.draw(gen, trips1, w1, trips2, w2)
            total = torch.zeros((), dtype=torch.float32, device=gen.device)
            for i in range(self.steps):
                total += self.step(params, opt_state, constants,
                                   *(x[i] for x in xs))
        return total


def build_attr_view_epoch(cfg: Config, n1: int, n2: int, pctx=None):
    epoch = AttrViewEpoch(cfg, n1, n2, pctx)
    return epoch, epoch.steps, epoch.trained_per_epoch


# ---------------------------------------------------------------------------
# Streams that sample each step's batch
# ---------------------------------------------------------------------------

class SampledEpoch:
    """Epoch of a stream that draws each step's batch without replacement
    from ``n`` items (the reference's ``random.sample``).
    ``epoch(params, opt_state, gen, *data, constants=None) -> loss sum``
    trains in place; ``step(params, opt_state, [constants,] *batch) ->
    loss`` is one injected batch (each data array sliced alike)."""

    def __init__(self, cfg: Config, stream: str, n: int, batch_size: int,
                 prep, loss_fn, frozen: Tuple[str, ...] = (), pctx=None):
        self.n = n
        self.steps = max(1, int(np.ceil(n / batch_size)))
        self.bs = batch_size if self.steps > 1 else n
        self.trained_per_epoch = self.steps * self.bs
        self.epoch_span = stream + ".epoch"
        self.step = _make_stream_update(cfg, stream, prep, loss_fn, frozen,
                                        pctx)

    def __call__(self, params, opt_state, gen: torch.Generator, *data,
                 constants=None):
        lead = () if constants is None else (constants,)
        with span(self.epoch_span):
            total = torch.zeros((), dtype=torch.float32, device=gen.device)
            for _ in range(self.steps):
                sel = torch.randperm(self.n, generator=gen,
                                     device=gen.device)[:self.bs]
                total += self.step(params, opt_state, *lead,
                                   *(d[sel] for d in data))
        return total


def _sampled(cfg: Config, stream: str, n: int, batch_size: int, prep,
             loss_fn, frozen: Tuple[str, ...] = (), pctx=None):
    epoch = SampledEpoch(cfg, stream, n, batch_size, prep, loss_fn, frozen,
                         pctx)
    return epoch, epoch.steps, epoch.trained_per_epoch


def _rv_pair_ids(pos, *rest):
    # one fused entity gather of heads and tails -> one row-sparse apply
    return {"rv_ent": torch.cat([pos[:, 0], pos[:, 2]])}, None


def build_ckge_rel_epoch(cfg: Config, n: int, pctx=None):
    """Cross-KG entity inference in the relation view: the swapped
    supervision triples, positives only, loss weight 2. Returns ``(epoch,
    steps, trained_per_epoch)``; ``epoch(params, opt_state, gen, triples)``.
    """
    def loss_fn(rows, dense, aux, pos):
        hrows = l2_normalize(rows["rv_ent"], axis=-1)
        phs, pts = hrows[:pos.shape[0]], hrows[pos.shape[0]:]
        prs = lookup_norm(dense["rel"], pos[:, 1])
        return 2.0 * relation_logistic_loss_wo_negs(phs, prs, pts)

    return _sampled(cfg, "ckge_rel", n, cfg.batch_size, _rv_pair_ids,
                    loss_fn, pctx=pctx)


def build_ckgp_rel_epoch(cfg: Config, n: int, pctx=None):
    """Cross-KG relation inference: the predicate-aligned supervision
    4-tuples, weighted, loss weight 2. ``epoch(params, opt_state, gen, ids,
    weights)``."""
    def loss_fn(rows, dense, aux, pos, w):
        hrows = l2_normalize(rows["rv_ent"], axis=-1)
        phs, pts = hrows[:pos.shape[0]], hrows[pos.shape[0]:]
        prs = lookup_norm(dense["rel"], pos[:, 1])
        return 2.0 * logistic_loss_wo_negs(phs, prs, pts, w)

    return _sampled(cfg, "ckgp_rel", n, cfg.batch_size, _rv_pair_ids,
                    loss_fn, pctx=pctx)


def _av_head_ids(constants, pos, *rest):
    return {"av_ent": pos[:, 0]}, None


def _conv_scores(dense, conv, rows, constants, pos, pctx):
    phs = l2_normalize(rows["av_ent"], axis=-1)
    pas = dense["attr"][pos[:, 1]]
    pvs = constants["literal_embeds"][pos[:, 2]]
    return conv_score(dense[conv], phs, pas, pvs, batch_sum=_batch_sum(pctx))


def build_ckge_attr_epoch(cfg: Config, n: int, pctx=None):
    """Cross-KG entity inference in the attribute view: the swapped
    supervision attribute triples, loss weight 2. ``epoch(params,
    opt_state, gen, triples, constants=...)``."""
    def loss_fn(rows, dense, aux, constants, pos):
        return 2.0 * positive_logistic_from_scores(
            _conv_scores(dense, "conv_ckge", rows, constants, pos, pctx))

    return _sampled(cfg, "ckge_attr", n, cfg.attribute_batch_size,
                    _av_head_ids, loss_fn, pctx=pctx)


def build_ckga_attr_epoch(cfg: Config, n: int, pctx=None):
    """Cross-KG attribute inference: the predicate-aligned supervision
    attribute 4-tuples, weighted. ``epoch(params, opt_state, gen, ids,
    weights, constants=...)``."""
    def loss_fn(rows, dense, aux, constants, pos, w):
        return positive_logistic_from_scores(
            _conv_scores(dense, "conv_ckga", rows, constants, pos, pctx),
            weights=w)

    return _sampled(cfg, "ckga_attr", n, cfg.attribute_batch_size,
                    _av_head_ids, loss_fn, pctx=pctx)


def build_common_space_epoch(cfg: Config, n: int, pctx=None):
    """ITC combination: cv_weight * (cv_name_weight * ||e - n||^2 +
    ||e - r||^2 + ||e - a||^2) over a batch of entities, updating the
    shared, relation-view and attribute-view tables (three row-sparse
    applies a step). ``epoch(params, opt_state, gen, entities,
    constants=...)``."""
    cvw, cnw = cfg.cv_weight, cfg.cv_name_weight

    def prep(constants, ents):
        return {"ent": ents, "rv_ent": ents, "av_ent": ents}, None

    def loss_fn(rows, dense, aux, constants, ents):
        final = l2_normalize(rows["ent"], axis=-1)
        names = constants["name_embeds"][ents]
        cr = l2_normalize(rows["rv_ent"], axis=-1)
        ca = l2_normalize(rows["av_ent"], axis=-1)
        loss = cnw * alignment_loss(final, names)
        loss = loss + alignment_loss(final, cr)
        loss = loss + alignment_loss(final, ca)
        return cvw * loss

    return _sampled(cfg, "common_space", n, cfg.entity_batch_size, prep,
                    loss_fn, pctx=pctx)


def build_space_mapping_epoch(cfg: Config, n: int, pctx=None):
    """SSL combination: map each view into the shared space, ``ent``,
    through its own mapping (whole-batch-normalized mapped rows, an
    orthogonality penalty of weight ``orthogonal_weight``). Only the shared
    variables train: ``ent`` (row-sparse) and the three mappings (dense);
    ``rv_ent`` and ``av_ent`` are frozen reads. ``epoch(params, opt_state,
    gen, entities, constants=...)``."""
    ow = cfg.orthogonal_weight
    # on a mesh: whole-batch norms, and the regularizers on dp rank 0 only
    kw = dict(batch_sum=_batch_sum(pctx),
              regularize=pctx is None or pctx.dp_index == 0)

    def prep(constants, ents):
        return {"ent": ents}, None

    def loss_fn(rows, dense, frozen, constants, ents):
        final = l2_normalize(rows["ent"], axis=-1)
        eye = torch.eye(final.shape[-1], dtype=final.dtype,
                        device=final.device)
        loss = space_mapping_loss(constants["name_embeds"][ents], final,
                                  dense["nv_mapping"], eye, ow, **kw)
        loss = loss + space_mapping_loss(
            l2_normalize(frozen["rv_ent"], axis=-1), final,
            dense["rv_mapping"], eye, ow, **kw)
        loss = loss + space_mapping_loss(
            l2_normalize(frozen["av_ent"], axis=-1), final,
            dense["av_mapping"], eye, ow, **kw)
        return loss

    return _sampled(cfg, "space_mapping", n, cfg.entity_batch_size, prep,
                    loss_fn, frozen=("rv_ent", "av_ent"), pctx=pctx)
