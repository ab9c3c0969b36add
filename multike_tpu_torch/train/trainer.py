"""MultiKE trainer (counterpart of multike_tpu/train/trainer.py): owns the
parameters, per-stream optimizer states, device triple arrays, the neighbor
table of the truncated phase, the Bloom filter of the true relation triples
and the epoch functions.

Each ``train_*_1epo`` method runs one epoch of one stream. Log lines keep
the reference's format, and every epoch is recorded in ``metrics``.

Differences from the JAX package, by design:
  * no capacity buckets: the sampled streams draw from their lists' true
    length (the JAX package pads them by wraparound to spare XLA a
    recompile, which repeats triples);
  * the neighbor refresh is an exact top-k on every device (the JAX
    package uses ``approx_max_k`` on the TPU);
  * a checkpoint stores ``[seed, epoch]`` where the JAX package stores its
    PRNG key, and a resumed run reseeds its generator from the two;
  * per-slot "resample" rejection decides on the host, after each round,
    whether to go on (one device sync per round), where the JAX package
    runs a device-side while loop;
  * on a mesh (``mesh_dp * mesh_tp > 1``, one process per rank, see
    parallel/context.py) every rank keeps the whole triple arrays, since
    its batch block comes from a permutation of the whole list drawn alike
    on every rank; the JAX package edge-partitions them over processes.
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from multike_tpu_torch import persistence
from multike_tpu_torch.config import Config
from multike_tpu_torch.data.kg import triples_to_array
from multike_tpu_torch.parallel import distributed
from multike_tpu_torch.parallel.context import ROW_SHARDED_TABLES, MeshContext
from multike_tpu_torch.params import init_params, l2_normalize
from multike_tpu_torch.sampling import (NeighborState, build_triple_filter,
                                        empty_neighbor_state)
from multike_tpu_torch.train import streams
from multike_tpu_torch.utils.device import resolve_device
from multike_tpu_torch.utils.metrics import MetricsLog
from multike_tpu_torch.utils.profiling import span


def topk_global_ids(embeds: torch.Tensor, useful_ids: torch.Tensor, k: int,
                    row_block: int = 1024) -> torch.Tensor:
    """(U, k) int32 global ids of each row's k most similar rows by inner
    product, blockwise: one (row_block, U) matmul and an exact
    ``torch.topk`` per block, mapped through ``useful_ids``."""
    out = torch.empty((embeds.shape[0], k), dtype=torch.int32,
                      device=embeds.device)
    for lo in range(0, embeds.shape[0], row_block):
        s = embeds[lo:lo + row_block] @ embeds.T
        idx = torch.topk(s, k, dim=1).indices
        out[lo:lo + row_block] = useful_ids[idx].to(torch.int32)
    return out


def refresh_neighbor_state(rv_norm: torch.Tensor, useful_lists, ks,
                           kmax: int) -> NeighborState:
    """The whole NeighborState from normalized rv embeddings: per KG, the
    top-k neighbors of its useful entities among themselves."""
    state = empty_neighbor_state(rv_norm.shape[0], kmax, rv_norm.device)
    for u_ids, k in zip(useful_lists, ks):
        state.nbr[u_ids, :k] = topk_global_ids(rv_norm[u_ids], u_ids, k)
        state.has[u_ids] = True
        state.cnt[u_ids] = k
    return state


class MultiKETrainer:
    def __init__(self, cfg: Config, data, predicate_align_model=None,
                 verbose: bool = True, device=None):
        """``data``: a ``data.dataset.DataModel``, or anything with its
        ``kgs`` (the streams that read the name or literal vectors then
        cannot run). ``device``: where the tables live and the epochs run
        (default: the card, ``cuda:LOCAL_RANK`` on a mesh; ``"cpu"`` runs
        the kernels' plain versions).

        ``mesh_dp * mesh_tp > 1`` trains on a mesh of that many ranks, one
        process each, in an initialized process group
        (``parallel.distributed.init_distributed``); the entity tables are
        padded and row-sharded over tp."""
        if cfg.alignment_module != "swapping":
            raise ValueError("cross-KG inference requires swapping mode")
        self.cfg = cfg
        self.data = data
        self.kgs = data.kgs
        self.predicate_align_model = predicate_align_model
        self.verbose = verbose
        if cfg.mesh_dp * cfg.mesh_tp > 1:
            device = distributed.rank_device(device)
        self.device = resolve_device(device)
        self.pctx = MeshContext.from_config(cfg, self.device)

        kgs = self.kgs
        self.params = init_params(cfg, kgs.entities_num, kgs.relations_num,
                                  kgs.attributes_num, device=self.device)
        if self.pctx is not None:
            for t in ROW_SHARDED_TABLES:
                self.params[t] = self.pctx.pad_table_rows(self.params[t])
            self.params = self.pctx.shard_params(self.params)
        self.opt_states = streams.init_stream_opt_states(cfg, self.params,
                                                         self.pctx)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(cfg.seed)
        self.constants = {
            name: torch.as_tensor(np.asarray(getattr(data, attr), np.float32),
                                  device=self.device)
            for name, attr in (("name_embeds", "local_name_vectors"),
                               ("literal_embeds", "value_vectors"))
            if hasattr(data, attr)}

        self.ranges = kgs.entity_id_ranges()
        # the sorted lists: sorting them again is one linear pass
        rt1 = triples_to_array(kgs.kg1.local_relation_triples_list)
        rt2 = triples_to_array(kgs.kg2.local_relation_triples_list)
        self.rel_triples1 = torch.as_tensor(rt1, dtype=torch.long,
                                            device=self.device)
        self.rel_triples2 = torch.as_tensor(rt2, dtype=torch.long,
                                            device=self.device)
        self.n_rel1, self.n_rel2 = len(rt1), len(rt2)

        # truncated sampling: top-(1 - eps) neighbors per KG, in one table;
        # None until the first refresh (the uniform phase)
        eps = cfg.truncated_epsilon
        self.k_nbr1 = max(1, int((1 - eps) * kgs.kg1.entities_num))
        self.k_nbr2 = max(1, int((1 - eps) * kgs.kg2.entities_num))
        self.neighbors: Optional[NeighborState] = None

        # exact rejection of true triples: one Bloom filter over both KGs'
        # local relation triples (their id spaces are disjoint)
        self.triple_filter = None
        if cfg.neg_rejection_tries > 0 or cfg.chunk_exact_rejection:
            self.triple_filter = build_triple_filter(
                np.concatenate([rt1, rt2]), device=self.device)

        self._epoch_fns: Dict = {}
        # host list -> device tensor, cached on list identity (see
        # _cached_array)
        self._arr_cache: Dict = {}
        # one log file for a mesh: rank 0's (every rank keeps its records)
        self.metrics = MetricsLog((cfg.metrics_log_path or None)
                                  if distributed.rank() == 0 else None)
        self._log(f"device memory estimate: {self.memory_estimate_mb():.0f} "
                  "MB (tables + per-stream optimizer states + neighbor "
                  "table)")

    def memory_estimate_mb(self) -> float:
        """Rough device footprint: parameter tables, per-stream optimizer
        states, constants, triple arrays, the Bloom filter and the neighbor
        table at its size after a refresh."""
        total = sum(t.numel() * t.element_size()
                    for tree in (self.params, self.opt_states, self.constants)
                    for t in streams._leaves(tree))
        total += sum(t.numel() * t.element_size()
                     for t in (self.rel_triples1, self.rel_triples2))
        if self.triple_filter is not None:
            total += self.triple_filter.bits.numel() * 4
        kmax = max(self.k_nbr1, self.k_nbr2, 8)
        total += self.kgs.entities_num * (kmax * 4 + 5)  # nbr + has + cnt
        return total / 1e6

    # ------------------------------------------------------------------
    # epoch functions and device arrays
    # ------------------------------------------------------------------
    def _get_epoch_fn(self, kind: str, *shape_key):
        key = (kind,) + shape_key
        if key not in self._epoch_fns:
            if kind == "rel_view":
                n1, n2, with_nbr = shape_key
                fn = streams.build_rel_view_epoch(
                    self.cfg, n1, n2, self.ranges, with_neighbors=with_nbr,
                    tfilter=self.triple_filter, pctx=self.pctx)
            else:
                fn = getattr(streams, f"build_{kind}_epoch")(
                    self.cfg, *shape_key, pctx=self.pctx)
            self._epoch_fns[key] = fn
        return self._epoch_fns[key]

    def _cached_array(self, tag: str, seq) -> torch.Tensor:
        """Device tensor of a triple/id list, cached on list identity:
        callers replace a list with a NEW one instead of mutating it (the
        length check catches appends)."""
        hit = self._arr_cache.get(tag)
        if hit is not None and hit[0] is seq and hit[1] == len(seq):
            return hit[2]
        arr = torch.as_tensor(np.asarray(list(seq), np.int64),
                              device=self.device)
        self._arr_cache[tag] = (seq, len(seq), arr)
        return arr

    def _weighted_arrays(self, seq):
        """Device (ids (n, 3) int64, weights (n,) float32) of a weighted
        4-tuple list."""
        a = np.asarray(seq, np.float64).reshape(-1, 4)
        return (torch.as_tensor(a[:, :3].astype(np.int64), device=self.device),
                torch.as_tensor(a[:, 3].astype(np.float32),
                                device=self.device))

    def _cached_weighted(self, tag: str, seq):
        """:meth:`_weighted_arrays`, cached like :meth:`_cached_array`."""
        hit = self._arr_cache.get(tag)
        if hit is not None and hit[0] is seq and hit[1] == len(seq):
            return hit[2]
        out = self._weighted_arrays(seq)
        self._arr_cache[tag] = (seq, len(seq), out)
        return out

    def _weighted_attr_arrays(self):
        """Both KGs' weighted attribute triples as device arrays, rebuilt
        only when the predicate-alignment model refreshes (its
        ``version``)."""
        pam = self.predicate_align_model
        ver = getattr(pam, "version", 0)
        hit = self._arr_cache.get("attr_view")
        if hit is not None and hit[0] == ver:
            return hit[1]
        out = (*self._weighted_arrays(pam.attribute_triples_w_weights1),
               *self._weighted_arrays(pam.attribute_triples_w_weights2))
        self._arr_cache["attr_view"] = (ver, out)
        return out

    def _finish_epoch(self, stream, epoch, loss_sum, trained, start, msg,
                      **fields):
        # float() waits for the device, so the time covers the epoch's work
        loss = float(loss_sum) / max(trained, 1)
        seconds = time.time() - start
        self.metrics.record(stream=stream, epoch=epoch, loss=loss,
                            seconds=seconds, trained=trained,
                            triples_per_s=(trained / seconds)
                            if seconds > 0 else None, **fields)
        self._log(msg.format(epoch, loss, seconds))
        return loss

    def _log(self, msg: str):
        if self.verbose:
            print(msg)

    # ------------------------------------------------------------------
    # view training epochs
    # ------------------------------------------------------------------
    def train_relation_view_1epo(self, epoch: int):
        start = time.time()
        with_nbr = self.neighbors is not None
        epoch_fn, _, trained = self._get_epoch_fn("rel_view", self.n_rel1,
                                                  self.n_rel2, with_nbr)
        loss = epoch_fn(self.params, self.opt_states["rel_view"], self.gen,
                        self.rel_triples1, self.rel_triples2, self.neighbors)
        fields = {"truncated": with_nbr, "scheme": epoch_fn.scheme}
        if epoch_fn.dropped is not None:
            # share of the epoch's real negative slots the Bloom filter
            # dropped as true triples
            fields["dropped_share"] = float(epoch_fn.dropped) / epoch_fn.slots
        return self._finish_epoch(
            "rel_view", epoch, loss, trained, start,
            "epoch {} of rel. view, avg. loss: {:.4f}, time: {:.4f}s",
            **fields)

    def train_attribute_view_1epo(self, epoch: int):
        start = time.time()
        t1, f1, t2, f2 = self._weighted_attr_arrays()
        n1, n2 = int(t1.shape[0]), int(t2.shape[0])
        if n1 + n2 == 0:
            return 0.0
        epoch_fn, _, trained = self._get_epoch_fn("attr_view", n1, n2)
        loss = epoch_fn(self.params, self.opt_states["attr_view"], self.gen,
                        self.constants, t1, f1, t2, f2)
        return self._finish_epoch(
            "attr_view", epoch, loss, trained, start,
            "epoch {} of att. view, avg. loss: {:.4f}, time: {:.4f}s")

    # ------------------------------------------------------------------
    # cross-kg streams
    # ------------------------------------------------------------------
    def _sampled_epoch(self, stream: str, epoch: int, data, msg,
                       constants=None):
        start = time.time()
        n = int(data[0].shape[0])
        epoch_fn, _, trained = self._get_epoch_fn(stream, n)
        loss = epoch_fn(self.params, self.opt_states[stream], self.gen,
                        *data, constants=constants)
        return self._finish_epoch(stream, epoch, loss, trained, start, msg)

    def train_cross_kg_entity_inference_relation_view_1epo(
            self, epoch: int, sup_triples: Sequence[Tuple[int, int, int]]):
        if len(sup_triples) == 0:
            return 0.0
        return self._sampled_epoch(
            "ckge_rel", epoch, (self._cached_array("ckge_rel", sup_triples),),
            "epoch {} of cross-kg entity inference in rel. view, avg. loss:"
            " {:.4f}, time: {:.4f}s")

    def train_cross_kg_relation_inference_1epo(self, epoch: int,
                                               sup_triples):
        if len(sup_triples) == 0:
            return 0.0
        return self._sampled_epoch(
            "ckgp_rel", epoch, self._cached_weighted("ckgp_rel", sup_triples),
            "epoch {} of cross-kg relation inference in rel. view, avg. "
            "loss: {:.4f}, time: {:.4f}s")

    def train_cross_kg_entity_inference_attribute_view_1epo(
            self, epoch: int, sup_triples):
        if len(sup_triples) == 0:
            return 0.0
        return self._sampled_epoch(
            "ckge_attr", epoch,
            (self._cached_array("ckge_attr", sup_triples),),
            "epoch {} of cross-kg entity inference in attr. view, avg. "
            "loss: {:.4f}, time: {:.4f}s", constants=self.constants)

    def train_cross_kg_attribute_inference_1epo(self, epoch: int,
                                                sup_triples):
        if len(sup_triples) == 0:
            return 0.0
        return self._sampled_epoch(
            "ckga_attr", epoch,
            self._cached_weighted("ckga_attr", sup_triples),
            "epoch {} of cross-kg attribute inference in attr. view, avg."
            " loss: {:.4f}, time: {:.4f}s", constants=self.constants)

    # ------------------------------------------------------------------
    # combination streams
    # ------------------------------------------------------------------
    def train_common_space_learning_1epo(self, epoch: int,
                                         entities: Sequence[int]):
        return self._sampled_epoch(
            "common_space", epoch,
            (self._cached_array("common_space_ents", entities),),
            "epoch {} of common space learning, avg. loss: {:.4f}, "
            "time: {:.4f}s", constants=self.constants)

    def train_shared_space_mapping_1epo(self, epoch: int,
                                        entities: Sequence[int]):
        return self._sampled_epoch(
            "space_mapping", epoch,
            (self._cached_array("space_mapping_ents", entities),),
            "epoch {} of shared space learning, avg. loss: {:.4f}, "
            "time: {:.4f}s", constants=self.constants)

    # ------------------------------------------------------------------
    # neighbor refresh (truncated negative sampling)
    # ------------------------------------------------------------------
    def generate_neighbors(self):
        """Refresh the truncated-sampling candidates from the current rv
        embeddings of each KG's useful entities, on the device."""
        with span("refresh.neighbors"):
            t1 = time.time()
            kgs = self.kgs
            rv = l2_normalize(self._table("rv_ent"), axis=1)
            u1, u2 = (torch.as_tensor(u, dtype=torch.long, device=self.device)
                      for u in (kgs.useful_entities_list1,
                                kgs.useful_entities_list2))
            k1 = min(self.k_nbr1, int(u1.shape[0]))
            k2 = min(self.k_nbr2, int(u2.shape[0]))
            self.neighbors = refresh_neighbor_state(rv, (u1, u2), (k1, k2),
                                                    max(k1, k2, 8))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            seconds = time.time() - t1
            self.metrics.record(stream="neighbors", seconds=seconds,
                                k=(k1, k2))
            self._log("generating neighbors of {} entities costs {:.3f} s."
                      .format(kgs.kg1.entities_num + kgs.kg2.entities_num,
                              seconds))

    # ------------------------------------------------------------------
    # embedding access (normalized reads, like the reference's tensor reads)
    # ------------------------------------------------------------------
    def _table(self, name: str) -> torch.Tensor:
        """A whole table on this rank's device: a row-sharded one is
        gathered over tp (a collective every rank of the mesh must reach)
        and stripped of its padding rows."""
        if self.pctx is None:
            return self.params[name]
        full = self.pctx.gather_table(self.params[name], name)
        return full[:self.kgs.entities_num] if self.pctx.sharded(name) \
            else full

    def current_embeds_device(self, which: str) -> torch.Tensor:
        """Normalized view embeddings (the name view as it is), left on the
        device."""
        if which == "nv":
            return self.constants["name_embeds"]
        tables = {"rv": "rv_ent", "av": "av_ent", "final": "ent"}
        if which not in tables:
            raise KeyError(which)
        return l2_normalize(self._table(tables[which]), axis=1)

    def current_embeds(self, which: str) -> np.ndarray:
        if which == "rel":
            return l2_normalize(self.params["rel"], axis=1).cpu().numpy()
        if which == "attr":
            return self.params["attr"].cpu().numpy()
        return self.current_embeds_device(which).cpu().numpy()

    # ------------------------------------------------------------------
    # checkpoint / resume and saved embeddings
    # ------------------------------------------------------------------
    def checkpoint_path(self, tag: str) -> str:
        return os.path.join(self.cfg.checkpoint_dir, f"{tag}.npz")

    def checkpoint_needs_collective(self) -> bool:
        """True when writing a checkpoint takes a collective (the tp-sharded
        tables are gathered). An interrupt handler must not try such a save:
        only the raising rank would enter the gather while the others sit in
        the epoch loop, a hang instead of an exit."""
        return self.pctx is not None and self.pctx.tp > 1

    def _full_state(self):
        """(params, opt_states) with whole (padded) tables: gathered over tp
        on a mesh, a collective every rank must reach."""
        if self.pctx is None:
            return self.params, self.opt_states
        return (self.pctx.gather_tree(self.params),
                {s: self.pctx.gather_tree(st)
                 for s, st in self.opt_states.items()})

    def save_checkpoint_tag(self, tag: str, epoch: int):
        """Write the checkpoint; on a mesh every rank gathers, rank 0
        writes (``checkpoint_dir`` must be shared by the ranks)."""
        if not self.cfg.checkpoint_dir:
            return
        params, opt_states = self._full_state()
        if distributed.rank() == 0:
            persistence.save_checkpoint(self.checkpoint_path(tag), params,
                                        opt_states, self.cfg.seed, epoch)

    def try_resume(self, tag: str) -> int:
        """Restore the tables and accumulators from a checkpoint if there is
        one; returns the epoch to resume after (0 = fresh start). On a mesh
        every rank reads the whole checkpoint and keeps its shard; a
        checkpoint that some ranks see and others do not (a
        ``checkpoint_dir`` that is not shared) raises."""
        if not self.cfg.checkpoint_dir:
            return 0
        path = self.checkpoint_path(tag)
        exists = os.path.exists(path)
        if self.pctx is not None:
            flags = distributed.all_gather(torch.tensor(
                [int(exists)], dtype=torch.int32, device=self.device))
            if int(flags.min()) != int(flags.max()):
                raise RuntimeError(
                    f"checkpoint {path} is visible on some ranks but not "
                    "others: checkpoint_dir must be shared by every rank")
        if not exists:
            return 0
        params, opt_states = self._full_state()
        epoch = persistence.load_checkpoint(path, params, opt_states)
        if self.pctx is not None:
            for tree, full in ((self.params, params),
                               *((self.opt_states[s], opt_states[s])
                                 for s in self.opt_states)):
                for k, t in self.pctx.shard_params(full).items():
                    for dst, src in zip(streams._leaves(tree[k]),
                                        streams._leaves(t)):
                        dst.copy_(src)
        self.gen.manual_seed(persistence.resume_seed(self.cfg.seed, epoch))
        self._log(f"resumed from {path} at epoch {epoch}")
        return epoch

    def save(self, out_folder: Optional[str] = None) -> str:
        folder = out_folder or persistence.generate_out_folder(
            self.cfg.output, self.cfg.training_data, "",
            self.__class__.__name__)
        # gathered on every rank before the rank-0 gate (a collective on tp)
        embeds = {w: self.current_embeds(w)
                  for w in ("final", "nv", "rv", "av", "rel", "attr")}
        if distributed.rank() != 0:
            return folder
        persistence.save_embeddings(folder, self.kgs, embeds["final"],
                                    embeds["nv"], embeds["rv"], embeds["av"],
                                    embeds["rel"], embeds["attr"])
        return folder
