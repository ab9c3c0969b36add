"""MultiKE trainer (counterpart of multike_tpu/train/trainer.py): owns the
parameters, per-stream Adagrad accumulators, device triple arrays and the
epoch functions.

Ported so far: the relation view (``train_relation_view_1epo``), the
cross-KG entity inference of the relation view
(``train_cross_kg_entity_inference_relation_view_1epo``, the swapped
supervision triples that carry the view's cross-KG signal) and the
embedding reads that evaluation needs. The trainer reads only ``data.kgs``
(a ``data.kg.KGs``); the name and literal constants arrive with the
``DataModel`` port, the other streams, neighbor refresh and checkpoints in
later slices. Log lines keep the reference's format.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from multike_tpu_torch.config import Config
from multike_tpu_torch.data.kg import triples_to_array
from multike_tpu_torch.params import init_params, l2_normalize
from multike_tpu_torch.train import streams
from multike_tpu_torch.utils.device import resolve_device


class MultiKETrainer:
    def __init__(self, cfg: Config, data, predicate_align_model=None,
                 verbose: bool = True, device=None):
        """``device``: where the tables live and the epochs run (default:
        the card; ``"cpu"`` runs the kernels' plain versions)."""
        if cfg.alignment_module != "swapping":
            raise ValueError("cross-KG inference requires swapping mode")
        if cfg.mesh_dp * cfg.mesh_tp > 1:
            raise NotImplementedError(
                "mesh training (mesh_dp * mesh_tp > 1) arrives with the "
                "multi-GPU slice of the port")
        self.cfg = cfg
        self.data = data
        self.kgs = data.kgs
        self.predicate_align_model = predicate_align_model
        self.verbose = verbose
        self.device = resolve_device(device)

        kgs = self.kgs
        self.params = init_params(cfg, kgs.entities_num, kgs.relations_num,
                                  kgs.attributes_num, device=self.device)
        self.opt_states = streams.init_stream_opt_states(cfg, self.params)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(cfg.seed)

        self.ranges = kgs.entity_id_ranges()
        rt1 = triples_to_array(kgs.kg1.local_relation_triples_set)
        rt2 = triples_to_array(kgs.kg2.local_relation_triples_set)
        self.rel_triples1 = torch.as_tensor(rt1, dtype=torch.long,
                                            device=self.device)
        self.rel_triples2 = torch.as_tensor(rt2, dtype=torch.long,
                                            device=self.device)
        self.n_rel1, self.n_rel2 = len(rt1), len(rt2)
        self._epoch_fns: Dict = {}
        self._arr_cache: Dict = {}

    def _finish_epoch(self, epoch, loss_sum, trained, start, msg):
        # float() waits for the device, so the time covers the epoch's work
        loss = float(loss_sum) / max(trained, 1)
        self._log(msg.format(epoch, loss, time.time() - start))
        return loss

    def _log(self, msg: str):
        if self.verbose:
            print(msg)

    # ------------------------------------------------------------------
    # view training epochs
    # ------------------------------------------------------------------
    def train_relation_view_1epo(self, epoch: int):
        start = time.time()
        key = ("rel_view", self.n_rel1, self.n_rel2)
        if key not in self._epoch_fns:
            self._epoch_fns[key] = streams.build_rel_view_epoch(
                self.cfg, self.n_rel1, self.n_rel2, self.ranges)
        epoch_fn, _, trained = self._epoch_fns[key]
        loss = epoch_fn(self.params, self.opt_states["rel_view"], self.gen,
                        self.rel_triples1, self.rel_triples2)
        return self._finish_epoch(
            epoch, loss, trained, start,
            "epoch {} of rel. view, avg. loss: {:.4f}, time: {:.4f}s")

    # ------------------------------------------------------------------
    # cross-kg streams
    # ------------------------------------------------------------------
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

    def train_cross_kg_entity_inference_relation_view_1epo(self, epoch: int,
                                                           sup_triples):
        if len(sup_triples) == 0:
            return 0.0
        start = time.time()
        arr = self._cached_array("ckge_rel", sup_triples)
        key = ("ckge_rel", len(sup_triples))
        if key not in self._epoch_fns:
            self._epoch_fns[key] = streams.build_ckge_rel_epoch(
                self.cfg, len(sup_triples))
        epoch_fn, _, trained = self._epoch_fns[key]
        loss = epoch_fn(self.params, self.opt_states["ckge_rel"], self.gen,
                        arr)
        return self._finish_epoch(
            epoch, loss, trained, start,
            "epoch {} of cross-kg entity inference in rel. view, avg. loss:"
            " {:.4f}, time: {:.4f}s")

    # ------------------------------------------------------------------
    # embedding access (normalized reads, like the reference's tensor reads)
    # ------------------------------------------------------------------
    def current_embeds_device(self, which: str) -> torch.Tensor:
        """Normalized view embeddings, left on the device."""
        if which == "nv":
            raise NotImplementedError(
                "the name view arrives with the DataModel / text-pipeline "
                "slice of the port")
        tables = {"rv": "rv_ent", "av": "av_ent", "final": "ent"}
        if which not in tables:
            raise KeyError(which)
        return l2_normalize(self.params[tables[which]], axis=1)

    def current_embeds(self, which: str) -> np.ndarray:
        if which == "rel":
            return l2_normalize(self.params["rel"], axis=1).cpu().numpy()
        if which == "attr":
            return self.params["attr"].cpu().numpy()
        return self.current_embeds_device(which).cpu().numpy()
