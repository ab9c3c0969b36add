"""ITC-mode driver (counterpart of multike_tpu/train/itc.py).

Per epoch: relation view + cross-KG entity inference in the relation view
(+ soft relation inference after ``start_predicate_soft_alignment``),
attribute view + cross-KG entity inference in the attribute view (+ soft
attribute inference), common-space learning. Evaluation from
``start_valid`` every ``eval_freq`` epochs; predicate-alignment refresh
every 10 epochs from ``start_predicate_soft_alignment``; neighbor refresh
every ``truncated_freq`` epochs. The early-stop check sits inside the
evaluation branch, as in the reference, and is armed only by
``Config.enable_early_stop`` (the reference's own check never fires, so it
trains to ``max_epoch``).
"""
from __future__ import annotations

import functools

from multike_tpu_torch.eval import views as vw
from multike_tpu_torch.eval.evaluation import early_stop
from multike_tpu_torch.train.trainer import MultiKETrainer
from multike_tpu_torch.utils.profiling import span


class MultiKE_ITC(MultiKETrainer):
    """ITC is the reference's ``MultiKE_CV``."""

    def run(self):
        """The epoch loop; an exception or interrupt still leaves a
        resumable ``itc_interrupt`` checkpoint when ``checkpoint_dir`` is
        set (on a mesh only when the save needs no collective)."""
        try:
            return self._run()
        except BaseException:
            # not where the save would take a collective: the other ranks
            # would never join it
            if self.cfg.checkpoint_dir and \
                    not self.checkpoint_needs_collective():
                self.save_checkpoint_tag("itc_interrupt", -1)
                self._log("interrupted: wrote itc_interrupt checkpoint")
            raise

    @functools.cached_property
    def _fixed_lists(self):
        """The lists a run trains on that no refresh changes: the swapped
        supervision relation and attribute triples, and every entity. Made
        once, so the trainer's device arrays, cached on a list's identity,
        are made once too."""
        kg1, kg2 = self.kgs.kg1, self.kgs.kg2
        return (kg1.sup_relation_triples_list + kg2.sup_relation_triples_list,
                kg1.sup_attribute_triples_list
                + kg2.sup_attribute_triples_list,
                kg1.entities_list + kg2.entities_list)

    def train_streams_1epo(self, i: int, cross_kg_relation_inference,
                           cross_kg_attribute_inference) -> dict:
        """The seven streams of driver epoch ``i``, in the reference's
        order (span ``itc.epoch``): the relation view, cross-KG entity
        inference in it and, after ``start_predicate_soft_alignment``,
        cross-KG relation inference on ``cross_kg_relation_inference``;
        the attribute view, cross-KG entity inference in it and, after the
        same epoch, cross-KG attribute inference on
        ``cross_kg_attribute_inference``; common-space learning. Returns
        each stream's average loss, by stream name. Pass the same list
        objects from epoch to epoch until a refresh replaces them: the
        trainer caches their device arrays on identity."""
        rel_triples, attr_triples, entities = self._fixed_lists
        soft = i > self.cfg.start_predicate_soft_alignment
        losses = {}
        with span("itc.epoch"):
            losses["rel_view"] = self.train_relation_view_1epo(i)
            losses["ckge_rel"] = \
                self.train_cross_kg_entity_inference_relation_view_1epo(
                    i, rel_triples)
            if soft:
                losses["ckgp_rel"] = \
                    self.train_cross_kg_relation_inference_1epo(
                        i, cross_kg_relation_inference)
            losses["attr_view"] = self.train_attribute_view_1epo(i)
            losses["ckge_attr"] = \
                self.train_cross_kg_entity_inference_attribute_view_1epo(
                    i, attr_triples)
            if soft:
                losses["ckga_attr"] = \
                    self.train_cross_kg_attribute_inference_1epo(
                        i, cross_kg_attribute_inference)
            losses["common_space"] = self.train_common_space_learning_1epo(
                i, entities)
        return losses

    def _run(self):
        cfg = self.cfg
        flag1 = flag2 = -1
        should_stop = False

        pam = self.predicate_align_model
        cross_kg_relation_inference = (pam.sup_relation_alignment_triples1
                                       + pam.sup_relation_alignment_triples2)
        cross_kg_attribute_inference = (pam.sup_attribute_alignment_triples1
                                        + pam.sup_attribute_alignment_triples2)

        start_epoch = self.try_resume("itc")
        if start_epoch == 0:
            vw.test(self, embed_choice="nv")
        for i in range(start_epoch + 1, cfg.max_epoch + 1):
            self._log(f"epoch {i}:")
            self.train_streams_1epo(i, cross_kg_relation_inference,
                                    cross_kg_attribute_inference)

            if i >= cfg.start_valid and i % cfg.eval_freq == 0:
                mrr_rv = vw.valid(self, embed_choice="rv")
                mrr_av = vw.valid(self, embed_choice="av")
                hits1, mrr = vw.valid_metrics(self, embed_choice="final")
                self.metrics.record(stream="valid", epoch=i, mrr_rv=mrr_rv,
                                    mrr_av=mrr_av, mrr_final=mrr)
                if cfg.enable_early_stop:
                    watched = mrr if cfg.stop_metric == "mrr" else hits1
                    flag1, flag2, should_stop = early_stop(
                        flag1, flag2, watched)
                if should_stop or i == cfg.max_epoch:
                    break

            if i >= cfg.start_predicate_soft_alignment and i % 10 == 0:
                pam.update_predicate_alignment(self.current_embeds("rel"))
                pam.update_predicate_alignment(self.current_embeds("attr"),
                                               predicate_type="attribute")
                cross_kg_relation_inference = (
                    pam.sup_relation_alignment_triples1
                    + pam.sup_relation_alignment_triples2)
                cross_kg_attribute_inference = (
                    pam.sup_attribute_alignment_triples1
                    + pam.sup_attribute_alignment_triples2)

            if cfg.neg_sampling == "truncated" and i % cfg.truncated_freq == 0:
                if not 0.0 < cfg.truncated_epsilon < 1.0:
                    raise ValueError("truncated_epsilon must be in (0, 1)")
                self.generate_neighbors()

            if cfg.checkpoint_freq and i % cfg.checkpoint_freq == 0:
                self.save_checkpoint_tag("itc", i)

        if cfg.is_save:
            self.save()
        return {
            "nv": vw.test(self, embed_choice="nv"),
            "rv": vw.test(self, embed_choice="rv"),
            "av": vw.test(self, embed_choice="av"),
            "final": vw.test(self, embed_choice="final"),
        }
