"""SSL-mode driver (counterpart of multike_tpu/train/ssl.py).

Phase 1 (``max_epoch`` epochs): the relation view and its cross-KG entity
inference (+ soft relation inference after
``start_predicate_soft_alignment``), the attribute view and its cross-KG
entity inference (+ soft attribute inference); no combination stream.
Evaluation from ``start_valid`` every ``eval_freq`` epochs (rv, av, avg and
WVA); inside that branch, from ``start_predicate_soft_alignment`` on, the
predicate alignment is refreshed (the ITC driver refreshes it every 10
epochs instead). Neighbor refresh every ``truncated_freq`` epochs.
Phase 2 (``shared_learning_max_epoch`` epochs): shared-space mapping only,
with a ``final`` valid at the evaluation cadence. Then save and the test
sweep, WVA included.
"""
from __future__ import annotations

from multike_tpu_torch.eval import views as vw
from multike_tpu_torch.train.trainer import MultiKETrainer


class MultiKE_SSL(MultiKETrainer):
    """SSL is the reference's ``MultiKE_Late``."""

    def run(self):
        """Both phases; an exception or interrupt still leaves a resumable
        ``ssl_interrupt`` checkpoint when ``checkpoint_dir`` is set (on a
        mesh only when the save needs no collective)."""
        try:
            return self._run()
        except BaseException:
            # not where the save would take a collective: the other ranks
            # would never join it
            if self.cfg.checkpoint_dir and \
                    not self.checkpoint_needs_collective():
                self.save_checkpoint_tag("ssl_interrupt", -1)
                self._log("interrupted: wrote ssl_interrupt checkpoint")
            raise

    def _run(self):
        cfg = self.cfg
        kgs = self.kgs

        cross_kg_relation_triples = (kgs.kg1.sup_relation_triples_list
                                     + kgs.kg2.sup_relation_triples_list)
        cross_kg_attr_entity_triples = (kgs.kg1.sup_attribute_triples_list
                                        + kgs.kg2.sup_attribute_triples_list)
        pam = self.predicate_align_model
        cross_kg_relation_inference = (pam.sup_relation_alignment_triples1
                                       + pam.sup_relation_alignment_triples2)
        cross_kg_attribute_inference = (pam.sup_attribute_alignment_triples1
                                        + pam.sup_attribute_alignment_triples2)
        entity_list = kgs.kg1.entities_list + kgs.kg2.entities_list

        start_epoch = self.try_resume("ssl")
        if start_epoch == 0:
            vw.valid(self, embed_choice="nv")
            vw.valid(self, embed_choice="avg")
        for i in range(start_epoch + 1, cfg.max_epoch + 1):
            self._log(f"epoch {i}:")
            self.train_relation_view_1epo(i)
            self.train_cross_kg_entity_inference_relation_view_1epo(
                i, cross_kg_relation_triples)
            if i > cfg.start_predicate_soft_alignment:
                self.train_cross_kg_relation_inference_1epo(
                    i, cross_kg_relation_inference)

            self.train_attribute_view_1epo(i)
            self.train_cross_kg_entity_inference_attribute_view_1epo(
                i, cross_kg_attr_entity_triples)
            if i > cfg.start_predicate_soft_alignment:
                self.train_cross_kg_attribute_inference_1epo(
                    i, cross_kg_attribute_inference)

            if i >= cfg.start_valid and i % cfg.eval_freq == 0:
                mrr_rv = vw.valid(self, embed_choice="rv")
                mrr_av = vw.valid(self, embed_choice="av")
                mrr_avg = vw.valid(self, embed_choice="avg")
                mrr_wva = vw.valid_WVA(self)
                self.metrics.record(stream="valid", epoch=i, mrr_rv=mrr_rv,
                                    mrr_av=mrr_av, mrr_avg=mrr_avg,
                                    mrr_wva=mrr_wva)
                if i >= cfg.start_predicate_soft_alignment:
                    pam.update_predicate_alignment(self.current_embeds("rel"))
                    pam.update_predicate_alignment(self.current_embeds("attr"),
                                                   predicate_type="attribute")
                    cross_kg_relation_inference = (
                        pam.sup_relation_alignment_triples1
                        + pam.sup_relation_alignment_triples2)
                    cross_kg_attribute_inference = (
                        pam.sup_attribute_alignment_triples1
                        + pam.sup_attribute_alignment_triples2)

            if i == cfg.max_epoch:
                break

            if cfg.neg_sampling == "truncated" and i % cfg.truncated_freq == 0:
                if not 0.0 < cfg.truncated_epsilon < 1.0:
                    raise ValueError("truncated_epsilon must be in (0, 1)")
                self.generate_neighbors()

            if cfg.checkpoint_freq and i % cfg.checkpoint_freq == 0:
                self.save_checkpoint_tag("ssl", i)

        for i in range(1, cfg.shared_learning_max_epoch + 1):
            self.train_shared_space_mapping_1epo(i, entity_list)
            if i >= cfg.start_valid and i % cfg.eval_freq == 0:
                mrr = vw.valid(self, embed_choice="final")
                self.metrics.record(stream="valid_final", epoch=i,
                                    mrr_final=mrr)

        if cfg.is_save:
            self.save()
        return {
            "nv": vw.test(self, embed_choice="nv"),
            "rv": vw.test(self, embed_choice="rv"),
            "av": vw.test(self, embed_choice="av"),
            "avg": vw.test(self, embed_choice="avg"),
            "wva": vw.test_WVA(self),
            "final": vw.test(self, embed_choice="final"),
        }
