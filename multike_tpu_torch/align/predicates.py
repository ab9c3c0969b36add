"""Cross-KG predicate (relation and attribute) alignment (counterpart of
multike_tpu/align/predicates.py). Host numpy.

  * seed alignment: Levenshtein ratio of the predicates' local names,
    mutual best match, kept above ``predicate_init_sim``
    (``utils.native.levenshtein_ratio_matrix``);
  * refresh during training: l2-normalized inner-product similarity of the
    predicate embeddings with mutual best match over the union id space,
    blended 0.7 * name similarity + 0.3 * embedding similarity, kept above
    ``predicate_soft_sim``;
  * outputs per KG: supervision 4-tuples (s, aligned_p, o, w) and every
    local triple with a weight: ``zoom_weight(w)`` rescaled into [0.5, 1]
    for aligned predicates, 0.2 for the others.

``version`` grows on every refresh; the trainer keys its cached arrays on
it.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from multike_tpu_torch.config import Config
from multike_tpu_torch.data.kg import KGs
from multike_tpu_torch.data.readers import read_predicate_local_names
from multike_tpu_torch.utils.native import levenshtein_ratio_matrix
from multike_tpu_torch.utils.profiling import span

UNALIGNED_WEIGHT = 0.2


def zoom_weight(weight: float, min_w_before: float, min_w_after: float = 0.5) -> float:
    """Rescale [min_w_before, 1] to [min_w_after, 1]."""
    return 1.0 - (1.0 - weight) * (1.0 - min_w_after) / (1.0 - min_w_before)


def link2dic(links):
    dic1, dic2 = {}, {}
    for i, j, w in links:
        dic1[i] = (j, w)
        dic2[j] = (i, w)
    assert len(dic1) == len(dic2)
    return dic1, dic2


def generate_sup_predicate_triples(predicate_links, triples1, triples2):
    """(s, p, o) with p aligned -> (s, aligned_p, o, w) 4-tuples."""
    dic1, dic2 = link2dic(predicate_links)
    sup1 = {(s, dic1[p][0], o, dic1[p][1]) for (s, p, o) in triples1 if p in dic1}
    sup2 = {(s, dic2[p][0], o, dic2[p][1]) for (s, p, o) in triples2 if p in dic2}
    return sorted(sup1), sorted(sup2)


def add_weights(predicate_links, triples1, triples2, min_w_before):
    """Every local triple -> (s, p, o, weight): sorted lists and sets.

    Each triple's row is made in one pass, the zoomed weight computed once
    a predicate; sorting the rows of a sorted list (the KGs' local lists)
    is one linear pass."""
    dic1, dic2 = link2dic(predicate_links)

    def weight_triples(triples, dic):
        zoomed = {p: zoom_weight(w, min_w_before) for p, (_, w) in dic.items()}
        return [(s, p, o, zoomed.get(p, UNALIGNED_WEIGHT))
                for (s, p, o) in triples]

    rows1 = weight_triples(triples1, dic1)
    rows2 = weight_triples(triples2, dic2)
    w1, w2 = set(rows1), set(rows2)
    assert len(triples1) == len(w1)
    assert len(triples2) == len(w2)
    return sorted(rows1), sorted(rows2), w1, w2


def init_predicate_alignment(name_dict_1: Dict[str, str],
                             name_dict_2: Dict[str, str],
                             predicate_init_sim: float):
    """Levenshtein-seeded mutual-best match."""
    p1_list = list(name_dict_1.keys())
    p2_list = list(name_dict_2.keys())
    if not p1_list or not p2_list:
        return set(), {}
    mat = levenshtein_ratio_matrix([name_dict_1[p] for p in p1_list],
                                   [name_dict_2[p] for p in p2_list])
    # best match per row / per column; ties resolved to the first maximum,
    # matching the reference's strict '>' scan order over dict items
    best12 = mat.argmax(axis=1)
    best21 = mat.argmax(axis=0)

    match_pairs = set()
    latent = {}
    for i, p1 in enumerate(p1_list):
        j = int(best12[i])
        simv = float(mat[i, j])
        if simv <= 0:  # reference keeps match_p2='' when all sims are 0
            continue
        if int(best21[j]) == i:
            p2 = p2_list[j]
            latent[(p1, p2)] = simv
            if simv > predicate_init_sim:
                match_pairs.add((p1, p2, simv))
    return match_pairs, latent


def predicate2id_matched_pairs(match_pairs, id_dict_1, id_dict_2):
    out = set()
    for (p1, p2, w) in match_pairs:
        if p1 in id_dict_1 and p2 in id_dict_2:
            out.add((id_dict_1[p1], id_dict_2[p2], w))
    return out


def find_predicate_alignment_by_embedding(embed: np.ndarray,
                                          predicate_list1: List[int],
                                          predicate_list2: List[int]):
    """Mutual best match on normalized embedding similarity. ``embed`` is
    the full predicate table over the union id space."""
    norms = np.linalg.norm(embed, axis=1, keepdims=True)
    e = np.where(norms > 0, embed / np.maximum(norms, 1e-30), embed)
    l1 = np.asarray(predicate_list1, np.int64)
    l2 = np.asarray(predicate_list2, np.int64)
    if len(l1) == 0 or len(l2) == 0:
        return {}
    sub = e[l1] @ e[l2].T  # (|P1|, |P2|) — only cross-KG entries matter
    best12 = sub.argmax(axis=1)
    best21 = sub.argmax(axis=0)
    latent = {}
    for a, b in enumerate(best12):
        if best21[b] == a:
            latent[(int(l1[a]), int(l2[b]))] = float(sub[a, b])
    return latent


class PredicateAlignModel:
    def __init__(self, kgs: KGs, cfg: Config):
        self.kgs = kgs
        self.cfg = cfg
        self.relation_name_dict1, self.attribute_name_dict1 = \
            read_predicate_local_names(
                cfg.training_data + "predicate_local_name_1",
                set(kgs.kg1.relations_id_dict.keys()))
        self.relation_name_dict2, self.attribute_name_dict2 = \
            read_predicate_local_names(
                cfg.training_data + "predicate_local_name_2",
                set(kgs.kg2.relations_id_dict.keys()))

        self.relation_alignment_set, self.relation_latent_init = \
            init_predicate_alignment(self.relation_name_dict1,
                                     self.relation_name_dict2,
                                     cfg.predicate_init_sim)
        self.attribute_alignment_set, self.attribute_latent_init = \
            init_predicate_alignment(self.attribute_name_dict1,
                                     self.attribute_name_dict2,
                                     cfg.predicate_init_sim)
        self.relation_alignment_set_init = self.relation_alignment_set
        self.attribute_alignment_set_init = self.attribute_alignment_set
        self.update_relation_triples(self.relation_alignment_set)
        self.update_attribute_triples(self.attribute_alignment_set)

    # ------------------------------------------------------------------
    def update_relation_triples(self, relation_alignment_set):
        # bump on every refresh so consumers (trainer) can cache derived
        # arrays between the every-10-epochs updates
        self.version = getattr(self, "version", 0) + 1
        kgs = self.kgs
        self.relation_id_alignment_set = predicate2id_matched_pairs(
            relation_alignment_set, kgs.kg1.relations_id_dict,
            kgs.kg2.relations_id_dict)
        pairs = sorted(self.relation_id_alignment_set)
        self.train_relations1 = [a for (a, _, _) in pairs]
        self.train_relations2 = [a for (_, a, _) in pairs]
        (self.sup_relation_alignment_triples1,
         self.sup_relation_alignment_triples2) = generate_sup_predicate_triples(
            self.relation_id_alignment_set,
            kgs.kg1.local_relation_triples_list,
            kgs.kg2.local_relation_triples_list)
        (self.relation_triples_w_weights1, self.relation_triples_w_weights2,
         self.relation_triples_w_weights_set1,
         self.relation_triples_w_weights_set2) = add_weights(
            self.relation_id_alignment_set,
            kgs.kg1.local_relation_triples_list,
            kgs.kg2.local_relation_triples_list,
            self.cfg.predicate_soft_sim)

    def update_attribute_triples(self, attribute_alignment_set):
        self.version = getattr(self, "version", 0) + 1
        kgs = self.kgs
        self.attribute_id_alignment_set = predicate2id_matched_pairs(
            attribute_alignment_set, kgs.kg1.attributes_id_dict,
            kgs.kg2.attributes_id_dict)
        pairs = sorted(self.attribute_id_alignment_set)
        self.train_attributes1 = [a for (a, _, _) in pairs]
        self.train_attributes2 = [a for (_, a, _) in pairs]
        (self.sup_attribute_alignment_triples1,
         self.sup_attribute_alignment_triples2) = generate_sup_predicate_triples(
            self.attribute_id_alignment_set,
            kgs.kg1.local_attribute_triples_list,
            kgs.kg2.local_attribute_triples_list)
        (self.attribute_triples_w_weights1, self.attribute_triples_w_weights2,
         self.attribute_triples_w_weights_set1,
         self.attribute_triples_w_weights_set2) = add_weights(
            self.attribute_id_alignment_set,
            kgs.kg1.local_attribute_triples_list,
            kgs.kg2.local_attribute_triples_list,
            self.cfg.predicate_soft_sim)

    # ------------------------------------------------------------------
    def update_predicate_alignment(self, embed: np.ndarray,
                                   predicate_type: str = "relation",
                                   w: float = 0.7):
        """Blend the name-seeded similarities with embedding similarities
        (span ``refresh.predicates``)."""
        with span("refresh.predicates"):
            if predicate_type == "relation":
                id_dict1 = self.kgs.kg1.relations_id_dict
                id_dict2 = self.kgs.kg2.relations_id_dict
                alignment_set_init = self.relation_alignment_set_init
            else:
                id_dict1 = self.kgs.kg1.attributes_id_dict
                id_dict2 = self.kgs.kg2.attributes_id_dict
                alignment_set_init = self.attribute_alignment_set_init

            latent = find_predicate_alignment_by_embedding(
                np.asarray(embed), list(id_dict1.values()),
                list(id_dict2.values()))

            alignment_set = set()
            for (p1, p2, sim_init) in alignment_set_init:
                pid1, pid2 = id_dict1[p1], id_dict2[p2]
                s = sim_init
                if (pid1, pid2) in latent:
                    s = w * s + (1 - w) * latent[(pid1, pid2)]
                if s > self.cfg.predicate_soft_sim:
                    alignment_set.add((p1, p2, s))

            if predicate_type == "relation":
                self.relation_alignment_set = alignment_set
                self.update_relation_triples(alignment_set)
            else:
                self.attribute_alignment_set = alignment_set
                self.update_attribute_triples(alignment_set)
