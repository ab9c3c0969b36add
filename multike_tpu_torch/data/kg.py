"""KG / KGs containers.

Functional parity with base/kg.py:10-143 and base/kgs.py:5-97, re-shaped for a
device pipeline: in addition to the reference's sets/lists/dicts, each KG exposes
its triple sets as contiguous ``numpy`` int32 arrays (the device-side currency
of the framework), and KGs records the contiguous per-KG entity id ranges that
sequential id assignment produces (base/read.py:75-84) — those ranges drive
on-device uniform negative sampling and edge partitioning.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from multike_tpu_torch.data import ids as idlib
from multike_tpu_torch.data.readers import (read_attribute_triples, read_links,
                                      read_relation_triples)


def parse_triples(triples):
    subjects, predicates, objects = set(), set(), set()
    for s, p, o in triples:
        subjects.add(s)
        predicates.add(p)
        objects.add(o)
    return subjects, predicates, objects


def triples_to_array(triples) -> np.ndarray:
    """Triple collection -> (n,3) int32 array (sorted for determinism)."""
    if not triples:
        return np.zeros((0, 3), dtype=np.int32)
    return np.array(sorted(triples), dtype=np.int32)


class KG:
    """Single-KG container over *id* triples (base/kg.py:10-143).

    Attribute triples may carry string values before literal re-indexing and
    int literal-ids after ``set_attributes`` is re-run by the DataModel
    (data_model.py:141-144).

    The sorted lists and the per-entity dicts are made at their first read
    and kept until the triples they come from change: at DWY100K's size
    each takes seconds, and the KGs that only carry URIs to the id
    assignment (``KGs``) never read them.
    """

    _RELATION_VIEWS = ("relation_triples_list", "local_relation_triples_list",
                       "entities_list", "relations_list", "rt_dict",
                       "hr_dict", "entity_relations_dict")
    _ATTRIBUTE_VIEWS = ("attribute_triples_list",
                        "local_attribute_triples_list", "attributes_list",
                        "av_dict", "entity_attributes_dict")

    def __init__(self, relation_triples, attribute_triples, verbose: bool = False):
        self.entities_id_dict: Optional[Dict[str, int]] = None
        self.relations_id_dict: Optional[Dict[str, int]] = None
        self.attributes_id_dict: Optional[Dict[str, int]] = None

        self.sup_relation_triples_set: Set[Tuple] = set()
        self.sup_relation_triples_list: List[Tuple] = []
        self.sup_attribute_triples_set: Set[Tuple] = set()
        self.sup_attribute_triples_list: List[Tuple] = []

        self.set_relations(relation_triples)
        self.set_attributes(attribute_triples)

        if verbose:
            print("KG statistics: entities={} relations={} attributes={} "
                  "rel_triples={} attr_triples={}".format(
                      self.entities_num, self.relations_num,
                      self.attributes_num, self.relation_triples_num,
                      self.attribute_triples_num))

    def _forget(self, names):
        for name in names:
            self.__dict__.pop(name, None)

    # --- relation side -------------------------------------------------
    def set_relations(self, relation_triples):
        self.relation_triples_set = set(relation_triples)
        # 'local' = without swapped sup triples (base/kg.py:59-60)
        self.local_relation_triples_set = set(self.relation_triples_set)

        heads, relations, tails = parse_triples(self.relation_triples_set)
        self.entities_set = heads | tails
        self.relations_set = relations
        self.entities_num = len(self.entities_set)
        self.relations_num = len(self.relations_set)
        self.relation_triples_num = len(self.relation_triples_set)
        self.local_relation_triples_num = len(self.local_relation_triples_set)
        self._forget(self._RELATION_VIEWS)

    def set_attributes(self, attribute_triples):
        self.attribute_triples_set = set(attribute_triples)
        self.local_attribute_triples_set = set(self.attribute_triples_set)

        _, attributes, _ = parse_triples(self.attribute_triples_set)
        self.attributes_set = attributes
        self.attributes_num = len(self.attributes_set)
        self.attribute_triples_num = len(self.attribute_triples_set)
        self.local_attribute_triples_num = len(self.local_attribute_triples_set)
        self._forget(self._ATTRIBUTE_VIEWS)

    @functools.cached_property
    def relation_triples_list(self) -> List[Tuple]:
        return sorted(self.relation_triples_set)

    @functools.cached_property
    def local_relation_triples_list(self) -> List[Tuple]:
        return sorted(self.local_relation_triples_set)

    @functools.cached_property
    def entities_list(self) -> List:
        return sorted(self.entities_set)

    @functools.cached_property
    def relations_list(self) -> List:
        return sorted(self.relations_set)

    @functools.cached_property
    def attribute_triples_list(self) -> List[Tuple]:
        return sorted(self.attribute_triples_set)

    @functools.cached_property
    def local_attribute_triples_list(self) -> List[Tuple]:
        return sorted(self.local_attribute_triples_set)

    @functools.cached_property
    def attributes_list(self) -> List:
        return sorted(self.attributes_set)

    @functools.cached_property
    def rt_dict(self) -> Dict[int, Set[Tuple]]:
        out: Dict[int, Set[Tuple]] = {}
        for h, r, t in self.local_relation_triples_list:
            out.setdefault(h, set()).add((r, t))
        return out

    @functools.cached_property
    def hr_dict(self) -> Dict[int, Set[Tuple]]:
        out: Dict[int, Set[Tuple]] = {}
        for h, r, t in self.local_relation_triples_list:
            out.setdefault(t, set()).add((h, r))
        return out

    @functools.cached_property
    def av_dict(self) -> Dict[int, Set[Tuple]]:
        out: Dict[int, Set[Tuple]] = {}
        for h, a, v in self.local_attribute_triples_list:
            out.setdefault(h, set()).add((a, v))
        return out

    @functools.cached_property
    def entity_relations_dict(self) -> Dict[int, Set]:
        out: Dict[int, Set] = {}
        for ent, rel, _ in self.local_relation_triples_set:
            out.setdefault(ent, set()).add(rel)
        return out

    @functools.cached_property
    def entity_attributes_dict(self) -> Dict[int, Set]:
        out: Dict[int, Set] = {}
        for ent, attr, _ in self.local_attribute_triples_set:
            out.setdefault(ent, set()).add(attr)
        return out

    def set_id_dict(self, entities_id_dict, relations_id_dict, attributes_id_dict):
        self.entities_id_dict = entities_id_dict
        self.relations_id_dict = relations_id_dict
        self.attributes_id_dict = attributes_id_dict

    def add_sup_relation_triples(self, sup_triples):
        self.sup_relation_triples_set = set(sup_triples)
        self.sup_relation_triples_list = sorted(self.sup_relation_triples_set)
        self.relation_triples_set |= self.sup_relation_triples_set
        self.relation_triples_num = len(self.relation_triples_set)
        self._forget(("relation_triples_list",))

    def add_sup_attribute_triples(self, sup_triples):
        self.sup_attribute_triples_set = set(sup_triples)
        self.sup_attribute_triples_list = sorted(self.sup_attribute_triples_set)
        self.attribute_triples_set |= self.sup_attribute_triples_set
        self.attribute_triples_num = len(self.attribute_triples_set)
        self._forget(("attribute_triples_list",))

    # --- device-side views --------------------------------------------
    @property
    def local_relation_triples_array(self) -> np.ndarray:
        return triples_to_array(self.local_relation_triples_set)

    @property
    def sup_relation_triples_array(self) -> np.ndarray:
        return triples_to_array(self.sup_relation_triples_set)


# ---------------------------------------------------------------------------
# Swapped supervision triples (base/read.py:130-161)
# ---------------------------------------------------------------------------

def generate_sup_relation_triples(sup_links, rt_dict1, hr_dict1, rt_dict2, hr_dict2):
    def one_link(e1, e2, rt_dict, hr_dict):
        new_triples = set()
        for r, t in rt_dict.get(e1, set()):
            new_triples.add((e2, r, t))
        for h, r in hr_dict.get(e1, set()):
            new_triples.add((h, r, e2))
        return new_triples

    new1, new2 = set(), set()
    for ent1, ent2 in sup_links:
        new1 |= one_link(ent1, ent2, rt_dict1, hr_dict1)
        new2 |= one_link(ent2, ent1, rt_dict2, hr_dict2)
    return new1, new2


def generate_sup_attribute_triples(sup_links, av_dict1, av_dict2):
    def one_link(e1, e2, av_dict):
        return {(e2, a, v) for a, v in av_dict.get(e1, set())}

    new1, new2 = set(), set()
    for ent1, ent2 in sup_links:
        new1 |= one_link(ent1, ent2, av_dict1)
        new2 |= one_link(ent2, ent1, av_dict2)
    return new1, new2


class KGs:
    """Pair-of-KGs container (base/kgs.py:5-73)."""

    def __init__(self, kg1: KG, kg2: KG, train_links, valid_links,
                 test_links=None, mode: str = "mapping", ordered: bool = True):
        if mode == "sharing":
            ent_ids1, ent_ids2 = idlib.generate_sharing_id(
                train_links, kg1.relation_triples_set, kg1.entities_set,
                kg2.relation_triples_set, kg2.entities_set, ordered=ordered)
            rel_ids1, rel_ids2 = idlib.generate_sharing_id(
                [], kg1.relation_triples_set, kg1.relations_set,
                kg2.relation_triples_set, kg2.relations_set, ordered=ordered)
            attr_ids1, attr_ids2 = idlib.generate_sharing_id(
                [], kg1.attribute_triples_set, kg1.attributes_set,
                kg2.attribute_triples_set, kg2.attributes_set, ordered=ordered)
        else:
            ent_ids1, ent_ids2 = idlib.generate_mapping_id(
                kg1.relation_triples_set, kg1.entities_set,
                kg2.relation_triples_set, kg2.entities_set, ordered=ordered)
            rel_ids1, rel_ids2 = idlib.generate_mapping_id(
                kg1.relation_triples_set, kg1.relations_set,
                kg2.relation_triples_set, kg2.relations_set, ordered=ordered)
            attr_ids1, attr_ids2 = idlib.generate_mapping_id(
                kg1.attribute_triples_set, kg1.attributes_set,
                kg2.attribute_triples_set, kg2.attributes_set, ordered=ordered)

        id_rel_triples1 = idlib.uris_relation_triple_2ids(
            kg1.relation_triples_set, ent_ids1, rel_ids1)
        id_rel_triples2 = idlib.uris_relation_triple_2ids(
            kg2.relation_triples_set, ent_ids2, rel_ids2)
        id_attr_triples1 = idlib.uris_attribute_triple_2ids(
            kg1.attribute_triples_set, ent_ids1, attr_ids1)
        id_attr_triples2 = idlib.uris_attribute_triple_2ids(
            kg2.attribute_triples_set, ent_ids2, attr_ids2)

        self.uri_kg1, self.uri_kg2 = kg1, kg2

        kg1 = KG(id_rel_triples1, id_attr_triples1)
        kg2 = KG(id_rel_triples2, id_attr_triples2)
        kg1.set_id_dict(ent_ids1, rel_ids1, attr_ids1)
        kg2.set_id_dict(ent_ids2, rel_ids2, attr_ids2)

        self.uri_train_links = train_links
        self.uri_valid_links = valid_links
        self.train_links = idlib.uris_pair_2ids(train_links, ent_ids1, ent_ids2)
        self.valid_links = idlib.uris_pair_2ids(valid_links, ent_ids1, ent_ids2)
        self.train_entities1 = [l[0] for l in self.train_links]
        self.train_entities2 = [l[1] for l in self.train_links]
        self.valid_entities1 = [l[0] for l in self.valid_links]
        self.valid_entities2 = [l[1] for l in self.valid_links]

        if mode == "swapping":
            sup1, sup2 = generate_sup_relation_triples(
                self.train_links, kg1.rt_dict, kg1.hr_dict, kg2.rt_dict, kg2.hr_dict)
            kg1.add_sup_relation_triples(sup1)
            kg2.add_sup_relation_triples(sup2)
            sup1, sup2 = generate_sup_attribute_triples(
                self.train_links, kg1.av_dict, kg2.av_dict)
            kg1.add_sup_attribute_triples(sup1)
            kg2.add_sup_attribute_triples(sup2)

        self.kg1, self.kg2 = kg1, kg2

        self.test_links: List[Tuple[int, int]] = []
        self.test_entities1: List[int] = []
        self.test_entities2: List[int] = []
        if test_links is not None:
            self.uri_test_links = test_links
            self.test_links = idlib.uris_pair_2ids(test_links, ent_ids1, ent_ids2)
            self.test_entities1 = [l[0] for l in self.test_links]
            self.test_entities2 = [l[1] for l in self.test_links]

        self.useful_entities_list1 = (self.train_entities1 + self.valid_entities1
                                      + self.test_entities1)
        self.useful_entities_list2 = (self.train_entities2 + self.valid_entities2
                                      + self.test_entities2)

        self.entities_num = len(self.kg1.entities_set | self.kg2.entities_set)
        self.relations_num = len(self.kg1.relations_set | self.kg2.relations_set)
        self.attributes_num = len(self.kg1.attributes_set | self.kg2.attributes_set)

    # --- contiguous id ranges under sequential (ordered=False) mapping ---
    def entity_id_ranges(self) -> Tuple[Tuple[int, int], Tuple[int, int]]:
        """((lo1, hi1), (lo2, hi2)) half-open entity-id ranges per KG.

        Valid under the sequential id scheme DataModel uses
        (data_model.py:70 passes ordered=False). Verified, not assumed.
        """
        ids1 = np.array(sorted(self.kg1.entities_id_dict.values()))
        ids2 = np.array(sorted(self.kg2.entities_id_dict.values()))
        r1 = (int(ids1[0]), int(ids1[-1]) + 1)
        r2 = (int(ids2[0]), int(ids2[-1]) + 1)
        assert len(ids1) == r1[1] - r1[0], "kg1 entity ids not contiguous"
        assert len(ids2) == r2[1] - r2[0], "kg2 entity ids not contiguous"
        return r1, r2


def read_kgs_from_files(kg1_relation_triples, kg2_relation_triples,
                        kg1_attribute_triples, kg2_attribute_triples,
                        train_links, valid_links, test_links,
                        mode: str) -> KGs:
    """base/kgs.py:92-97: assemble KGs from in-memory URI triples."""
    kg1 = KG(kg1_relation_triples, kg1_attribute_triples)
    kg2 = KG(kg2_relation_triples, kg2_attribute_triples)
    return KGs(kg1, kg2, train_links, valid_links, test_links=test_links,
               mode=mode)


def read_kgs_from_folder(training_data_folder: str, division: str, mode: str,
                         ordered: bool) -> KGs:
    """base/kgs.py:76-89."""
    kg1_rel, _, _ = read_relation_triples(training_data_folder + "rel_triples_1")
    kg2_rel, _, _ = read_relation_triples(training_data_folder + "rel_triples_2")
    kg1_attr, _, _ = read_attribute_triples(training_data_folder + "attr_triples_1")
    kg2_attr, _, _ = read_attribute_triples(training_data_folder + "attr_triples_2")
    train_links = read_links(training_data_folder + division + "train_links")
    valid_links = read_links(training_data_folder + division + "valid_links")
    test_links = read_links(training_data_folder + division + "test_links")
    kg1 = KG(kg1_rel, kg1_attr)
    kg2 = KG(kg2_rel, kg2_attr)
    return KGs(kg1, kg2, train_links, valid_links, test_links=test_links,
               mode=mode, ordered=ordered)
