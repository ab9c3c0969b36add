"""File readers for the reference's TSV dataset layout.

Behavioral parity targets (cited against the original MultiKE code):
  * relation triples  — base/read.py:216-233 (3 tab-separated columns, strip)
  * attribute triples — base/read.py:341-364 (>=3 columns; extra columns are
    joined by a space; trailing '.' stripped)
  * links             — base/read.py:236-251 (2 columns)
  * entity local names    — utils.py:108-137 (strip trailing '(...)', '_'->' ',
    missing entities get '')
  * predicate local names — predicate_alignment.py:75-86 (split into relation
    vs attribute dicts by membership in the relation URI set)

Triple files are read by ``utils.native.tsv_read_triples``.
"""
from __future__ import annotations

import os
from typing import Dict, List, Set, Tuple

from multike_tpu_torch.utils.native import tsv_read_triples


def read_relation_triples(file_path: str):
    """Returns (triples:set[(h,r,t)], entities:set, relations:set)."""
    if file_path is None or not os.path.exists(file_path):
        return set(), set(), set()
    triples, entities, relations = set(), set(), set()
    rows = tsv_read_triples(file_path)
    for params in rows:
        assert len(params) == 3, f"bad relation triple line: {params!r}"
        h, r, t = (p.strip() for p in params)
        triples.add((h, r, t))
        entities.add(h)
        entities.add(t)
        relations.add(r)
    return triples, entities, relations


def read_attribute_triples(file_path: str):
    """Returns (triples:set[(e,a,value)], entities:set, attributes:set).

    Columns beyond the third are folded into the value joined by spaces, and a
    trailing '.' is stripped — matching base/read.py:351-363.
    """
    if file_path is None or not os.path.exists(file_path):
        return set(), set(), set()
    triples, entities, attributes = set(), set(), set()
    with open(file_path, "r", encoding="utf8") as f:
        for line in f:
            params = line.strip().strip("\n").split("\t")
            if len(params) < 3:
                continue
            head = params[0].strip()
            attr = params[1].strip()
            value = params[2].strip()
            for p in params[3:]:
                value = value + " " + p.strip()
            value = value.strip().rstrip(".").strip()
            entities.add(head)
            attributes.add(attr)
            triples.add((head, attr, value))
    return triples, entities, attributes


def read_links(file_path: str) -> List[Tuple[str, str]]:
    links = []
    with open(file_path, "r", encoding="utf8") as f:
        for line in f:
            params = line.strip("\n").split("\t")
            assert len(params) == 2, f"bad link line: {params!r}"
            links.append((params[0].strip(), params[1].strip()))
    return links


def read_dict(file_path: str) -> Dict[str, int]:
    ids = {}
    with open(file_path, "r", encoding="utf8") as f:
        for line in f:
            params = line.strip("\n").split("\t")
            assert len(params) == 2
            ids[params[0]] = int(params[1])
    return ids


def read_pair_ids(file_path: str) -> List[Tuple[int, int]]:
    pairs = []
    with open(file_path, "r", encoding="utf8") as f:
        for line in f:
            params = line.strip("\n").split("\t")
            assert len(params) == 2
            pairs.append((int(params[0]), int(params[1])))
    return pairs


def _clean_local_name(ln: str) -> str:
    # utils.py:128-130: strip a trailing parenthesised qualifier, '_' -> ' '
    if ln.endswith(")"):
        ln = ln.split("(")[0]
    return ln.replace("_", " ")


def read_local_name_file(file_path: str, entities_set: Set[str]) -> Dict[str, str]:
    entity_local_name: Dict[str, str] = {}
    with open(file_path, "r", encoding="utf-8") as f:
        for line in f:
            params = line.strip("\n").split("\t")
            assert len(params) == 2
            entity_local_name[params[0]] = _clean_local_name(params[1])
    for e in entities_set:
        if e not in entity_local_name:
            entity_local_name[e] = ""  # utils.py:133-135
    assert len(entity_local_name) >= len(entities_set)
    return entity_local_name


def read_local_names(folder_path: str, entities_set_1: Set[str],
                     entities_set_2: Set[str]) -> Dict[str, str]:
    """utils.py:108-114: load + merge both KGs' entity local names."""
    d = read_local_name_file(folder_path + "entity_local_name_1", entities_set_1)
    d.update(read_local_name_file(folder_path + "entity_local_name_2", entities_set_2))
    return d


def read_predicate_local_names(file_path: str, relation_set: Set[str]):
    """predicate_alignment.py:75-86: URIs in relation_set go to the relation
    dict, everything else to the attribute dict."""
    relation_local_name, attribute_local_name = {}, {}
    with open(file_path, "r", encoding="utf-8") as f:
        for line in f:
            params = line.strip("\n").split("\t")
            assert len(params) == 2
            if params[0] in relation_set:
                relation_local_name[params[0]] = params[1]
            else:
                attribute_local_name[params[0]] = params[1]
    return relation_local_name, attribute_local_name
