"""URI -> integer id assignment.

Two schemes, mirroring base/read.py:12-87:
  * ``mapping``  — disjoint id spaces. ``ordered=True`` interleaves by
    frequency (kg1 even ids / kg2 odd ids, base/read.py:59-74); the default
    path used by DataModel is ``ordered=False`` (data_model.py:70) which gives
    plain sequential ids: kg1 elements 0..n1-1 then kg2 elements n1..n1+n2-1
    (base/read.py:75-84). Contiguous per-KG ranges are exactly what on-device uniform
    negative sampling wants.
  * ``sharing``  — linked elements share one id (base/read.py:27-56).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple


def sort_elements(triples, elements_set):
    """Frequency count of elements inside triples; sorted by (count, uri)
    descending — base/read.py:12-24."""
    dic: Dict[str, int] = {}
    for s, p, o in triples:
        if s in elements_set:
            dic[s] = dic.get(s, 0) + 1
        if p in elements_set:
            dic[p] = dic.get(p, 0) + 1
        if o in elements_set:
            dic[o] = dic.get(o, 0) + 1
    sorted_list = sorted(dic.items(), key=lambda x: (x[1], x[0]), reverse=True)
    return [x[0] for x in sorted_list], dic


def generate_mapping_id(kg1_triples, kg1_elements, kg2_triples, kg2_elements,
                        ordered: bool = True):
    ids1: Dict[str, int] = {}
    ids2: Dict[str, int] = {}
    if ordered:
        kg1_ordered, _ = sort_elements(kg1_triples, kg1_elements)
        kg2_ordered, _ = sort_elements(kg2_triples, kg2_elements)
        n1, n2 = len(kg1_ordered), len(kg2_ordered)
        for i in range(max(n1, n2)):
            if i < n1 and i < n2:
                ids1[kg1_ordered[i]] = i * 2
                ids2[kg2_ordered[i]] = i * 2 + 1
            elif i >= n1:
                ids2[kg2_ordered[i]] = n1 * 2 + (i - n1)
            else:
                ids1[kg1_ordered[i]] = n2 * 2 + (i - n2)
    else:
        # Deterministic sequential ids: iterate in sorted-URI order so the
        # URI->id mapping is independent of Python hash randomization
        # (reference iterates raw sets -> run-to-run nondeterminism).
        index = 0
        for ele in sorted(kg1_elements):
            if ele not in ids1:
                ids1[ele] = index
                index += 1
        for ele in sorted(kg2_elements):
            if ele not in ids2:
                ids2[ele] = index
                index += 1
    assert len(ids1) == len(set(kg1_elements))
    assert len(ids2) == len(set(kg2_elements))
    return ids1, ids2


def generate_sharing_id(train_links, kg1_triples, kg1_elements, kg2_triples,
                        kg2_elements, ordered: bool = True):
    ids1: Dict[str, int] = {}
    ids2: Dict[str, int] = {}
    if ordered:
        linked = {y: x for x, y in train_links}
        kg2_linked = [x[1] for x in train_links]
        kg2_unlinked = sorted(set(kg2_elements) - set(kg2_linked))
        ids1, ids2 = generate_mapping_id(kg1_triples, kg1_elements,
                                         kg2_triples, kg2_unlinked, ordered=True)
        for ele in kg2_linked:
            ids2[ele] = ids1[linked[ele]]
    else:
        index = 0
        for e1, e2 in train_links:
            assert e1 in kg1_elements
            assert e2 in kg2_elements
            ids1[e1] = index
            ids2[e2] = index
            index += 1
        for ele in kg1_elements:
            if ele not in ids1:
                ids1[ele] = index
                index += 1
        for ele in kg2_elements:
            if ele not in ids2:
                ids2[ele] = index
                index += 1
    assert len(ids1) == len(set(kg1_elements))
    assert len(ids2) == len(set(kg2_elements))
    return ids1, ids2


# --- uri -> id conversions (base/read.py:90-127) ---

def uris_list_2ids(uris: Iterable[str], ids: Dict[str, int]) -> List[int]:
    out = []
    for u in uris:
        assert u in ids
        out.append(ids[u])
    return out


def uris_pair_2ids(uris, ids1, ids2) -> List[Tuple[int, int]]:
    out = []
    for u1, u2 in uris:
        assert u1 in ids1, f"unknown link endpoint {u1!r}"
        assert u2 in ids2, f"unknown link endpoint {u2!r}"
        out.append((ids1[u1], ids2[u2]))
    assert len(out) == len(set(uris))
    return out


def uris_relation_triple_2ids(uris, ent_ids, rel_ids):
    out = []
    for u1, u2, u3 in uris:
        assert u1 in ent_ids and u2 in rel_ids and u3 in ent_ids
        out.append((ent_ids[u1], rel_ids[u2], ent_ids[u3]))
    assert len(out) == len(set(uris))
    return out


def uris_attribute_triple_2ids(uris, ent_ids, attr_ids):
    """Value stays a raw string at this stage (base/read.py:120-127); values
    are re-indexed to literal ids later by the DataModel."""
    out = []
    for u1, u2, u3 in uris:
        assert u1 in ent_ids and u2 in attr_ids
        out.append((ent_ids[u1], attr_ids[u2], u3))
    assert len(out) == len(set(uris))
    return out
