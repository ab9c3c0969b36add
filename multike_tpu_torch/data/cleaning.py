"""Attribute-triple cleaning (counterpart of multike_tpu/data/cleaning.py).

Step 1: drop attributes used by < 10 triples.
Step 2: strip '"^^' datatype suffixes and '"@en' language tags, classify
number vs string literals, strip punctuation, and drop values containing
'http'.
"""
from __future__ import annotations

import unicodedata
from typing import Iterable, List, Tuple

MIN_ATTR_FREQ = 10


def is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        pass
    try:
        unicodedata.numeric(s)
        return True
    except (TypeError, ValueError):
        pass
    return False


def clear_attribute_triples(attribute_triples: Iterable[Tuple]):
    """Returns (cleaned_triples:list, literals_number:list, literals_string:list)."""
    attribute_triples = set(attribute_triples)
    # step 1: frequency filter on attributes
    attr_num = {}
    for (e, a, _) in attribute_triples:
        attr_num[a] = attr_num.get(a, 0) + 1
    keep = {a for a, n in attr_num.items() if n >= MIN_ATTR_FREQ}
    attribute_triples = {(e, a, v) for (e, a, v) in attribute_triples if a in keep}

    # step 2: literal normalization
    out: List[Tuple] = []
    literals_number: List[str] = []
    literals_string: List[str] = []
    for (e, a, v) in attribute_triples:
        if '"^^' in v:
            v = v[:v.index('"^^')]
        if v.endswith('"@en'):
            v = v[:v.index('"@en')]
        if is_number(v):
            literals_number.append(v)
        else:
            literals_string.append(v)
        v = (v.replace('.', '').replace('(', '').replace(')', '')
              .replace(',', '').replace('"', ''))
        v = v.replace('_', ' ').replace('-', ' ').replace('/', ' ')
        if 'http' in v:
            continue
        out.append((e, a, v))
    return out, literals_number, literals_string
