"""The KG pair, names and initial tables of an ITC driver cell, made from the
run's ``--seed`` (the same seed gives the same pair and tables), beside
``lib/data.py``, whose streams and helpers it shares.

The pair (``pair``), from a mix's ``entities_per_kg``, ``triples``,
``relations``, ``attributes``, ``attribute_triples``, ``links`` and
``shared_names``:

  * relation triples with uniform heads, relations and tails, as
    ``data.kg_pair_triples`` draws them, except that the heads of each KG's
    first ``entities_per_kg`` triples are a permutation of its entities,
    so that every entity is in a relation triple (the program assigns
    entity ids from the relation triples); duplicates are dropped;
  * attribute triples with uniform heads and attributes; each literal
    value is the value of two attribute triples, over both KGs;
  * links: KG1's entity i to KG2's entity n + p(i), p a permutation,
    split into train, valid and test by ``links`` (shares);
  * predicate local names: of the KG with fewer relations (attributes),
    ``shared_names`` of its relations (attributes) take the name of one of
    the other KG's, so the Levenshtein seed alignment finds them; every
    other name is a random word of 12 letters.

Entities are the ints [0, n) and [n, 2n); a relation is ``"r<kg>.<i>"`` and
an attribute ``"a<kg>.<i>"``, with ``i`` zero-padded, so the program's
sequential ids follow these numbers: KG1's relations [0, r1), KG2's
[r1, r1 + r2), and the same for attributes. The cell checks that the
program's id dictionaries agree.

The tables (``tables``) are made on the device from one generator, in a
fixed order: the entity and predicate tables as TF1's
``xavier_initializer(uniform=False)`` (``data.xavier_normal``), each CNN
scorer as the reference builds it (batch norm gamma 1, beta 0; Glorot
uniform kernels and dense weights; zero biases). The name and literal
vectors (``vectors``) are unit rows of the embedding width, standing in for
the literal autoencoder's output.
"""
from __future__ import annotations

import numpy as np
import torch

from gpubench.lib import data

COVER, ATTRIBUTES, LINKS, NAMES, TABLES, VECTORS = 11, 12, 13, 14, 15, 16
ENTITY_TABLES = ("rv_ent", "av_ent", "ent")
CONVS = ("conv_av", "conv_ckge", "conv_ckga")
KERNEL, FEATURE_MAPS, CONV_LAYERS = (2, 4), 2, 2


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(data.derived_seed(seed, stream))


def relation_name(kg: int, i: int) -> str:
    return f"r{kg}.{i:05d}"


def attribute_name(kg: int, i: int) -> str:
    return f"a{kg}.{i:05d}"


def _words(rng, count: int) -> list:
    letters = rng.integers(0, 26, size=(count, 12))
    return ["".join(chr(97 + c) for c in row) for row in letters]


def _names(rng, n1: int, n2: int, shared: int):
    """Local names of two KGs' predicates: ``shared`` of the smaller side's
    take a name of the other side's, picked without repeat."""
    first, second = _words(rng, n1), _words(rng, n2)
    small, big = (first, second) if n1 <= n2 else (second, first)
    if shared > len(small):
        raise ValueError(f"{shared} shared names among {len(small)}")
    mine = rng.choice(len(small), size=shared, replace=False)
    theirs = rng.choice(len(big), size=shared, replace=False)
    for i, j in zip(mine, theirs):
        small[i] = big[j]
    return first, second


def _unique_rows(rows: np.ndarray) -> np.ndarray:
    """The distinct rows of an (m, 3) array of non-negative ints, sorted."""
    base = rows.max(axis=0) + 1
    key = (rows[:, 0] * base[1] + rows[:, 1]) * base[2] + rows[:, 2]
    return rows[np.unique(key, return_index=True)[1]]


def pair(seed: int, mix: dict) -> dict:
    """The KG pair of a mix, as numpy arrays of global ids: ``rel`` and
    ``attr`` (one (m, 3) int64 array per KG; an attribute triple's third
    column is its value id), ``values`` (the number of distinct values),
    ``links`` (``{"train", "valid", "test"}`` of (m, 2) arrays), the
    predicate names ``rel_names`` and ``attr_names`` (a list per KG) and
    the id offsets ``rel_lo`` and ``attr_lo`` of each KG."""
    n = mix["entities_per_kg"]
    rels, attrs = mix["relations"], mix["attributes"]
    if min(mix["triples"]) < n:
        raise ValueError("each KG needs at least one relation triple an "
                         "entity")
    rel = list(data.kg_pair_triples(seed, n, mix["triples"], rels))
    rng = _rng(seed, COVER)
    for k in range(2):
        rel[k][:n, 0] = k * n + rng.permutation(n)
        rel[k] = _unique_rows(rel[k])

    rng = _rng(seed, ATTRIBUTES)
    counts = mix["attribute_triples"]
    total = sum(counts)
    value = rng.permutation(total) // 2
    attr, attr_lo, start = [], (0, attrs[0]), 0
    for k in range(2):
        m = counts[k]
        h = k * n + rng.integers(0, n, size=m)
        a = attr_lo[k] + rng.integers(0, attrs[k], size=m)
        attr.append(_unique_rows(np.stack([h, a, value[start:start + m]],
                                          1).astype(np.int64)))
        start += m

    rng = _rng(seed, LINKS)
    order = rng.permutation(n)
    partner = n + rng.permutation(n)
    shares = np.cumsum([int(s * n) for s in mix["links"]])
    parts = np.split(order, shares[:2])
    links = {name: np.stack([p, partner[p]], 1)
             for name, p in zip(("train", "valid", "test"), parts)}

    rng = _rng(seed, NAMES)
    shared = mix["shared_names"]
    return dict(rel=rel, attr=attr, values=(total + 1) // 2, links=links,
                rel_names=_names(rng, rels[0], rels[1], shared["relations"]),
                attr_names=_names(rng, attrs[0], attrs[1],
                                  shared["attributes"]),
                rel_lo=(0, rels[0]), attr_lo=attr_lo)


def glorot_uniform(gen: torch.Generator, shape, fan_in: int, fan_out: int,
                   device) -> torch.Tensor:
    limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return t.uniform_(-limit, limit, generator=gen)


def conv_tables(gen: torch.Generator, dim: int, device) -> dict:
    """One CNN scorer: batch norm, two (2, 4) convolutions with 2 feature
    maps (kernels (kh, kw, in, out)), the dense layer 4d -> d."""
    kh, kw = KERNEL
    out = {"bn_gamma": torch.ones(dim, device=device),
           "bn_beta": torch.zeros(dim, device=device)}
    ch = 1
    for i in range(CONV_LAYERS):
        out[f"conv{i}_w"] = glorot_uniform(
            gen, (kh, kw, ch, FEATURE_MAPS), kh * kw * ch,
            kh * kw * FEATURE_MAPS, device)
        out[f"conv{i}_b"] = torch.zeros(FEATURE_MAPS, device=device)
        ch = FEATURE_MAPS
    flat = 2 * dim * FEATURE_MAPS
    out["dense_w"] = glorot_uniform(gen, (flat, dim), flat, dim, device)
    out["dense_b"] = torch.zeros(dim, device=device)
    return out


def tables(seed: int, entities: int, relations: int, attributes: int,
           dim: int, device) -> dict:
    """Every table the ITC streams train, float32 on ``device``: the three
    entity tables, ``rel``, ``attr`` and the three CNN scorers."""
    gen = torch.Generator(device=device)
    gen.manual_seed(data.derived_seed(seed, TABLES))
    out = {name: data.xavier_normal(gen, entities, dim, device)
           for name in ENTITY_TABLES}
    out["rel"] = data.xavier_normal(gen, relations, dim, device)
    out["attr"] = data.xavier_normal(gen, attributes, dim, device)
    for name in CONVS:
        out[name] = conv_tables(gen, dim, device)
    return out


def vectors(seed: int, entities: int, values: int, dim: int):
    """(name vectors (entities, dim), literal vectors (values, dim)): unit
    rows, float32 numpy arrays, made on the CPU in bulk."""
    gen = torch.Generator()
    gen.manual_seed(data.derived_seed(seed, VECTORS))
    out = []
    for rows in (entities, values):
        v = torch.randn((rows, dim), generator=gen, dtype=torch.float32)
        out.append((v / v.norm(dim=1, keepdim=True)).numpy())
    return tuple(out)
