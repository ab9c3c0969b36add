"""Synthetic two-KG dataset generator in the reference folder layout.

Produces the exact file set ``read_kgs_from_folder`` + ``DataModel`` expect
(rel_triples_{1,2}, attr_triples_{1,2}, entity_local_name_{1,2},
predicate_local_name_{1,2}, <division>/{train,valid,test}_links and a small
fastText-style ``.vec`` word-embedding file), so tests and benchmarks can run
end-to-end without the (absent) DWY100K archive.

Every view carries CONTROLLED, PARTIAL signal at any dataset size (VERDICT
r3 item 3 — the r3 generator's attribute values were drawn independently per
KG, so the attribute view had literally zero cross-KG signal, and entity
names drew from a 39-word vocabulary, so at 50K entities the name view
measured word-pair collisions instead of alignment):

* **name view**: entity names are unique word triples over a vocabulary that
  scales with the entity count (base-V digit decomposition => no collisions);
  ``name_noise`` is the fraction of KG2 entities whose name is REPLACED by an
  unrelated one — the name view's ceiling is ~(1 - name_noise).
* **relation view**: both KGs are noisy copies of one underlying edge set;
  ``rel_noise`` is the probability a KG2 edge's tail is rewired.
* **attribute view**: ONE set of base (entity, attribute, value) facts is
  generated and both KGs serialize noisy copies of it — aligned entities
  share most of their (attribute, value) pairs, which is exactly the signal
  the attribute CNN can align on. ``attr_noise`` is the probability a KG2
  fact is dropped or its value re-drawn; ``attr_noise=1.0`` reproduces the
  r3 generator's no-signal regime (used by the A/B that diagnosed the SSL
  av collapse, docs/EXPERIMENTS.md r4).

**Complementary noise placement** (``complementary=True``, default): each
entity is deterministically assigned ONE weak view (name / relation /
attribute, a third each) and that view's noise budget is concentrated on its
weak third (rate 3x the knob, capped at 1). Every entity then has two clean
views covering its one weak view — the structure real EA datasets have
(incomplete views fail on different entities) and the regime where the
MultiKE combination property (final > best single view, reference
MultiKE_Late.py:275-280) is demonstrable. ``complementary=False`` spreads
each noise uniformly over all entities (uncorrelated view errors).
"""
from __future__ import annotations

import os
import random
from typing import List, Tuple

import numpy as np

_CONS = "bcdfghjklmnprstvz"
_VOW = "aeiou"
_SYLL = [c + v for c in _CONS for v in _VOW]          # 85 distinct syllables


def _word(i: int) -> str:
    """Deterministic pseudo-word #i (3 syllables => 614k distinct words)."""
    s = len(_SYLL)
    return _SYLL[i % s] + _SYLL[(i // s) % s] + _SYLL[(i // (s * s)) % s]


def _make_vocab(n: int) -> List[str]:
    return [_word(i) for i in range(n)]


def generate(folder: str,
             n_entities: int = 120,
             n_relations: int = 8,
             n_attributes: int = 6,
             n_rel_triples: int = 600,
             n_attr_triples: int = 400,
             division: str = "631/",
             link_fracs: Tuple[float, float, float] = (0.6, 0.1, 0.3),
             seed: int = 7,
             write_word2vec: bool = True,
             rel_noise: float = 0.2,
             attr_noise: float = 0.25,
             name_noise: float = 0.1,
             complementary: bool = True) -> str:
    rng = random.Random(seed)
    os.makedirs(folder, exist_ok=True)
    os.makedirs(os.path.join(folder, division.strip("/")), exist_ok=True)

    ents1 = [f"http://kg1/e{i}" for i in range(n_entities)]
    ents2 = [f"http://kg2/ent{i}" for i in range(n_entities)]
    rels1 = [f"http://kg1/r{i}" for i in range(n_relations)]
    rels2 = [f"http://kg2/rel{i}" for i in range(n_relations)]
    attrs1 = [f"http://kg1/a{i}" for i in range(n_attributes)]
    attrs2 = [f"http://kg2/attr{i}" for i in range(n_attributes)]

    # Vocabulary scaled so V^3 >> n_entities (unique 3-word names) while the
    # .vec file stays small (V words of 300 dims).
    V = max(40, int(round((20.0 * max(n_entities, 1)) ** (1.0 / 3.0))))
    vocab = _make_vocab(V)

    def entity_name(i: int) -> str:
        return (f"{vocab[i % V]} {vocab[(i // V) % V]} "
                f"{vocab[(i // (V * V)) % V]}")

    # complementary placement: each entity's ONE weak view gets that view's
    # noise at 3x rate (same total noise mass, concentrated so the other two
    # views cover it — see module docstring)
    weak = [rng.randrange(3) for _ in range(n_entities)]   # 0=name 1=rel 2=attr

    def eff_noise(base: float, is_weak: bool) -> float:
        if not complementary:
            return base
        return min(1.0, 3.0 * base) if is_weak else 0.0

    # ---- relation view: one underlying edge set, KG2 a rewired copy -------
    base_edges = set()
    while len(base_edges) < n_rel_triples:
        h = rng.randrange(n_entities)
        t = rng.randrange(n_entities)
        if h == t:
            continue
        r = rng.randrange(n_relations)
        base_edges.add((h, r, t))
    # every entity must appear in >= 1 relation triple: the reference id
    # scheme assigns entity ids from the relation triples and asserts attr/
    # name rows resolve against them (data/ids.py; base/kg.py does the same)
    covered = set()
    for (h, r, t) in base_edges:
        covered.add(h)
        covered.add(t)
    for e in range(n_entities):
        if e not in covered:
            t = rng.randrange(n_entities)
            while t == e:
                t = rng.randrange(n_entities)
            base_edges.add((e, rng.randrange(n_relations), t))
    base_edges = sorted(base_edges)

    def write_rel(path: str, ents: List[str], rels: List[str], flip: bool):
        edges = []
        for (h, r, t) in base_edges:
            if flip and rng.random() < eff_noise(rel_noise, weak[h] == 1):
                t = rng.randrange(n_entities)  # perturb
                if t == h:
                    continue
            edges.append((h, r, t))
        # coverage must hold AFTER noise: rewiring can drop an entity's
        # only edge or redirect its only tail appearance, and the id scheme
        # requires every entity to appear in its KG's relation triples
        covered = set()
        for (h, _, t) in edges:
            covered.add(h)
            covered.add(t)
        for e in range(n_entities):
            if e not in covered:
                t = rng.randrange(n_entities)
                while t == e:
                    t = rng.randrange(n_entities)
                edges.append((e, rng.randrange(n_relations), t))
        with open(path, "w", encoding="utf8") as f:
            for (h, r, t) in edges:
                f.write(f"{ents[h]}\t{rels[r]}\t{ents[t]}\n")

    write_rel(os.path.join(folder, "rel_triples_1"), ents1, rels1, flip=False)
    write_rel(os.path.join(folder, "rel_triples_2"), ents2, rels2, flip=True)

    # ---- attribute view: SHARED base facts, noisy copies per KG -----------
    # Values are small word phrases, years, or datatype-suffixed numbers (the
    # latter two exercise the attribute cleaner + char-level fallback).
    def make_value() -> str:
        roll = rng.random()
        if roll < 0.1:
            return f"{rng.randrange(1900, 2030)}"
        if roll < 0.15:
            return f'"{rng.randrange(100)}"^^<http://www.w3.org/2001/XMLSchema#integer>'
        # 3-word phrases: ~V^3 distinct values, so a shared (attribute,
        # value) pair is near-unique evidence for an aligned entity pair
        # (2-word phrases at 5K entities collide ~7x each — measured to
        # cap av MRR at ~0.35, docs/EXPERIMENTS.md r4)
        w1 = vocab[rng.randrange(V)]
        w2 = vocab[rng.randrange(V)]
        w3 = vocab[rng.randrange(V)]
        return f"{w1} {w2} {w3}"

    base_facts = []                    # (entity, attr, value)
    n = 0
    while n < n_attr_triples:
        e = rng.randrange(n_entities)
        a = n % n_attributes           # round-robin => every attr is frequent
        base_facts.append((e, a, make_value()))
        n += 1

    def write_attr(path: str, ents: List[str], attrs: List[str],
                   noisy: bool):
        with open(path, "w", encoding="utf8") as f:
            for (e, a, v) in base_facts:
                if noisy and rng.random() < eff_noise(attr_noise,
                                                      weak[e] == 2):
                    if rng.random() < 0.5:
                        continue                      # dropped fact
                    v = make_value()                  # re-drawn value
                f.write(f"{ents[e]}\t{attrs[a]}\t{v}\n")

    write_attr(os.path.join(folder, "attr_triples_1"), ents1, attrs1,
               noisy=False)
    write_attr(os.path.join(folder, "attr_triples_2"), ents2, attrs2,
               noisy=True)

    # ---- name view: unique names; a name_noise fraction of KG2 entities
    # gets an unrelated name (offset far beyond any neighbor collision) -----
    with open(os.path.join(folder, "entity_local_name_1"), "w",
              encoding="utf8") as f:
        for i, e in enumerate(ents1):
            f.write(f"{e}\t{entity_name(i)}\n")
    with open(os.path.join(folder, "entity_local_name_2"), "w",
              encoding="utf8") as f:
        for i, e in enumerate(ents2):
            name = entity_name(i)
            if rng.random() < eff_noise(name_noise, weak[i] == 0):
                name = entity_name(i + 7 * n_entities + rng.randrange(
                    n_entities))
            f.write(f"{e}\t{name}\n")

    # Predicate local names: relation and attribute URIs in one file per KG
    # (predicate_alignment.py:138-141 splits them by the relation URI set).
    def write_pred(path: str, rels: List[str], attrs: List[str]):
        with open(path, "w", encoding="utf8") as f:
            for i, r in enumerate(rels):
                f.write(f"{r}\trelation {vocab[i % V]}\n")
            for i, a in enumerate(attrs):
                f.write(f"{a}\tattribute {vocab[i % V]}\n")

    write_pred(os.path.join(folder, "predicate_local_name_1"), rels1, attrs1)
    write_pred(os.path.join(folder, "predicate_local_name_2"), rels2, attrs2)

    # Links: identity alignment i <-> i, split 6/1/3 (dataset_division '631/').
    pairs = list(range(n_entities))
    rng.shuffle(pairs)
    n_train = int(link_fracs[0] * n_entities)
    n_valid = int(link_fracs[1] * n_entities)
    splits = {
        "train_links": pairs[:n_train],
        "valid_links": pairs[n_train:n_train + n_valid],
        "test_links": pairs[n_train + n_valid:],
    }
    for name, idxs in splits.items():
        with open(os.path.join(folder, division.strip("/"), name), "w",
                  encoding="utf8") as f:
            for i in idxs:
                f.write(f"{ents1[i]}\t{ents2[i]}\n")

    if write_word2vec:
        # Names may index up to 9*n_entities - 1 (noise replacements draw
        # entity_name(i + 7*n_entities + randrange(n_entities))), but those
        # still decompose into the same V words.
        vec_path = os.path.join(folder, "mini_word2vec.vec")
        nprng = np.random.RandomState(seed)
        vec_vocab = sorted(set(vocab) | {"relation", "attribute"})
        with open(vec_path, "w", encoding="utf8") as f:
            for w in vec_vocab:
                v = nprng.normal(size=300).astype(np.float32)
                f.write(w + " " + " ".join(f"{x:.4f}" for x in v) + "\n")
    if not folder.endswith("/"):
        folder = folder + "/"
    return folder
