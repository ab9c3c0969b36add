"""Inputs and weights made from the run's ``--seed``; the same seed gives the
same inputs. Every stream of randomness has its own seed derived from the
run's, so a seed of any size (numpy's SeedSequence takes it whole) feeds
each generator one 64-bit word.
"""
from __future__ import annotations

import numpy as np
import torch


def derived_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for generator ``stream`` of run ``seed``."""
    word = np.random.SeedSequence([int(seed), stream]).generate_state(
        1, np.uint64)[0]
    return int(word) >> 1


TRIPLES, TABLES, NEIGHBORS, SAMPLING = 1, 2, 3, 4


def uniform_triples(rng: np.random.Generator, n_triples: int, ent_lo: int,
                    ent_hi: int, n_rel: int, rel_lo: int) -> np.ndarray:
    """Random relation triples, heads, relations and tails each uniform: a
    copy of bench.py's ``synthetic_triples`` (bench.py:148-153, also
    chip_smoke.py ``bench_triples``), drawn by numpy's Generator so that any
    seed is taken whole."""
    h = rng.integers(ent_lo, ent_hi, size=n_triples)
    t = rng.integers(ent_lo, ent_hi, size=n_triples)
    r = rng.integers(rel_lo, rel_lo + n_rel, size=n_triples)
    return np.stack([h, r, t], axis=1).astype(np.int64)


def kg_pair_triples(seed: int, entities: int, triples, relations):
    """Both KGs' triples: KG1's entities are [0, n), KG2's [n, 2n); KG1's
    relations [0, r1), KG2's [r1, r1 + r2)."""
    rng = np.random.default_rng(derived_seed(seed, TRIPLES))
    tr1 = uniform_triples(rng, triples[0], 0, entities, relations[0], 0)
    tr2 = uniform_triples(rng, triples[1], entities, 2 * entities,
                          relations[1], relations[0])
    return tr1, tr2


def xavier_normal(gen: torch.Generator, rows: int, dim: int,
                  device) -> torch.Tensor:
    """The reference's initializer (TF1 ``xavier_initializer(uniform=
    False)``): a normal truncated at 2 standard deviations, stddev
    sqrt(2 / (rows + dim)), made on ``device`` in one call."""
    t = torch.empty((rows, dim), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(float(np.sqrt(2.0 / (rows + dim))))


def relation_view_tables(seed: int, entities: int, relations: int, dim: int,
                         device):
    """The entity and relation tables of the relation view, float32, on the
    device."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derived_seed(seed, TABLES))
    return (xavier_normal(gen, entities, dim, device),
            xavier_normal(gen, relations, dim, device))


def neighbor_parts(seed: int, ranges, useful_share: float, k: int, device):
    """A DWY100K-shaped truncated-sampling table (bench.py:218-227,
    chip_smoke.py ``dwy100k_neighbors``): per KG, ``useful_share`` of its
    entities have a row of ``k`` ids drawn uniformly from the KG. Returns
    [(useful ids (U,) int64, rows (U, k) int32)] on the device."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derived_seed(seed, NEIGHBORS))
    parts = []
    for lo, hi in ranges:
        n = hi - lo
        useful = lo + torch.randperm(n, generator=gen, device=device)[
            :int(n * useful_share)]
        rows = lo + torch.randint(0, n, (useful.shape[0], k), generator=gen,
                                  device=device, dtype=torch.int32)
        parts.append((useful, rows))
    return parts
