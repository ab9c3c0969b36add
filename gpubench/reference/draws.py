"""Plain checks of a relation-view step's inputs, as the sampling stage
drew them: the positives are true triples of their KG, each candidate lies
where its scheme draws it, and a per-slot keep flag is 0 exactly where the
Bloom filter of the true triples holds the slot's negative.

The Bloom filter is the configuration's own ("drop" rejection: the slots
whose negative the filter holds leave the loss), so its false positives
are part of the result. Its hash is a copy of the one in MultiKE's TPU and
GPU packages (``sampling.py``: a blocked filter of 2**25 bits in uint32
words, both bits of a triple in one word), computed here in numpy's
wrapping uint64 arithmetic.
"""
from __future__ import annotations

import numpy as np
import torch

BLOOM_LOG2M = 25
_H1, _H2, _HA, _HB, _HC = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE35, 0x27D4EB2F,
                           0x165667B1)
_M32 = np.uint64(0xFFFFFFFF)


def _mul(x, c):
    return (x * np.uint64(c)) & _M32


def _word_bits(h, r, t, log2m):
    h, r, t = (np.asarray(v).astype(np.uint64) for v in (h, r, t))
    x = _mul(h, _H1) ^ _mul(r, _H2) ^ _mul(t, _HA)
    word = _mul(x, _H1) >> np.uint64(32 - (log2m - 5))
    b1 = ((_mul(x, _HB) + np.uint64(_HC)) & _M32) >> np.uint64(27)
    b2 = ((_mul(x, _HA) + np.uint64(_HB)) & _M32) >> np.uint64(27)
    return word, b1, b2


class Bloom:
    def __init__(self, triples: np.ndarray, log2m: int = BLOOM_LOG2M):
        self.log2m = log2m
        self.words = np.zeros((1 << log2m) // 32, np.uint64)
        word, b1, b2 = _word_bits(triples[:, 0], triples[:, 1],
                                  triples[:, 2], log2m)
        np.bitwise_or.at(self.words, word.astype(np.int64),
                         (np.uint64(1) << b1) | (np.uint64(1) << b2))

    def holds(self, h, r, t) -> np.ndarray:
        word, b1, b2 = _word_bits(h, r, t, self.log2m)
        mask = (np.uint64(1) << b1) | (np.uint64(1) << b2)
        return (self.words[word.astype(np.int64)] & mask) == mask


class TrueTriples:
    """Membership in a set of triples, by sorted int64 keys."""

    def __init__(self, triples: np.ndarray, entities: int, relations: int):
        self.e, self.r = entities, relations
        self.keys = np.sort(self._key(triples[:, 0], triples[:, 1],
                                      triples[:, 2]))

    def _key(self, h, r, t):
        return (np.asarray(h, np.int64) * self.r + r) * self.e + t

    def holds(self, h, r, t) -> np.ndarray:
        k = self._key(h, r, t)
        i = np.clip(np.searchsorted(self.keys, k), 0, len(self.keys) - 1)
        return self.keys[i] == k


def out_of_range(ids: torch.Tensor, lo: int, hi: int) -> int:
    return int(((ids < lo) | (ids >= hi)).sum())


def not_from_rows(cand: torch.Tensor, target: torch.Tensor, parts, lo: int,
                  hi: int, block: int = 4096) -> int:
    """How many per-slot candidates (flat) lie outside the neighbor row of
    the entity they corrupt (``target``), or outside [lo, hi) where that
    entity has no row. ``parts``: [(useful ids, rows)] of the truncated
    sampling table, as the benchmark made it."""
    dev = cand.device
    where = torch.full((hi,), -1, dtype=torch.long, device=dev)
    rows = None
    for useful, r in parts:
        if int(useful.min()) >= lo and int(useful.max()) < hi:
            where[useful.long()] = torch.arange(useful.shape[0], device=dev)
            rows = r
    bad = 0
    for s in range(0, cand.shape[0], block):
        c, tg = cand[s:s + block], target[s:s + block].long()
        row = where[tg]
        has = row >= 0
        bad += out_of_range(c[~has], lo, hi)
        if rows is not None and bool(has.any()):
            hit = (rows[row[has]].long() == c[has][:, None]).any(dim=1)
            bad += int((~hit).sum())
    return bad
