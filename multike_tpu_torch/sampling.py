"""On-device negative sampling (counterpart of multike_tpu/sampling.py).

Two families, as in the JAX package:

  * chunk-shared candidate pools of the rel_view stream, uniform (before
    the first neighbor refresh) or neighbor-truncated (after it), drawn
    from the ``NeighborState`` table;
  * per-slot draws, the reference's own regime: each negative slot flips
    its own head-or-tail coin and draws its own candidate
    (:func:`sample_corruptions`, :func:`sample_negatives`,
    :func:`sample_neg_heads`), optionally rejecting true triples through a
    blocked Bloom filter over the true-triple set (:class:`TripleFilter`).

Randomness comes from an explicit ``torch.Generator`` on the tensors'
device. It does not reproduce the JAX package's numbers, only its
distributions: the tests feed both sides the same injected candidates. The
Bloom filter's words and membership tests, which involve no randomness, are
bit-equal to the JAX package's.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from multike_tpu_torch.utils.profiling import span


class NeighborState(NamedTuple):
    """Truncated-sampling candidates: ``nbr[e, :cnt[e]]`` holds entity e's
    neighbor ids; ``cnt[e] == 0`` means e has no list (its draws fall back
    to uniform). ``cnt`` lets the two KGs' top-k sizes share one table."""
    nbr: torch.Tensor  # (E, kmax) int32
    has: torch.Tensor  # (E,) bool, == cnt > 0
    cnt: torch.Tensor  # (E,) int32


def empty_neighbor_state(entities_num: int, k: int = 8,
                         device=None) -> NeighborState:
    # the JAX package floors the table at 8 columns; kept for equal shapes
    return NeighborState(
        nbr=torch.zeros((entities_num, max(k, 8)), dtype=torch.int32,
                        device=device),
        has=torch.zeros((entities_num,), dtype=torch.bool, device=device),
        cnt=torch.zeros((entities_num,), dtype=torch.int32, device=device))


def build_neighbor_state(entities_num: int, parts,
                         device=None) -> NeighborState:
    """One dense table from per-KG refresh results. ``parts``: iterable of
    (useful_entities (U,), neighbor_ids (U, K)), ids global."""
    parts = [(torch.as_tensor(u, dtype=torch.long, device=device),
              torch.as_tensor(n, dtype=torch.int32, device=device))
             for u, n in parts]
    state = empty_neighbor_state(entities_num,
                                 max(n.shape[1] for _, n in parts), device)
    for useful, ids in parts:
        k = ids.shape[1]
        state.nbr[useful, :k] = ids
        state.has[useful] = True
        state.cnt[useful] = k
    return state


# ---------------------------------------------------------------------------
# Bloom filter over the true-triple set
# ---------------------------------------------------------------------------

class TripleFilter(NamedTuple):
    """Blocked Bloom filter over the true triples: both hash bits of a
    triple land in ONE 32-bit word, so a membership test is one word
    gather. A positive test means 'possibly a true triple', a negative one
    'certainly not'. ``bits`` holds the uint32 words' bit patterns as int32
    (``bits.cpu().numpy().view(np.uint32)`` gives the words); ``log2m`` is
    the filter's size in bits, as a power of 2."""
    bits: torch.Tensor  # (2**log2m / 32,) int32
    log2m: int


_H1, _H2, _HA, _HB, _HC = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE35, 0x27D4EB2F,
                           0x165667B1)
_MASK32 = 0xFFFFFFFF


def _hash_word_bits_np(h, r, t, log2m):
    """(word index, bit1, bit2) of each triple, uint32 numpy arithmetic
    (which wraps); both bits within the same word."""
    h = np.asarray(h).astype(np.uint32)
    r = np.asarray(r).astype(np.uint32)
    t = np.asarray(t).astype(np.uint32)
    h1, h2, ha, hb, hc = (np.uint32(c) for c in (_H1, _H2, _HA, _HB, _HC))
    x = (h * h1) ^ (r * h2) ^ (t * ha)
    word = (x * h1) >> np.uint32(32 - (log2m - 5))
    b1 = (x * hb + hc) >> np.uint32(27)
    b2 = (x * ha + hb) >> np.uint32(27)
    return word, b1, b2


def build_triple_filter(triples: np.ndarray, log2m: int = 25,
                        device=None) -> TripleFilter:
    """The filter of ``triples`` ((n, 3) int array), built on the host and
    uploaded to ``device``. m = 2**log2m bits (4 MB at 25)."""
    with span("setup.triple_filter"):
        bits = np.zeros((1 << log2m) // 32, np.uint32)
        if len(triples):
            triples = np.asarray(triples)
            word, b1, b2 = _hash_word_bits_np(triples[:, 0], triples[:, 1],
                                              triples[:, 2], log2m)
            mask = (np.uint32(1) << b1) | (np.uint32(1) << b2)
            np.bitwise_or.at(bits, word, mask)
        return TripleFilter(bits=torch.as_tensor(bits.view(np.int32),
                                                 device=device),
                            log2m=log2m)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32) and a 32-bit
    constant, in int64 without overflow: the constant is split in 16-bit
    halves, so no product exceeds 2**48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def triple_filter_contains(tfilter: TripleFilter, h, r, t) -> torch.Tensor:
    """Membership test, broadcasting over any shapes: True where (h, r, t)
    is possibly a true triple, False where it certainly is not. The uint32
    hash of the JAX package is computed in int64, masked to 32 bits after
    every multiply and add."""
    h, r, t = (torch.as_tensor(v, device=tfilter.bits.device).long() & _MASK32
               for v in (h, r, t))
    x = _mul32(h, _H1) ^ _mul32(r, _H2) ^ _mul32(t, _HA)
    word_idx = _mul32(x, _H1) >> (32 - (tfilter.log2m - 5))
    b1 = ((_mul32(x, _HB) + _HC) & _MASK32) >> 27
    b2 = ((_mul32(x, _HA) + _HB) & _MASK32) >> 27
    word = tfilter.bits[word_idx].long() & _MASK32        # ONE gather
    mask = (1 << b1) | (1 << b2)
    return (word & mask) == mask


# ---------------------------------------------------------------------------
# Chunk-shared pools
# ---------------------------------------------------------------------------

def _randbits(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Uniform int64 draws in [0, 2**30): the JAX package draws
    ``lo + randint(0, 2**30) % span`` for every uniform candidate."""
    return torch.randint(0, 1 << 30, shape, generator=gen, device=device)


def sample_shared_corruptions(gen: torch.Generator, num_chunks: int,
                              neg_num: int, lo: int, hi: int):
    """Chunk-shared candidate pools: each chunk of positives shares
    ``neg_num`` head-corruption and ``neg_num`` tail-corruption candidates,
    uniform over the owning KG's entity id range [lo, hi). Returns
    ``(cand_h, cand_t)``, each (num_chunks, neg_num) int64 on ``gen``'s
    device."""
    shape = (num_chunks, neg_num)
    ch = torch.randint(lo, hi, shape, generator=gen, device=gen.device)
    ct = torch.randint(lo, hi, shape, generator=gen, device=gen.device)
    return ch, ct


def sample_shared_neighbor_corruptions(gen: torch.Generator,
                                       pos: torch.Tensor, num_chunks: int,
                                       chunk_rows: int, neg_num: int,
                                       lo: int, hi: int,
                                       neighbors: NeighborState,
                                       mask: torch.Tensor | None = None):
    """Neighbor-restricted chunk-shared pools (the truncated phase).

    Pool slot j of chunk c picks a uniform DONOR positive u of the chunk and
    draws from the neighbor row of the entity it would replace (``nbr[h_u]``
    for the head pool, ``nbr[t_u]`` for the tail pool), or uniformly from
    [lo, hi) when that entity has no row.

    ``pos``: (num_chunks * chunk_rows, 3) chunk-padded positives.
    ``mask``: optional (num_chunks * chunk_rows,) validity mask. Padding
    must form a contiguous SUFFIX of each chunk (``streams.
    _padded_epoch_indices`` guarantees it): donors are drawn from the first
    ``real_rows`` slots of each chunk. Returns ``(cand_h, cand_t)``, each
    (num_chunks, neg_num) int64."""
    dev = pos.device
    h = pos[:, 0].reshape(num_chunks, chunk_rows)
    t = pos[:, 2].reshape(num_chunks, chunk_rows)
    if mask is not None:
        real_rows = torch.clamp_min(
            (mask.reshape(num_chunks, chunk_rows) != 0).sum(dim=1), 1)
    else:
        real_rows = torch.full((num_chunks,), chunk_rows, device=dev)
    shape = (num_chunks, neg_num)
    uni = torch.randint(lo, hi, (2,) + shape, generator=gen, device=dev)

    def pool(ents, uniform):
        donor = _randbits(gen, shape, dev) % real_rows[:, None]
        target = torch.gather(ents, 1, donor).long()
        cnts = neighbors.cnt[target]
        col = _randbits(gen, shape, dev) % torch.clamp_min(cnts, 1)
        return torch.where(cnts > 0, neighbors.nbr[target, col].long(),
                           uniform)

    return pool(h, uni[0]), pool(t, uni[1])


# ---------------------------------------------------------------------------
# Per-slot draws
# ---------------------------------------------------------------------------

def _per_row(v, n: int, device) -> torch.Tensor:
    """A scalar or (n,) id bound as an (n,) int64 tensor."""
    return torch.as_tensor(v, device=device).long().expand(n)


def _draw(gen, h, t, lo, hi, corrupt_head, neighbors, counts):
    """One candidate for every slot of ``corrupt_head`` (B, K): uniform in
    the row's [lo, hi), or from the neighbor row of the entity the slot
    corrupts when that entity has one. ``counts``: the (B, 1) neighbor
    counts of the heads and of the tails, gathered once per positive."""
    dev = corrupt_head.device
    shape = corrupt_head.shape
    uniform = lo[:, None] + _randbits(gen, shape, dev) % (hi - lo)[:, None]
    if neighbors is None:
        return uniform
    target = torch.where(corrupt_head, h[:, None], t[:, None]).long()
    cnts = torch.where(corrupt_head, *counts)
    col = _randbits(gen, shape, dev) % torch.clamp_min(cnts, 1)
    return torch.where(cnts > 0, neighbors.nbr[target, col].long(), uniform)


def _slot_hits(tfilter, cand, corrupt_head, h, r, t):
    """Bloom test of every slot's assembled negative."""
    with span("draw.bloom"):
        neg_h = torch.where(corrupt_head, cand, h[:, None])
        neg_t = torch.where(corrupt_head, t[:, None], cand)
        return triple_filter_contains(tfilter, neg_h, r[:, None], neg_t)


def _coins_and_draw(gen, pos, lo, hi, neg_num, neighbors):
    """(draw, corrupt_head, first candidates): the side coins of every slot
    (Bernoulli(0.5), True = corrupt the head) and a ``draw()`` that redraws
    every slot's candidate for those coins."""
    dev = pos.device
    B = pos.shape[0]
    h, t = pos[:, 0], pos[:, 2]
    lo, hi = _per_row(lo, B, dev), _per_row(hi, B, dev)
    counts = None if neighbors is None else (neighbors.cnt[h][:, None],
                                             neighbors.cnt[t][:, None])
    corrupt_head = torch.rand((B, neg_num), generator=gen, device=dev) < 0.5

    def draw():
        return _draw(gen, h, t, lo, hi, corrupt_head, neighbors, counts)

    return draw, corrupt_head, draw()


def sample_corruptions(gen: torch.Generator, pos: torch.Tensor, lo, hi,
                       neg_num: int,
                       neighbors: Optional[NeighborState] = None,
                       tfilter: Optional[TripleFilter] = None,
                       retries: int = 0, reject_mode: str = "resample"):
    """Per-slot corruption draws in structured form: ``(cand (B, K) int64,
    corrupt_head (B, K) bool, keep)`` for ``pos`` (B, 3). Slot (b, k)
    corrupts the head with probability 0.5, else the tail; its candidate is
    ``lo + u % (hi - lo)`` with u uniform in [0, 2**30), or, when the
    corrupted entity has a neighbor row, a uniform column of that row.
    ``lo``/``hi`` are scalars or (B,) tensors.

    True-triple rejection (``tfilter`` set) has two modes:

      * ``"resample"``: redraw the slots that test positive, up to
        ``retries`` rounds, stopping early after a round that finds none;
        ``keep`` is None. Each round reads one flag back to the host (a
        device sync) to decide whether to stop;
      * ``"drop"``: one Bloom pass; ``keep[b, k]`` is 0.0 where the slot
        tests positive, else 1.0, and the loss drops those slots.

    Without a filter (or with ``retries == 0`` in resample mode), ``keep``
    is None."""
    if reject_mode not in ("drop", "resample"):
        raise ValueError(f"reject_mode must be 'drop' or 'resample', "
                         f"got {reject_mode!r}")
    h, r, t = pos[:, 0], pos[:, 1], pos[:, 2]
    draw, corrupt_head, cand = _coins_and_draw(gen, pos, lo, hi, neg_num,
                                               neighbors)
    keep = None
    if tfilter is not None and reject_mode == "drop":
        hits = _slot_hits(tfilter, cand, corrupt_head, h, r, t)
        keep = 1.0 - hits.to(torch.float32)
    elif tfilter is not None:
        for _ in range(retries):
            hits = _slot_hits(tfilter, cand, corrupt_head, h, r, t)
            if not bool(hits.any()):              # host sync per round
                break
            cand = torch.where(hits, draw(), cand)
    return cand, corrupt_head, keep


def sample_negatives(gen: torch.Generator, pos: torch.Tensor, lo, hi,
                     neg_num: int,
                     neighbors: Optional[NeighborState] = None,
                     tfilter: Optional[TripleFilter] = None,
                     retries: int = 0) -> torch.Tensor:
    """Assembled per-slot negatives: (B * neg_num, 3) int64 in the
    reference's layout, the ``neg_num`` corruptions of positive i in rows
    [i * neg_num, (i + 1) * neg_num). With ``tfilter`` and ``retries`` > 0
    the candidates that test positive are redrawn ``retries`` times (a
    fixed count, no early exit); a candidate still positive after the last
    round is kept, as the reference keeps one after its 10 tries."""
    h, r, t = pos[:, 0], pos[:, 1], pos[:, 2]
    draw, corrupt_head, cand = _coins_and_draw(gen, pos, lo, hi, neg_num,
                                               neighbors)
    if tfilter is not None:
        for _ in range(retries):
            hits = _slot_hits(tfilter, cand, corrupt_head, h, r, t)
            cand = torch.where(hits, draw(), cand)
    neg_h = torch.where(corrupt_head, cand, h[:, None])
    neg_t = torch.where(corrupt_head, t[:, None], cand)
    rel = r[:, None].expand_as(cand)
    return torch.stack([neg_h, rel, neg_t], dim=-1).reshape(-1, 3).long()


def sample_neg_heads(gen: torch.Generator, pos_h: torch.Tensor, lo, hi,
                     neg_num: int,
                     neighbors: Optional[NeighborState] = None):
    """Attribute-style corruption, head only: (B * neg_num,) int64
    candidates for the heads ``pos_h`` (B,), each positive's ``neg_num``
    in consecutive slots."""
    dev = pos_h.device
    h = pos_h.long().repeat_interleave(neg_num)
    n = h.shape[0]
    lo = _per_row(lo, pos_h.shape[0], dev).repeat_interleave(neg_num)
    hi = _per_row(hi, pos_h.shape[0], dev).repeat_interleave(neg_num)
    uniform = lo + _randbits(gen, (n,), dev) % (hi - lo)
    if neighbors is None:
        return uniform
    cnts = neighbors.cnt[h]
    col = _randbits(gen, (n,), dev) % torch.clamp_min(cnts, 1)
    return torch.where(cnts > 0, neighbors.nbr[h, col].long(), uniform)
