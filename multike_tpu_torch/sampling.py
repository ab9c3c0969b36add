"""On-device negative sampling (counterpart of multike_tpu/sampling.py).

Ported: the chunk-shared candidate pools of the rel_view stream, uniform
(before the first neighbor refresh) and neighbor-truncated (after it), and
the ``NeighborState`` table they draw from. The per-slot sampler with
Bloom-filter rejection (``TripleFilter``) is not ported yet.

Randomness comes from an explicit ``torch.Generator`` on the tensors'
device. It does not reproduce the JAX package's numbers, only its
distributions: the tests feed both sides the same injected pools.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


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
        donor = torch.randint(0, 1 << 30, shape, generator=gen,
                              device=dev) % real_rows[:, None]
        target = torch.gather(ents, 1, donor).long()
        cnts = neighbors.cnt[target]
        col = torch.randint(0, 1 << 30, shape, generator=gen,
                            device=dev) % torch.clamp_min(cnts, 1)
        return torch.where(cnts > 0, neighbors.nbr[target, col].long(),
                           uniform)

    return pool(h, uni[0]), pool(t, uni[1])
