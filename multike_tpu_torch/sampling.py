"""On-device negative sampling (counterpart of multike_tpu/sampling.py).

Only the uniform chunk-shared pools of the rel_view stream are ported so
far. The per-slot sampler with Bloom-filter rejection (``TripleFilter``), the
neighbor-truncated pools and ``NeighborState`` arrive with the truncated
phase.

Randomness comes from an explicit ``torch.Generator`` on the tensors'
device. It does not reproduce the JAX package's numbers, only its
distributions: the tests feed both sides the same injected pools.
"""
from __future__ import annotations

import torch


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
