"""Operations and bytes the algorithms need, from the shapes of what ran.

They count the work as the algorithm needs it, not as the port happens to
compute it: a faster program lowers the time, never the count.

Relation-view step (TransE with a logistic loss; ``d`` the embedding
width). Forward, per ``d``:

  * ``TRANSE``: one distance ``||h + r - t||^2`` of a triple that shares
    nothing: add, subtract, square, sum;
  * ``SHARED``: one (positive, pool member) pair of the chunk-shared
    scheme, where every positive meets the same 2C pool rows: its cross
    term, a dot product (the squared norms are per row, counted there);
  * ``NORM``: the l2 normalization of one gathered row: square, sum,
    scale, plus each pool row's squared norm (``SHARED`` again);

the backward pass takes ``BACKWARD`` times the forward's FLOPs, and the
Adagrad update ``ADAGRAD`` FLOPs per element of each UNIQUE touched row
(square, add, add eps, rsqrt, scale, subtract).

K1, the row-sparse Adagrad apply: ``N (8 + 4d) + 16 U d`` bytes (the int64
ids and the gradient rows read once, each unique row of the parameter and
the accumulator read and written once; chip_smoke.py ``k1_bound_ms``).
K2, the rank count: ``2 n1 n2 d`` operations (the similarity products;
chip_smoke.py phase 3).
"""
from __future__ import annotations

TRANSE = 4
SHARED = 2
NORM = 3
BACKWARD = 2
ADAGRAD = 6


def chunk_step_flops(d: int, positives: int, chunks: int, pool: int,
                     unique_rows: int) -> int:
    """One chunk-shared step: ``positives`` real positives (both KGs), in
    ``chunks`` chunks (both KGs), each with a head and a tail pool of
    ``pool`` rows; ``unique_rows`` the distinct entity and relation rows the
    step updates."""
    pool_rows = 2 * pool * chunks
    gathered = 3 * positives + pool_rows          # h, t, r and the pools
    fwd = d * (TRANSE * positives + SHARED * positives * 2 * pool
               + NORM * gathered + SHARED * pool_rows)
    return fwd * (1 + BACKWARD) + ADAGRAD * d * unique_rows


def per_slot_step_flops(d: int, positives: int, negatives: int,
                        unique_rows: int) -> int:
    """One per-slot step: ``positives`` real positives (both KGs), each
    with ``negatives`` slots of its own candidate."""
    slots = positives * negatives
    gathered = 3 * positives + slots               # h, t, r and candidates
    fwd = d * (TRANSE * (positives + slots) + NORM * gathered)
    return fwd * (1 + BACKWARD) + ADAGRAD * d * unique_rows


def k1_bytes(n: int, unique: int, d: int) -> int:
    """K1's bytes: ``n`` ids (occurrences), ``unique`` distinct rows."""
    return n * (8 + 4 * d) + 16 * unique * d


def k2_ops(n1: int, n2: int, d: int) -> int:
    return 2 * n1 * n2 * d
