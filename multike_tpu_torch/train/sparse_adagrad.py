"""Row-sparse Adagrad (counterpart of multike_tpu/train/sparse_adagrad.py).

The reference's TF1 sparse Adagrad touches only the rows a step gathered.
Dense Adagrad over a whole (E, d) table is the same math (zero-gradient
rows keep their accumulators) but moves O(E * d) bytes per step; this
module applies the identical update to the touched rows only, through
K1 (kernels/apply_kernel.py ``row_adagrad``: the CUDA kernel on the card,
its plain version on the CPU), which sums duplicate occurrences'
gradients (dense Adagrad squares the SUM) and applies

    acc_row += gsum^2
    param_row -= lr * gsum * where(acc_row > 0, rsqrt(acc_row + eps), 0)

which is optax.adagrad's ``scale_by_rss`` + ``scale(-lr)``, not
``torch.optim.Adagrad`` (that one divides by ``sqrt(acc) + 1e-10``).

The JAX package sorts the ids and segment-sums before its TPU kernel,
because TPU scatters serialize; on the card K1 deduplicates without a sort
(csrc/apply_kernel.cu). On the CPU the plain version still sorts
(``apply_kernel.row_adagrad_plain``).

Unlike the JAX package, which returns new arrays (in place only through
buffer donation), every function here updates ``param`` and ``acc`` IN
PLACE and returns them.
"""
from __future__ import annotations

import torch

from multike_tpu_torch.kernels.apply_kernel import row_adagrad

ADAGRAD_EPS = 1e-7            # optax.adagrad default
ADAGRAD_ACC0 = 0.1            # reference initial_accumulator_value


def init_acc(param, a0: float = ADAGRAD_ACC0):
    """Adagrad accumulators matching ``param`` (a tensor or nested dict)."""
    if isinstance(param, dict):
        return {k: init_acc(v, a0) for k, v in param.items()}
    return torch.full_like(param, a0)


def row_apply(param: torch.Tensor, acc: torch.Tensor, ids: torch.Tensor,
              g_rows: torch.Tensor, lr: float, eps: float = ADAGRAD_EPS,
              row_offset: int = 0):
    """One Adagrad step on ``param`` touching only ``ids``' rows, in place.

    ``g_rows`` (N, d): per-OCCURRENCE gradients of the gathered rows
    ``param[ids]``. Row-sharded tables: ``param`` holds the global rows
    ``[row_offset, row_offset + rows)``, ``ids`` stay global and ids outside
    the shard do nothing. Returns ``(param, acc)``."""
    return row_adagrad(param, acc, ids, g_rows, lr, eps, row_offset)


def dense_apply(param, acc, grads, lr: float, eps: float = ADAGRAD_EPS):
    """Dense Adagrad, in place, over a tensor or nested dict of tensors
    (relation/attribute tables, conv scorers, mappings)."""
    if isinstance(param, dict):
        for k in param:
            dense_apply(param[k], acc[k], grads[k], lr, eps)
        return param, acc
    acc.add_(torch.square(grads))
    param.sub_(lr * torch.where(acc > 0, torch.rsqrt(acc + eps), 0.0) * grads)
    return param, acc
