"""Loss functions (counterpart of multike_tpu/losses.py).

All losses are sums over the batch like the reference; each takes an optional
``mask`` (1.0 real row / 0.0 padded row) so fixed-shape batches with tail
padding give the reference's variable-size batch sums. ``log(1 + exp(x))``
is ``softplus(x)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from multike_tpu_torch.kernels.chunk_loss import chunk_shared_loss
from multike_tpu_torch.kernels.per_slot_loss import per_slot_loss
from multike_tpu_torch.params import l2_normalize


def _sq_norm(x):
    return torch.sum(torch.square(x), dim=-1)


def transe_score(h, r, t):
    """-||h + r - t||^2"""
    return -_sq_norm(h + r - t)


def relation_logistic_loss(phs, prs, pts, nhs, nrs, nts,
                           pos_mask=None, neg_mask=None):
    """sum softplus(-pos_score) + sum softplus(neg_score)."""
    pos = F.softplus(-transe_score(phs, prs, pts))
    neg = F.softplus(transe_score(nhs, nrs, nts))
    if pos_mask is not None:
        pos = pos * pos_mask
    if neg_mask is not None:
        neg = neg * neg_mask
    return torch.sum(pos) + torch.sum(neg)


def relation_logistic_loss_wo_negs(phs, prs, pts, mask=None):
    pos = F.softplus(-transe_score(phs, prs, pts))
    if mask is not None:
        pos = pos * mask
    return torch.sum(pos)


def logistic_loss_wo_negs(phs, pas, pvs, pws, mask=None):
    """Weighted positives-only logistic loss."""
    pos = F.softplus(-transe_score(phs, pas, pvs)) * pws
    if mask is not None:
        pos = pos * mask
    return torch.sum(pos)


def positive_logistic_from_scores(scores, weights=None, mask=None):
    """sum w * softplus(-score), used with the conv scorer."""
    pos = F.softplus(-scores)
    if weights is not None:
        pos = pos * weights
    if mask is not None:
        pos = pos * mask
    return torch.sum(pos)


def lean_relation_logistic_loss(phs, prs, pts, cand_rows, corrupt_head,
                                pos_mask=None, neg_keep=None):
    """TransE logistic loss with per-slot negatives in the lean layout:
    negatives reuse the positive rows for the uncorrupted side.
    ``phs/prs/pts`` (B, D) normalized rows; ``cand_rows`` (B, K, D)
    normalized candidate rows; ``corrupt_head`` (B, K) bool; ``neg_keep``
    (B, K) optional 0/1 slot mask. Each slot's distance is computed
    directly:
      corrupt head:  -||c + r - t||^2
      corrupt tail:  -||h + r - c||^2

    The loss and its gradients are computed together, by the kernel K5 on
    the card and in closed form on the CPU (kernels/per_slot_loss.py), all
    in float32."""
    return per_slot_loss(phs, prs, pts, cand_rows, corrupt_head,
                         pos_mask=pos_mask, neg_keep=neg_keep)


def chunk_shared_relation_logistic_loss(phs, prs, pts, cand_h, cand_t,
                                        neg_weight=1.0, pos_mask=None,
                                        keep_h=None, keep_t=None):
    """TransE logistic loss with chunk-shared negatives.

    ``phs/prs/pts`` (NC, S, D) normalized positive rows, chunked;
    ``cand_h/cand_t`` (NC, C, D) normalized shared head- and tail-corruption
    candidate rows. Every positive scores against all C candidates of each
    pool, each pair weighted ``neg_weight`` (K / (2C) reproduces the
    reference's K per-slot draws in expectation):
      corrupt head:  -||c + r - t||^2
      corrupt tail:  -||h + r - c||^2
    ``keep_h``/``keep_t`` (NC, S, C), optional: 0 drops a pair.

    The loss and its gradients are computed together, by the kernel K3 on
    the card and in closed form on the CPU (kernels/chunk_loss.py), all in
    float32."""
    return chunk_shared_loss(phs, prs, pts, cand_h, cand_t,
                             neg_weight=neg_weight, pos_mask=pos_mask,
                             keep_h=keep_h, keep_t=keep_t)


def alignment_loss(ents1, ents2, mask=None):
    """sum ||e1 - e2||^2"""
    d = _sq_norm(ents1 - ents2)
    if mask is not None:
        d = d * mask
    return torch.sum(d)


def orthogonal_loss(mapping, eye):
    """sum (M M^T - I)^2"""
    return torch.sum(torch.square(mapping @ mapping.T - eye))


def space_mapping_loss(view_embeds, shared_embeds, mapping, eye,
                       orthogonal_weight, norm_w=0.0001, mask=None,
                       batch_sum=None, regularize: bool = True):
    """The mapped view embeddings are normalized by the l2 norm of the WHOLE
    batch tensor (the reference's axis-less tf.nn.l2_normalize).

    With the batch split over ranks: ``batch_sum`` sums the norm over them
    (``params.l2_normalize``), and the batch-independent orthogonal and norm
    terms are counted on one rank only (``regularize`` False elsewhere)."""
    mapped = view_embeds @ mapping
    if mask is not None:
        mapped = mapped * mask[:, None]  # keep padded rows out of the norm
    mapped = l2_normalize(mapped, axis=None, batch_sum=batch_sum)
    d = _sq_norm(shared_embeds - mapped)
    if mask is not None:
        d = d * mask
    map_loss = torch.sum(d)
    if not regularize:
        return map_loss
    norm_loss = torch.sum(torch.square(mapping))
    return map_loss + orthogonal_weight * orthogonal_loss(mapping, eye) + \
        norm_w * norm_loss
