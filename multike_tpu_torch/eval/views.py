"""Per-view evaluation (counterpart of multike_tpu/eval/views.py).

``valid_metrics`` / ``valid`` / ``test`` rank one choice of embeddings:
``embed_choice`` in {nv, rv, av, final}, or 'avg', the w-weighted sum of
the nv, rv and av views. ``valid_WVA`` / ``test_WVA`` rank the weighted
view average (WVA): a view's weight is the mean diagonal cosine between
its embeddings and the mean of the three views, summed over both sides and
normalized. (The reference's ``wva`` returns before its own normalization
block; the live math is the one reproduced here, as in the JAX package.)
The embeddings stay on the trainer's device: only the (n1,) rank vectors
and the six view weights reach the host; on a mesh the ring takes host
copies (eval/ring.py).
"""
from __future__ import annotations

from typing import Tuple

import torch

from multike_tpu_torch.eval import evaluation as eva


def _choose_embeds(trainer, embed_choice: str, w=(1, 1, 1)):
    get = trainer.current_embeds_device
    if embed_choice in ("nv", "rv", "av", "final"):
        return get(embed_choice)
    if embed_choice == "avg":
        return w[0] * get("nv") + w[1] * get("rv") + w[2] * get("av")
    raise KeyError(embed_choice)


def _engine_kw(trainer):
    """Engine settings from the Config, and the trainer's mesh, which routes
    every ranking through the ring (eval/ring.py)."""
    cfg = trainer.cfg
    return dict(
        mesh=getattr(trainer, "pctx", None),
        matmul_dtype=(torch.bfloat16 if cfg.eval_matmul_dtype == "bfloat16"
                      else torch.float32),
        row_block=cfg.eval_row_block if cfg.eval_row_block > 0 else None,
        col_block=cfg.eval_col_block,
    )


def _rows(embeds, ids):
    return embeds[torch.as_tensor(ids, dtype=torch.long, device=embeds.device)]


def valid_metrics(trainer, embed_choice: str = "avg",
                  w=(1, 1, 1)) -> Tuple[float, float]:
    """(hits@1, mrr) on the validation split, ranked against the valid and
    test entities of KG2."""
    ent_embeds = _choose_embeds(trainer, embed_choice, w)
    kgs = trainer.kgs
    if trainer.verbose:
        print(embed_choice, "valid results:")
    return eva.valid(_rows(ent_embeds, kgs.valid_entities1),
                     _rows(ent_embeds, kgs.valid_entities2 + kgs.test_entities2),
                     None, trainer.cfg.top_k, trainer.cfg.test_threads_num,
                     normalize=True, **_engine_kw(trainer))


def valid(trainer, embed_choice: str = "avg", w=(1, 1, 1)) -> float:
    return valid_metrics(trainer, embed_choice, w)[1]


def test(trainer, embed_choice: str = "avg", w=(1, 1, 1)) -> float:
    ent_embeds = _choose_embeds(trainer, embed_choice, w)
    kgs = trainer.kgs
    if trainer.verbose:
        print(embed_choice, "test results:")
    _, _, mrr_12 = eva.test(_rows(ent_embeds, kgs.test_entities1),
                            _rows(ent_embeds, kgs.test_entities2), None,
                            trainer.cfg.top_k, trainer.cfg.test_threads_num,
                            normalize=True, **_engine_kw(trainer))
    return mrr_12


# ---------------------------------------------------------------------------
# WVA
# ---------------------------------------------------------------------------

def _normalize_rows(x: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.norm(x, dim=1, keepdim=True)
    return torch.where(n > 0, x / torch.clamp_min(n, 1e-30), x)


def _compute_weight(embeds1, embeds2, embeds3) -> float:
    """Mean diagonal cosine between a view and the mean of all views."""
    other = _normalize_rows((embeds1 + embeds2 + embeds3) / 3)
    e1 = _normalize_rows(embeds1)
    return float(torch.mean(torch.sum(e1 * other, dim=1)))


def wva(embeds1, embeds2, embeds3) -> Tuple[float, float, float]:
    return (_compute_weight(embeds1, embeds2, embeds3),
            _compute_weight(embeds2, embeds1, embeds3),
            _compute_weight(embeds3, embeds1, embeds2))


def _wva_eval(trainer, ents1, ents2, label: str) -> float:
    get = trainer.current_embeds_device
    nv, rv, av = get("nv"), get("rv"), get("av")
    nv1, rv1, av1 = (_rows(x, ents1) for x in (nv, rv, av))
    nv2, rv2, av2 = (_rows(x, ents2) for x in (nv, rv, av))
    w11, w21, w31 = wva(nv1, rv1, av1)
    w12, w22, w32 = wva(nv2, rv2, av2)
    w1, w2, w3 = w11 + w12, w21 + w22, w31 + w32
    total = w1 + w2 + w3
    w1, w2, w3 = w1 / total, w2 / total, w3 / total
    if trainer.verbose:
        print("weights", w1, w2, w3)
        print(f"wvag {label} results:")
    _, mrr_12 = eva.valid(w1 * nv1 + w2 * rv1 + w3 * av1,
                          w1 * nv2 + w2 * rv2 + w3 * av2, None,
                          trainer.cfg.top_k, trainer.cfg.test_threads_num,
                          normalize=True, **_engine_kw(trainer))
    return mrr_12


def valid_WVA(trainer) -> float:
    kgs = trainer.kgs
    return _wva_eval(trainer, kgs.valid_entities1,
                     kgs.valid_entities2 + kgs.test_entities2, "valid")


def test_WVA(trainer) -> float:
    kgs = trainer.kgs
    return _wva_eval(trainer, kgs.test_entities1, kgs.test_entities2, "test")
