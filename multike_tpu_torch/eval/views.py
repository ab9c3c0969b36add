"""Per-view evaluation (counterpart of multike_tpu/eval/views.py).

``valid_metrics`` / ``valid`` / ``test`` rank one choice of embeddings:
``embed_choice`` in {nv, rv, av, final}, or 'avg', the w-weighted sum of
the nv, rv and av views. The embeddings stay on the trainer's device: only
the (n1,) rank vectors reach the host. WVA (weighted view averaging)
arrives with the SSL slice.
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
    cfg = trainer.cfg
    return dict(
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
