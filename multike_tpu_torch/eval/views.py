"""Per-view evaluation (counterpart of multike_tpu/eval/views.py).

``valid_metrics`` / ``valid`` / ``test`` rank one view's embeddings
(``embed_choice`` in {rv, av, final}; nv needs the name pipeline). The
embeddings stay on the trainer's device: only the (n1,) rank vectors reach
the host. The 'avg' choice and WVA weighting arrive with the combination
slice.
"""
from __future__ import annotations

from typing import Tuple

import torch

from multike_tpu_torch.eval import evaluation as eva


def _choose_embeds(trainer, embed_choice: str):
    if embed_choice == "avg":
        raise NotImplementedError(
            "the 'avg' / WVA view combination arrives in a later slice of "
            "the port")
    return trainer.current_embeds_device(embed_choice)


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


def valid_metrics(trainer, embed_choice: str = "rv") -> Tuple[float, float]:
    """(hits@1, mrr) on the validation split, ranked against the valid and
    test entities of KG2."""
    ent_embeds = _choose_embeds(trainer, embed_choice)
    kgs = trainer.kgs
    if trainer.verbose:
        print(embed_choice, "valid results:")
    return eva.valid(_rows(ent_embeds, kgs.valid_entities1),
                     _rows(ent_embeds, kgs.valid_entities2 + kgs.test_entities2),
                     None, trainer.cfg.top_k, trainer.cfg.test_threads_num,
                     normalize=True, **_engine_kw(trainer))


def valid(trainer, embed_choice: str = "rv") -> float:
    return valid_metrics(trainer, embed_choice)[1]


def test(trainer, embed_choice: str = "rv") -> float:
    ent_embeds = _choose_embeds(trainer, embed_choice)
    kgs = trainer.kgs
    if trainer.verbose:
        print(embed_choice, "test results:")
    _, _, mrr_12 = eva.test(_rows(ent_embeds, kgs.test_entities1),
                            _rows(ent_embeds, kgs.test_entities2), None,
                            trainer.cfg.top_k, trainer.cfg.test_threads_num,
                            normalize=True, **_engine_kw(trainer))
    return mrr_12
