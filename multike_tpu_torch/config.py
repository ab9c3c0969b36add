"""Configuration (counterpart of multike_tpu/config.py).

Every field of the reference ``Config`` is kept, with the same default, so
one ``args.json`` loads into either package. Fields that only choose between
TPU implementations are accepted and documented as such.

Reference quirk preserved: ``encoder_active`` defaults to ``"thah"`` (the
reference's typo, which makes its literal autoencoder linear).
"""
from __future__ import annotations

import dataclasses
import json
from typing import List


@dataclasses.dataclass
class Config:
    # --- paths ---
    training_data: str = ""
    output: str = "output/results/"
    word2vec_path: str = ""
    dataset_division: str = "631/"

    # --- alignment module: only 'swapping' is supported, as in the reference
    alignment_module: str = "swapping"

    # --- literal encoder ---
    encoder_epoch: int = 100
    encoder_active: str = "thah"
    encoder_normalize: bool = True
    retrain_literal_embeds: bool = True
    literal_normalize: bool = True

    # --- model ---
    dim: int = 75

    # --- optimization ---
    learning_rate: float = 0.001
    optimizer: str = "Adagrad"
    max_epoch: int = 200
    shared_learning_max_epoch: int = 200
    batch_size: int = 5000
    entity_batch_size: int = 5000
    attribute_batch_size: int = 5000

    # --- negative sampling ---
    neg_triple_num: int = 10
    neg_sampling: str = "truncated"
    # per_slot exact rejection (Bloom filter over the true triples; built
    # when this is > 0 or chunk_exact_rejection is on): max resample rounds,
    # and whether an offending slot is dropped ("drop", one Bloom pass, the
    # slot leaves the loss) or redrawn ("resample", up to
    # neg_rejection_tries rounds, each ending in a host sync).
    neg_rejection_tries: int = 10
    neg_reject_mode: str = "drop"
    # Zero-mask (positive, pool-candidate) pairs that are true triples in the
    # chunk_shared scheme (O(batch * 2C) Bloom tests a step).
    chunk_exact_rejection: bool = False
    truncated_epsilon: float = 0.98
    truncated_freq: int = 20
    # "chunk_shared": chunks of positives share head- and tail-corruption
    # candidate pools, so negative scoring is a batched matmul and the
    # gradient touches O(chunks * pool) candidate rows instead of O(B * K).
    # "per_slot": reference-exact iid candidate per negative slot.
    neg_scheme: str = "chunk_shared"
    neg_chunk_size: int = 4096
    # Negative scheme, chunk size and pool size C of the neighbor-truncated
    # phase (epochs after the first neighbor refresh); 0 pool = the
    # uniform phase's.
    truncated_neg_scheme: str = "chunk_shared"
    truncated_chunk_size: int = 4096
    truncated_pool_size: int = 128
    # Size C of each shared candidate pool per chunk; 0 = neg_triple_num.
    # Every positive scores against all 2C pool members, each weighted
    # neg_triple_num / (2C): the reference's K per-slot draws in expectation.
    neg_pool_size: int = 128

    # --- host parallelism knobs of the reference; kept for compatibility ---
    batch_threads_num: int = 4
    test_threads_num: int = 8

    # --- evaluation cadence ---
    start_valid: int = 100
    eval_freq: int = 10
    stop_metric: str = "mrr"
    top_k: List[int] = dataclasses.field(default_factory=lambda: [1, 5, 10, 50])
    is_save: bool = True

    # --- combination losses ---
    orthogonal_weight: float = 2.0
    cv_name_weight: float = 1.0
    cv_weight: float = 1.0

    # --- predicate alignment ---
    start_predicate_soft_alignment: int = 10
    predicate_soft_sim: float = 0.85
    predicate_init_sim: float = 0.90

    # --- extra learning rates ---
    relation_learning_rate: float = 0.005
    ITC_learning_rate: float = 0.004

    # ------------------------------------------------------------------
    # Knobs the JAX package added
    # ------------------------------------------------------------------
    enable_early_stop: bool = False
    # Device mesh (data x table parallel): a product > 1 trains on that many
    # ranks, one process each, over torch.distributed (parallel/context.py);
    # the process group must have exactly mesh_dp * mesh_tp ranks.
    mesh_dp: int = 1
    mesh_tp: int = 1
    # Row block of the plain rank engine (0 = auto) and the column block of
    # the CSLS penalty pass. The CUDA rank kernel picks its own tiles.
    eval_row_block: int = 0
    eval_col_block: int = 4096
    # 'float32' | 'bfloat16': 'bfloat16' rounds the eval inputs to bf16
    # before the float32 ranking (products are exact in float32).
    eval_matmul_dtype: str = "float32"
    # TPU only: recall target of approx_max_k in the neighbor refresh.
    neighbor_recall_target: float = 0.85
    # TPU only: persistent XLA compilation cache directory; accepted and
    # ignored here (utils/misc.py).
    compile_cache_dir: str = ""
    checkpoint_dir: str = ""
    checkpoint_freq: int = 0
    metrics_log_path: str = ""
    # Row-sparse Adagrad (train/sparse_adagrad.py): update only the rows a
    # step touches. "auto" picks row-sparse when the step touches <= 1/4 of a
    # table of >= 150K rows, or the table has >= row_sparse_min_rows rows;
    # True/"on" or False/"off" force. Only with optimizer == "Adagrad".
    row_sparse_updates: str | bool = "auto"
    row_sparse_min_rows: int = 400_000
    seed: int = 2019
    # TPU only: chose between the Pallas rank kernel and an XLA engine. On
    # the card, rank_and_align always runs the CUDA rank kernel.
    use_pallas: bool = True
    # TPU only: chose between the fused Pallas Adagrad apply and XLA's
    # gather/scatter. On the card, the row-sparse apply always runs the CUDA
    # apply kernel.
    use_pallas_apply: bool = False
    tokens_max_len: int = 5
    word2vec_dim: int = 300

    @property
    def hidden_dims(self) -> List[int]:
        # autoencoder stack 1500 -> 1024 -> 512 -> dim
        return [1024, 512, self.dim]

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def load_config(file_path: str, **overrides) -> Config:
    """Load a reference-format JSON config. Unknown keys are ignored with a
    warning so future reference configs load."""
    with open(file_path, "r") as f:
        raw = json.load(f)
    known = {f.name for f in dataclasses.fields(Config)}
    unknown = [k for k in raw if k not in known]
    if unknown:
        print("load_config: ignoring unknown keys:", unknown)
    kwargs = {k: v for k, v in raw.items() if k in known}
    kwargs.update(overrides)
    return Config(**kwargs)
