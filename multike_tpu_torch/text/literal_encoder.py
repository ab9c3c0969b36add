"""Literal encoder: tokens -> word vectors -> autoencoder -> dim-d vectors
(counterpart of multike_tpu/text/literal_encoder.py).

  * extend word2vec with character-level vectors for unlisted words;
  * each literal -> its first ``tokens_max_len`` token vectors, flattened;
  * train the autoencoder ``encoder_epoch`` epochs;
  * encode the literal matrix with the raw encoder.

Reference quirk kept: the autoencoder trains on row-normalized inputs but
encodes the raw, unnormalized token matrix.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from multike_tpu_torch.config import Config
from multike_tpu_torch.text.autoencoder import AutoEncoder
from multike_tpu_torch.text.word2vec import (generate_unlisted_word2vec,
                                             literal_token_matrix)


class LiteralEncoder:
    def __init__(self, literal_list: List[str],
                 word2vec: Dict[str, np.ndarray], cfg: Config,
                 verbose: bool = False, device=None):
        self.cfg = cfg
        self.literal_list = literal_list
        t0 = time.time()
        self.word2vec = generate_unlisted_word2vec(word2vec, literal_list,
                                                   seed=cfg.seed,
                                                   device=device)
        raw = literal_token_matrix(literal_list, self.word2vec,
                                   cfg.tokens_max_len, cfg.word2vec_dim)
        self.auto_encoder = AutoEncoder(
            raw, cfg, input_dim=cfg.tokens_max_len * cfg.word2vec_dim,
            seed=cfg.seed, device=device)
        t1 = time.time()
        self.auto_encoder.fit(verbose=verbose)
        self.encoded_literal_vector = self.auto_encoder.encode(raw)
        # host seconds: word vectors, token matrix and its upload; encoder
        # fit and encode
        self.seconds = {"tokens": t1 - t0, "autoencoder": time.time() - t1}
