"""DataModel: the data facade (counterpart of multike_tpu/data/dataset.py).

Read the KG pair (sequential ids, swapped supervision triples) -> entity
local names -> literal list (cleaned attribute values and local names) ->
literal encoder, whose output is cached in the data folder as
``literal_vectors.npy`` + ``literals.txt`` and read back when
``retrain_literal_embeds`` is off -> the entity-ordered name matrix ->
attribute values re-indexed to value ids, the swapped supervision
attribute triples, and the value matrix.

The name and value matrices are host float32 arrays; the trainer moves them
to its device. The literal encoder runs on ``device``.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List

import numpy as np

from multike_tpu_torch.config import Config
from multike_tpu_torch.data.cleaning import clear_attribute_triples
from multike_tpu_torch.data.kg import (KGs, generate_sup_attribute_triples,
                                       read_kgs_from_folder)
from multike_tpu_torch.data.readers import read_local_names
from multike_tpu_torch.parallel import distributed
from multike_tpu_torch.utils.native import read_word2vec

LITERAL_EMBEDDINGS_FILE = "literal_vectors.npy"
LITERAL_FILE = "literals.txt"


def _row_normalize(mat: np.ndarray) -> np.ndarray:
    norms = np.linalg.norm(mat, axis=1, keepdims=True)
    return np.where(norms > 0, mat / np.maximum(norms, 1e-30), mat)


def save_literal_vectors(folder: str, literal_list: List[str],
                         vectors: np.ndarray):
    """Each file is written under a temporary name and renamed into place,
    the vectors last, so a reader that finds the vectors (another rank of
    a mesh, racing the writer) finds both files whole."""
    if len(literal_list) != len(vectors):
        raise ValueError(f"{len(literal_list)} literals, {len(vectors)} "
                         "vectors")
    tmp = f".{os.getpid()}.tmp"
    lits = os.path.join(folder, LITERAL_FILE)
    with open(lits + tmp, "w", encoding="utf-8") as f:
        for lit in literal_list:
            f.write(lit + "\n")
    os.replace(lits + tmp, lits)
    vecs = os.path.join(folder, LITERAL_EMBEDDINGS_FILE)
    with open(vecs + tmp, "wb") as f:
        np.save(f, vectors)
    os.replace(vecs + tmp, vecs)


def load_literal_vectors(folder: str):
    mat = np.load(os.path.join(folder, LITERAL_EMBEDDINGS_FILE))
    with open(os.path.join(folder, LITERAL_FILE), "r", encoding="utf-8") as f:
        literal_list = [line.strip("\n") for line in f]
    return literal_list, np.asarray(mat)


class DataModel:
    def __init__(self, cfg: Config,
                 word2vec: Dict[str, np.ndarray] | None = None,
                 verbose: bool = False, device=None):
        """``word2vec`` may be injected; otherwise it is read from
        ``cfg.word2vec_path``. ``device`` runs the literal encoder (default:
        the card)."""
        self.cfg = cfg
        self.verbose = verbose
        self.device = device
        t0 = time.time()
        self.kgs: KGs = read_kgs_from_folder(cfg.training_data,
                                             cfg.dataset_division,
                                             cfg.alignment_module, False)
        self.entities = self.kgs.kg1.entities_set | self.kgs.kg2.entities_set
        self.entity_local_name_dict = read_local_names(
            cfg.training_data,
            set(self.kgs.kg1.entities_id_dict.keys()),
            set(self.kgs.kg2.entities_id_dict.keys()))
        self._cleaned = (
            clear_attribute_triples(
                self.kgs.kg1.local_attribute_triples_list)[0],
            clear_attribute_triples(
                self.kgs.kg2.local_attribute_triples_list)[0])
        # host seconds of each part: reading and cleaning the KG pair, the
        # literal vectors (the encoder's, or the cache read) and the matrices
        self.seconds = {"kgs": time.time() - t0}
        t0 = time.time()
        self._generate_literal_vectors(word2vec)
        self.seconds["literal_vectors"] = time.time() - t0
        t0 = time.time()
        self._generate_name_vectors_mat()
        self._generate_attribute_value_vectors()
        self.seconds["matrices"] = time.time() - t0

    # ------------------------------------------------------------------
    def _generate_literal_vectors(self, word2vec):
        cfg = self.cfg
        cache = os.path.join(cfg.training_data, LITERAL_EMBEDDINGS_FILE)
        if not cfg.retrain_literal_embeds and os.path.exists(cache):
            self.literal_list, self.literal_vectors_mat = \
                load_literal_vectors(cfg.training_data)
        else:
            cleaned1, cleaned2 = self._cleaned
            value_list = [v for (_, _, v) in cleaned1 + cleaned2]
            local_name_list = list(self.entity_local_name_dict.values())
            self.literal_list = sorted(set(value_list + local_name_list))
            if word2vec is None:
                word2vec = read_word2vec(cfg.word2vec_path, cfg.word2vec_dim)
            from multike_tpu_torch.text.literal_encoder import LiteralEncoder

            enc = LiteralEncoder(self.literal_list, word2vec, cfg,
                                 verbose=self.verbose, device=self.device)
            self.literal_vectors_mat = enc.encoded_literal_vector
            self.seconds.update(enc.seconds)
            # every rank of a mesh encodes alike; one writes the cache
            if distributed.rank() == 0:
                save_literal_vectors(cfg.training_data, self.literal_list,
                                     self.literal_vectors_mat)
        if self.literal_vectors_mat.shape[0] != len(self.literal_list):
            raise ValueError("literal cache: vector and literal counts differ")
        self.literal_id_dic = {lit: i for i, lit in
                               enumerate(self.literal_list)}
        if len(self.literal_id_dic) != len(self.literal_list):
            raise ValueError("literal cache: duplicate literals")

    # ------------------------------------------------------------------
    def _generate_name_vectors_mat(self):
        """Entity-id-ordered name matrix."""
        num = len(self.entities)
        id_to_uri = {v: k for k, v in self.kgs.kg1.entities_id_dict.items()}
        id_to_uri.update({v: k for k, v in
                          self.kgs.kg2.entities_id_dict.items()})
        if len(id_to_uri) != num:
            raise ValueError("entity ids do not cover the entities")
        name_ordered = []
        for i in range(num):
            name = self.entity_local_name_dict[id_to_uri[i]]
            idx = self.literal_id_dic.get(name)
            if idx is None:
                raise KeyError(f"local name {name!r} missing from the "
                               "literals")
            name_ordered.append(idx)
        mat = np.asarray(self.literal_vectors_mat)[name_ordered, :].astype(
            np.float32)
        if self.cfg.literal_normalize:
            mat = _row_normalize(mat)
        self.local_name_vectors = mat

    # ------------------------------------------------------------------
    def _generate_attribute_value_vectors(self):
        """Re-index attribute values to value ids, rebuild both KGs'
        attribute sets and the swapped supervision attribute triples, and
        build the value matrix."""
        literal_set = set(self.literal_list)
        cleaned1, cleaned2 = self._cleaned
        keep1 = {(h, a, v) for (h, a, v) in cleaned1 if v in literal_set}
        keep2 = {(h, a, v) for (h, a, v) in cleaned2 if v in literal_set}
        values_list = sorted({v for (_, _, v) in keep1 | keep2})
        values_id_dic = {v: i for i, v in enumerate(values_list)}
        self.kgs.kg1.set_attributes(
            {(h, a, values_id_dic[v]) for (h, a, v) in keep1})
        self.kgs.kg2.set_attributes(
            {(h, a, values_id_dic[v]) for (h, a, v) in keep2})
        sup1, sup2 = generate_sup_attribute_triples(
            self.kgs.train_links, self.kgs.kg1.av_dict, self.kgs.kg2.av_dict)
        self.kgs.kg1.add_sup_attribute_triples(sup1)
        self.kgs.kg2.add_sup_attribute_triples(sup2)

        value_ordered = [self.literal_id_dic[v] for v in values_list]
        mat = np.asarray(self.literal_vectors_mat)[value_ordered, :].astype(
            np.float32)
        if self.cfg.literal_normalize:
            mat = _row_normalize(mat)
        self.value_vectors = mat
        self.values_id_dic = values_id_dic
