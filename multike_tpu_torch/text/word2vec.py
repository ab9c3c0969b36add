"""Word-vector lookups and the character-level fallback for words outside
the word2vec vocabulary (counterpart of multike_tpu/text/word2vec.py).

Everything here is host numpy except the character embeddings, which
``text/char_sgns.py`` trains on the given device. ``.vec`` files are read
by ``utils.native.read_word2vec``.
"""
from __future__ import annotations

from typing import Dict, Iterable, List

import numpy as np


def build_alphabet(word_list: Iterable[str],
                   min_char_frac: float = 0.0001) -> str:
    """Characters covering >= ``min_char_frac`` of all character
    occurrences, most frequent first."""
    ch_num: Dict[str, int] = {}
    for word in word_list:
        for ch in word:
            ch_num[ch] = ch_num.get(ch, 0) + 1
    ordered = sorted(ch_num.items(), key=lambda x: x[1], reverse=True)
    ch_sum = sum(n for _, n in ordered)
    if ch_sum == 0:
        return ""
    return "".join(ch for ch, n in ordered if n / ch_sum >= min_char_frac)


def words_from_char_vectors(word_list: Iterable[str],
                            character_vectors: Dict[str, np.ndarray],
                            alphabet: str,
                            vector_dimension: int = 300) -> Dict[str, np.ndarray]:
    """A word's vector is the sum of its in-alphabet character vectors over
    the word's length."""
    alpha = set(alphabet)
    word2vec: Dict[str, np.ndarray] = {}
    for word in word_list:
        vec = np.zeros(vector_dimension, dtype=np.float32)
        for ch in word:
            if ch in alpha and ch in character_vectors:
                vec += character_vectors[ch]
        if len(word) != 0:
            word2vec[word] = vec / len(word)
    return word2vec


def generate_word2vec_by_character_embedding(word_list: List[str],
                                             vector_dimension: int = 300,
                                             seed: int = 0,
                                             device=None) -> Dict[str, np.ndarray]:
    """Character-level vectors for out-of-vocabulary words: skip-gram
    character embeddings (``char_sgns``), averaged per word."""
    from multike_tpu_torch.text.char_sgns import train_char_sgns

    character_vectors = train_char_sgns(word_list, dim=vector_dimension,
                                        seed=seed, device=device)
    alphabet = build_alphabet(word_list)
    return words_from_char_vectors(word_list, character_vectors, alphabet,
                                   vector_dimension)


def generate_unlisted_word2vec(word2vec: Dict[str, np.ndarray],
                               literal_list: Iterable[str], seed: int = 0,
                               device=None) -> Dict[str, np.ndarray]:
    """Extend ``word2vec`` in place with character-level vectors for every
    literal word it lacks (each occurrence counts in the training corpus)."""
    unlisted = []
    for literal in literal_list:
        for word in literal.split(" "):
            if word not in word2vec:
                unlisted.append(word)
    if unlisted:
        word2vec.update(generate_word2vec_by_character_embedding(
            unlisted, seed=seed, device=device))
    return word2vec


def tokens2vec_add(id_tokens_dict: Dict, word2vec: Dict[str, np.ndarray],
                   vector_dimension: int = 300,
                   keep_unlist: bool = False) -> Dict:
    """Sum of the token vectors, l2-normalized; entries whose tokens are all
    out of vocabulary are dropped unless ``keep_unlist``."""
    out = {}
    for e_id, name in id_tokens_dict.items():
        vec = np.zeros(vector_dimension, np.float32)
        for word in name.split(" "):
            if word in word2vec:
                vec += word2vec[word]
        if vec.sum() != 0:
            vec = vec / np.linalg.norm(vec)
        elif not keep_unlist:
            continue
        out[e_id] = vec
    return out


def tokens2vec_encoder(id_tokens_dict: Dict, word2vec: Dict[str, np.ndarray],
                       vector_dimension: int = 300, tokens_max_len: int = 5,
                       keep_unlist: bool = False) -> Dict:
    """The first ``tokens_max_len`` token vectors of each entry, stacked."""
    out = {}
    for v_id, tokens in id_tokens_dict.items():
        words = tokens.split(" ")
        vectors = np.zeros((tokens_max_len, vector_dimension), np.float32)
        flag = False
        for i in range(min(tokens_max_len, len(words))):
            if words[i] in word2vec:
                vectors[i] = word2vec[words[i]]
                flag = True
        if flag:
            out[v_id] = vectors
    if keep_unlist:
        for v_id in id_tokens_dict:
            if v_id not in out:
                out[v_id] = np.zeros((tokens_max_len, vector_dimension),
                                     np.float32)
    return out


def look_up_word2vec(id_tokens_dict: Dict, word2vec: Dict[str, np.ndarray],
                     tokens2vec_mode: str = "add", keep_unlist: bool = False,
                     vector_dimension: int = 300, tokens_max_len: int = 5):
    if tokens2vec_mode == "add":
        return tokens2vec_add(id_tokens_dict, word2vec, vector_dimension,
                              keep_unlist)
    return tokens2vec_encoder(id_tokens_dict, word2vec, vector_dimension,
                              tokens_max_len, keep_unlist)


def look_up_char2vec(id_tokens_dict: Dict,
                     character_vectors: Dict[str, np.ndarray],
                     vector_dimension: int = 300) -> Dict:
    """Sum of the character vectors, l2-normalized."""
    out = {}
    for e_id, ln in id_tokens_dict.items():
        vec = np.zeros(vector_dimension, np.float32)
        for ch in ln:
            if ch in character_vectors:
                vec += character_vectors[ch]
        if vec.sum() != 0:
            vec = vec / np.linalg.norm(vec)
        out[e_id] = vec
    return out


def literal_token_matrix(literal_list: List[str],
                         word2vec: Dict[str, np.ndarray],
                         tokens_max_len: int = 5,
                         dim: int = 300) -> np.ndarray:
    """Each literal's first ``tokens_max_len`` token vectors (zeros where a
    token is missing), flattened to one (n, tokens_max_len * dim) matrix."""
    n = len(literal_list)
    out = np.zeros((n, tokens_max_len, dim), dtype=np.float32)
    for idx, literal in enumerate(literal_list):
        words = literal.split(" ")
        for i in range(min(tokens_max_len, len(words))):
            vec = word2vec.get(words[i])
            if vec is not None:
                out[idx, i] = vec
    return out.reshape(n, tokens_max_len * dim)
