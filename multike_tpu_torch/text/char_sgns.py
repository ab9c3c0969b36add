"""Skip-gram with negative sampling over character sequences (counterpart
of multike_tpu/text/char_sgns.py), which gives out-of-vocabulary words a
fallback vector: characters seen in similar contexts get similar vectors.

Training runs in minibatches of (center, context) pairs on the given
device. Initialisation follows gensim: input vectors uniform in
±0.5/dim, output vectors zero. Each step scatter-adds the batch's
gradients (``index_add_``) scaled by ``lr / batch``: with a small alphabet
one row takes many colliding updates per batch, and the average keeps the
step stable.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from multike_tpu_torch.utils.device import resolve_device


def build_pairs(word_list: List[str], window: int):
    """(vocab, centers, contexts): every (center, context) character-id
    pair within ``window`` positions of one word."""
    vocab: Dict[str, int] = {}
    for w in word_list:
        for ch in w:
            if ch not in vocab:
                vocab[ch] = len(vocab)
    centers, contexts = [], []
    for w in word_list:
        ids = [vocab[c] for c in w]
        for i, c in enumerate(ids):
            for j in range(max(0, i - window), min(len(ids), i + window + 1)):
                if j != i:
                    centers.append(c)
                    contexts.append(ids[j])
    return vocab, np.asarray(centers, np.int64), np.asarray(contexts, np.int64)


def sgns_step(w_in: torch.Tensor, w_out: torch.Tensor, c_ids: torch.Tensor,
              o_ids: torch.Tensor, w: torch.Tensor, neg: torch.Tensor,
              lr: float):
    """One SGNS step on a batch, in place. ``c_ids``/``o_ids`` (B,) center
    and context ids, ``w`` (B,) pair weights (0 for padding), ``neg``
    (B, k) negative context ids."""
    batch, dim = c_ids.shape[0], w_in.shape[1]
    c_vec = w_in[c_ids]
    o_vec = w_out[o_ids]
    n_vec = w_out[neg]                                     # (B, k, d)
    pos_logit = torch.sum(c_vec * o_vec, dim=1)
    neg_logit = torch.einsum("bd,bkd->bk", c_vec, n_vec)
    g_pos = (torch.sigmoid(pos_logit) - 1.0) * w
    g_neg = torch.sigmoid(neg_logit) * w[:, None]
    d_c = g_pos[:, None] * o_vec + torch.einsum("bk,bkd->bd", g_neg, n_vec)
    d_o = g_pos[:, None] * c_vec
    d_n = g_neg[:, :, None] * c_vec[:, None, :]
    scale = lr / batch
    w_in.index_add_(0, c_ids, -scale * d_c)
    w_out.index_add_(0, o_ids, -scale * d_o)
    w_out.index_add_(0, neg.reshape(-1), -scale * d_n.reshape(-1, dim))


def train_char_sgns(word_list: List[str], dim: int = 300, window: int = 5,
                    negatives: int = 5, epochs: int = 100, batch: int = 4096,
                    lr: float = 0.25, seed: int = 0,
                    device=None) -> Dict[str, np.ndarray]:
    """``{character: vector}`` trained on the characters of ``word_list``."""
    vocab, centers, contexts = build_pairs(word_list, window)
    v = len(vocab)
    if v == 0:
        return {}
    n_pairs = len(centers)
    if n_pairs == 0:
        # single-character words only: random but deterministic vectors
        rng = np.random.RandomState(seed)
        return {ch: rng.uniform(-0.5 / dim, 0.5 / dim, size=dim)
                .astype(np.float32) for ch in vocab}

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    w_in = torch.empty((v, dim), dtype=torch.float32, device=dev)
    w_in.uniform_(-0.5 / dim, 0.5 / dim, generator=gen)
    w_out = torch.zeros((v, dim), dtype=torch.float32, device=dev)

    steps = -(-n_pairs // batch)
    pad = steps * batch - n_pairs
    cen = torch.as_tensor(np.concatenate([centers, np.zeros(pad, np.int64)]),
                          device=dev)
    ctx = torch.as_tensor(np.concatenate([contexts, np.zeros(pad, np.int64)]),
                          device=dev)
    wgt = torch.cat([torch.ones(n_pairs, device=dev),
                     torch.zeros(pad, device=dev)])
    total = steps * batch
    for _ in range(epochs):
        perm = torch.randperm(total, generator=gen, device=dev)
        c, o, w = (x[perm].reshape(steps, batch) for x in (cen, ctx, wgt))
        neg = torch.randint(0, v, (steps, batch, negatives), generator=gen,
                            device=dev)
        for i in range(steps):
            sgns_step(w_in, w_out, c[i], o[i], w[i], neg[i], lr)
    mat = w_in.cpu().numpy()
    return {ch: mat[i] for ch, i in vocab.items()}
