"""The port's Bloom filter of the true triples against the JAX package.

The words (``build_triple_filter``), the host hash (``_hash_word_bits_np``)
and the membership test (``triple_filter_contains``) are bit-equal to the
JAX package's, on random ids and on the edge ids 0 and 2**31 - 1. Then the
contracts of tests/test_triple_filter.py: no false negatives, a low
false-positive rate, "drop" masks every true triple, and "resample"
returns no keep mask and removes nearly every true triple."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multike_tpu import sampling as js
from multike_tpu_torch import sampling as ts

EDGE = 2 ** 31 - 1


def _triples(rng, n, hi):
    t = rng.randint(0, hi, size=(n, 3)).astype(np.int64)
    t[:4] = [[0, 0, 0], [EDGE, EDGE, EDGE], [0, EDGE, 5], [EDGE, 0, EDGE]]
    return t


def _jax_contains(f, trip):
    return np.asarray(js.triple_filter_contains(
        f, *(jnp.asarray(trip[:, k].astype(np.int32)) for k in range(3))))


def _contains(f, trip):
    return ts.triple_filter_contains(
        f, *(torch.as_tensor(trip[:, k]) for k in range(3))).numpy()


@pytest.mark.parametrize("log2m", [16, 25])
def test_words_hash_and_membership_bit_equal(log2m):
    rng = np.random.RandomState(log2m)
    trip = _triples(rng, 20_000, EDGE)
    for got, want in zip(ts._hash_word_bits_np(*trip.T, log2m),
                         js._hash_word_bits_np(*trip.T, log2m)):
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, want)
    f = ts.build_triple_filter(trip, log2m=log2m)
    jf = js.build_triple_filter(trip.astype(np.int32), log2m=log2m)
    assert f.bits.dtype == torch.int32 and f.log2m == log2m
    np.testing.assert_array_equal(f.bits.numpy().view(np.uint32),
                                  np.asarray(jf.bits))
    probe = np.concatenate([trip, _triples(rng, 100_000, EDGE)])
    got = _contains(f, probe)
    np.testing.assert_array_equal(got, _jax_contains(jf, probe))
    assert got[:len(trip)].all()
    # broadcasting: a (B, 1) head column against (B, K) tails
    h, r = torch.as_tensor(probe[:50, :1]), torch.as_tensor(probe[:50, 1:2])
    t = torch.as_tensor(probe[:500, 2].reshape(50, 10))
    np.testing.assert_array_equal(
        ts.triple_filter_contains(f, h, r, t).numpy(),
        np.asarray(js.triple_filter_contains(
            jf, jnp.asarray(h.numpy(), jnp.int32),
            jnp.asarray(r.numpy(), jnp.int32),
            jnp.asarray(t.numpy(), jnp.int32))))


def test_filter_no_false_negatives():
    triples = np.random.RandomState(0).randint(0, 1000, size=(5000, 3))
    assert _contains(ts.build_triple_filter(triples, log2m=20), triples).all()


def test_filter_low_false_positive_rate():
    rng = np.random.RandomState(1)
    f = ts.build_triple_filter(rng.randint(0, 500, size=(2000, 3)), log2m=20)
    probe = rng.randint(1000, 2000, size=(20000, 3))          # disjoint
    assert _contains(f, probe).mean() < 0.01


def _dense_graph(seed, E=12):
    """~60% of all (h, 0, t) pairs exist: plain draws hit many."""
    rng = np.random.RandomState(seed)
    pairs = [(h, 0, t) for h in range(E) for t in range(E) if h != t]
    rng.shuffle(pairs)
    triples = np.asarray(pairs[: int(0.6 * len(pairs))], np.int64)
    return triples, {tuple(x) for x in triples.tolist()}


def _assembled(pos, cand, ch):
    pos, cand, ch = pos.numpy(), cand.numpy(), ch.numpy()
    h = np.where(ch, cand, pos[:, :1])
    t = np.where(ch, pos[:, 2:], cand)
    return [(int(a), int(p[1]), int(b)) for hs, p, ts_ in zip(h, pos, t)
            for a, b in zip(hs, ts_)]


def test_drop_mode_masks_all_true_triples():
    triples, tset = _dense_graph(3)
    f = ts.build_triple_filter(triples, log2m=16)
    pos = torch.as_tensor(triples[:50])
    cand, ch, keep = ts.sample_corruptions(
        torch.Generator().manual_seed(1), pos, 0, 12, 10, tfilter=f,
        reject_mode="drop")
    assert keep is not None and keep.shape == (50, 10)
    assert keep.dtype == torch.float32
    negs = _assembled(pos, cand, ch)
    kept = keep.numpy().reshape(-1)
    assert all(k == 0.0 for n, k in zip(negs, kept) if n in tset)
    assert 0 < kept.mean() < 1


def test_resample_mode_returns_none_keep_and_rejects():
    triples, tset = _dense_graph(2)
    f = ts.build_triple_filter(triples, log2m=16)
    pos = torch.as_tensor(triples[:50])
    _, _, keep = ts.sample_corruptions(torch.Generator().manual_seed(0),
                                       torch.as_tensor([[0, 0, 1], [1, 0, 2]]),
                                       0, 10, 4)
    assert keep is None
    plain = ts.sample_negatives(torch.Generator().manual_seed(0), pos, 0, 12,
                                10)
    frac_plain = np.mean([tuple(x) in tset for x in plain.tolist()])
    cand, ch, keep = ts.sample_corruptions(
        torch.Generator().manual_seed(0), pos, 0, 12, 10, tfilter=f,
        retries=8, reject_mode="resample")
    assert keep is None
    frac_res = np.mean([n in tset for n in _assembled(pos, cand, ch)])
    rej = ts.sample_negatives(torch.Generator().manual_seed(0), pos, 0, 12,
                              10, tfilter=f, retries=8)
    frac_rej = np.mean([tuple(x) in tset for x in rej.tolist()])
    assert frac_plain > 0.3
    assert frac_res < frac_plain / 4 and frac_rej < frac_plain / 4
    with pytest.raises(ValueError):
        ts.sample_corruptions(torch.Generator(), pos, 0, 12, 2,
                              reject_mode="keep")
