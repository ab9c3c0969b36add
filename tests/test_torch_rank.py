"""The plain version of the port's rank kernel (K2) against the JAX
package's ``rank_count_pallas`` in interpret mode, and the port's
``rank_and_align`` / ``greedy_alignment`` against the JAX ones on its XLA
engine. Counts and argmax must be exactly equal."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multike_tpu.eval import alignment as jal
from multike_tpu.eval.similarity import csls_sim
from multike_tpu.kernels.rank_kernel import rank_count_pallas
from multike_tpu_torch.eval import alignment as tal
from multike_tpu_torch.kernels import rank_kernel as trk


def _norm(x):
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _setup(seed, n1, n2, d):
    rng = np.random.RandomState(seed)
    e1 = rng.randn(n1, d).astype(np.float32)
    e2 = rng.randn(n2, d).astype(np.float32)
    e2[:n1] += 2 * e1
    e1n, e2n = _norm(e1), _norm(e2)
    gold = np.sum(e1n * e2n[:n1], axis=1).astype(np.float32)
    gidx = np.arange(n1, dtype=np.int32)
    return e1n, e2n, gold, gidx


@pytest.mark.parametrize("row_block", [None, 7])
def test_rank_plain_matches_pallas(row_block):
    n1, n2, d = 100, 230, 16
    e1, e2, gold, gidx = _setup(3, n1, n2, d)
    cnt, bidx, bval = rank_count_pallas(
        jnp.asarray(e1), jnp.asarray(gold), jnp.asarray(gidx),
        jnp.asarray(e2), bm=32, bn=64, interpret=True)
    got = trk.rank_count(torch.tensor(e1), torch.tensor(gold),
                         torch.tensor(gidx), torch.tensor(e2),
                         row_block=row_block)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(cnt))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(bidx))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(bval), rtol=1e-6)


def test_rank_plain_matches_pallas_csls():
    n1, n2, d, k = 40, 70, 8, 4
    e1, e2, gold, gidx = _setup(4, n1, n2, d)
    s = e1 @ e2.T
    r2 = (-np.sort(-s.T, axis=1))[:, :k].mean(axis=1).astype(np.float32)
    gold_adj = (2 * gold - r2[:n1]).astype(np.float32)
    cnt, bidx, _ = rank_count_pallas(
        jnp.asarray(e1), jnp.asarray(gold_adj), jnp.asarray(gidx),
        jnp.asarray(e2), jnp.asarray(r2), bm=16, bn=32, use_csls=True,
        interpret=True)
    got = trk.rank_count(torch.tensor(e1), torch.tensor(gold_adj),
                         torch.tensor(gidx), torch.tensor(e2),
                         torch.tensor(r2), row_block=9)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(cnt))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(bidx))
    sc = csls_sim(s, k)
    want_cnt = np.array([np.sum((sc[i] > sc[i, i]) & (np.arange(n2) != i))
                         for i in range(n1)])
    np.testing.assert_array_equal(got[0].numpy(), want_cnt)


def _exact_setup(seed, n1, n2, d):
    """Small-integer entries: every score is an exact integer whatever the
    summation order, so the two engines agree bit for bit, ties included.
    Row 0's maximum is duplicated at columns 3 and n2 - 5. Row 1's maximum
    is 0.0, at column 4 (all its products -0.0) and at column n2 - 6."""
    rng = np.random.RandomState(seed)
    e1 = rng.randint(-3, 4, (n1, d)).astype(np.float32)
    e2 = rng.randint(-3, 4, (n2, d)).astype(np.float32)
    e2[:, 0] = -rng.randint(1, 4, n2)
    e1[0, 0] = 0
    top = 3 * np.where(e1[0] >= 0, 1, -1).astype(np.float32)
    top[0] = -3
    e2[[3, n2 - 5]] = top
    e1[1] = np.eye(1, d)
    e2[[4, n2 - 6]] = -1
    e2[4, 0], e2[n2 - 6, 0] = -0.0, 0.0
    gidx = rng.randint(0, n2, n1).astype(np.int32)
    return e1, e2, gidx, rng


@pytest.mark.parametrize("csls", [False, True])
@pytest.mark.parametrize("col_block", [7, 32, 64])
def test_rank_plain_col_block_matches_pallas(col_block, csls):
    """The plain version's column slices merge by the kernel's rule
    (counts add up; the larger best wins, the smaller column on equal
    values, -0.0 equal to +0.0), as the Pallas kernel's column blocks do.
    Every col_block puts row 0's two tied maxima in two slices."""
    n1, n2, d = 40, 96, 12
    e1, e2, gidx, rng = _exact_setup(6, n1, n2, d)
    s = e1.astype(np.int64) @ e2.T.astype(np.int64)
    r2 = None
    if csls:
        r2 = rng.randint(-4, 5, n2).astype(np.float32)
        r2[[3, n2 - 5]] = -4
        s = 2 * s - r2.astype(np.int64)[None, :]
    gold = (s[np.arange(n1), gidx] - np.arange(n1) % 2).astype(np.float32)
    cnt, bidx, bval = rank_count_pallas(
        jnp.asarray(e1), jnp.asarray(gold), jnp.asarray(gidx),
        jnp.asarray(e2), None if r2 is None else jnp.asarray(r2), bm=8,
        bn=col_block, use_csls=csls, interpret=True)
    got = trk.rank_count_plain(
        torch.tensor(e1), torch.tensor(gold), torch.tensor(gidx),
        torch.tensor(e2), None if r2 is None else torch.tensor(r2),
        row_block=16, col_block=col_block)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(cnt))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(bidx))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(bval), rtol=1e-6)
    np.testing.assert_array_equal(got[0].numpy(), [
        np.sum((s[i] > gold[i]) & (np.arange(n2) != gidx[i]))
        for i in range(n1)])
    assert int(got[1][0]) == 3
    if not csls:
        assert int(got[1][1]) == 4 and float(got[2][1]) == 0.0


def test_rank_count_checks_on_cpu():
    """rank_count checks its inputs on the CPU as on the card, but for the
    kernel's limit on d, which the plain version does not have."""
    e1, e2 = torch.zeros(4, 3), torch.zeros(5, 3)
    gold, gidx = torch.zeros(4), torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        trk.rank_count(e1, gold, gidx.long(), e2)
    with pytest.raises(TypeError):
        trk.rank_count(e1.double(), gold, gidx, e2)
    with pytest.raises(ValueError):
        trk.rank_count(torch.zeros(3, 4).T, gold, gidx, e2)
    with pytest.raises(ValueError):
        trk.rank_count(e1, gold, gidx, e2, torch.zeros(4))
    with pytest.raises(ValueError):
        trk.rank_count(e1, gold, gidx, torch.zeros(0, 3))
    d = trk.MAX_DIM + 1
    cnt, bidx, _ = trk.rank_count(torch.ones(4, d), gold, gidx,
                                  torch.ones(5, d))
    assert cnt.tolist() == [4] * 4 and bidx.tolist() == [0] * 4


def test_rank_plain_ties_first_index_and_gold_excluded():
    e1 = np.array([[1.0, 0.0], [0.0, 1.0]], np.float32)
    e2 = np.array([[0.0, 1.0], [0.0, 1.0], [1.0, 0.0], [1.0, 0.0]],
                  np.float32)
    gold = np.sum(e1 * e2[:2], axis=1).astype(np.float32)
    cnt, bidx, _ = trk.rank_count(torch.tensor(e1), torch.tensor(gold),
                                  torch.arange(2, dtype=torch.int32),
                                  torch.tensor(e2))
    # row 0: gold 0, columns 2 and 3 beat it; argmax ties -> first (2)
    # row 1: gold 1 at column 1, column 0 ties (not strictly greater)
    assert cnt.tolist() == [2, 0] and bidx.tolist() == [2, 0]


@pytest.mark.parametrize("tensors", [False, True])
@pytest.mark.parametrize("csls_k", [0, 3])
def test_rank_and_align_matches_jax(tensors, csls_k):
    rng = np.random.RandomState(5 + csls_k)
    n1, n2, d = 90, 140, 12
    e1 = rng.randn(n1, d).astype(np.float32)
    e2 = rng.randn(n2, d).astype(np.float32)
    e2[:n1] += 1.5 * e1
    if tensors:
        want = jal.rank_and_align(jnp.asarray(e1), jnp.asarray(e2),
                                  csls_k=csls_k, use_pallas=False,
                                  col_block=32)
        got = tal.rank_and_align(torch.tensor(e1), torch.tensor(e2),
                                 csls_k=csls_k, col_block=32, row_block=17)
    else:
        want = jal.rank_and_align(e1, e2, csls_k=csls_k, use_pallas=False,
                                  col_block=32)
        got = tal.rank_and_align(e1, e2, csls_k=csls_k, col_block=32,
                                 device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("metric,csls_k", [("inner", 0), ("cosine", 2),
                                           ("euclidean", 0)])
def test_greedy_alignment_matches_jax(metric, csls_k):
    rng = np.random.RandomState(11)
    e1 = rng.randn(50, 10).astype(np.float32)
    e2 = rng.randn(60, 10).astype(np.float32)
    e2[:50] += e1
    kw = dict(metric=metric, normalize=True, csls_k=csls_k, verbose=False)
    want = jal.greedy_alignment(e1, e2, [1, 5, 10], 1, use_pallas=False, **kw)
    got = tal.greedy_alignment(e1, e2, [1, 5, 10], 1, device="cpu", **kw)
    assert got[0] == want[0]
    assert got[1] == want[1]
    np.testing.assert_allclose(got[2:], want[2:], rtol=1e-12)


def test_stable_alignment_matches_jax():
    rng = np.random.RandomState(12)
    e1 = rng.randn(12, 6).astype(np.float32)
    e2 = e1 + 0.3 * rng.randn(12, 6).astype(np.float32)
    want = jal.stable_alignment(e1, e2, normalize=True, verbose=False)
    got = tal.stable_alignment(e1, e2, normalize=True, verbose=False)
    assert got == want


def test_rank_kernel_wrapper_checks():
    e1 = torch.zeros(4, 3)
    e2 = torch.zeros(5, 3)
    gold = torch.zeros(4)
    gidx = torch.zeros(4, dtype=torch.int32)
    trk._check(e1, gold, gidx, e2, torch.zeros(5))
    with pytest.raises(TypeError):
        trk._check(e1, gold, gidx.long(), e2, None)
    with pytest.raises(ValueError):
        trk._check(e1, gold, gidx, torch.zeros(5, 4), None)
    with pytest.raises(ValueError):
        trk._check(e1, gold, gidx, e2, torch.zeros(4))
    with pytest.raises(ValueError):
        trk._check(torch.zeros(3, 4).T, gold, gidx, e2, None)
    with pytest.raises(ValueError):
        trk._check(torch.zeros(4, trk.MAX_DIM + 1), gold, gidx,
                   torch.zeros(5, trk.MAX_DIM + 1), None)
