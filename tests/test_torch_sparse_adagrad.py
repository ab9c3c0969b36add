"""The PyTorch port's row-sparse Adagrad and the plain version of its fused
apply kernel (K1) against the JAX package: ``sparse_adagrad.row_apply`` and
``fused_row_adagrad_pallas`` in interpret mode.

Tolerance rtol 2e-6 / atol 1e-7 (one rsqrt and a few float32 products per
element); rows the step does not touch stay bit-identical and sentinel slots
are dropped."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multike_tpu.kernels.apply_kernel import fused_row_adagrad_pallas
from multike_tpu.train import sparse_adagrad as jsa
from multike_tpu_torch.kernels import apply_kernel as tk
from multike_tpu_torch.train import sparse_adagrad as tsa

TOL = dict(rtol=2e-6, atol=1e-7)


def _state(seed, E, d, N, id_hi=None):
    rng = np.random.RandomState(seed)
    param = rng.randn(E, d).astype(np.float32)
    acc = (0.1 + rng.rand(E, d)).astype(np.float32)
    ids = rng.randint(0, id_hi or E, N).astype(np.int32)
    g_rows = rng.randn(N, d).astype(np.float32)
    return param, acc, ids, g_rows


@pytest.mark.parametrize("seed,E,d,N", [(0, 40, 8, 23), (1, 12, 5, 64),
                                        (2, 300, 75, 500)])
def test_row_apply_matches_jax(seed, E, d, N):
    param, acc, ids, g_rows = _state(seed, E, d, N)
    assert len(np.unique(ids)) < N           # duplicates present
    want_p, want_a = jsa.row_apply(jnp.asarray(param), jnp.asarray(acc),
                                   jnp.asarray(ids), jnp.asarray(g_rows), 0.1)
    tp_, ta = torch.tensor(param), torch.tensor(acc)
    got_p, got_a = tsa.row_apply(tp_, ta, torch.tensor(ids).long(),
                                 torch.tensor(g_rows), 0.1)
    assert got_p is tp_ and got_a is ta      # updated in place
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **TOL)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), **TOL)
    untouched = sorted(set(range(E)) - set(ids.tolist()))
    np.testing.assert_array_equal(got_p.numpy()[untouched], param[untouched])
    np.testing.assert_array_equal(got_a.numpy()[untouched], acc[untouched])


def test_row_apply_sharded_offset_matches_jax():
    """A row shard [offset, offset + rows) of a larger table: ids outside
    the shard are dropped on both sides."""
    E_local, off, total, d, N = 16, 10, 40, 6, 50
    param, acc, ids, g_rows = _state(3, E_local, d, N, id_hi=total)
    want_p, want_a = jsa.row_apply(jnp.asarray(param), jnp.asarray(acc),
                                   jnp.asarray(ids), jnp.asarray(g_rows), 0.05,
                                   row_offset=off, total_rows=total)
    got_p, got_a = tsa.row_apply(torch.tensor(param), torch.tensor(acc),
                                 torch.tensor(ids).long(),
                                 torch.tensor(g_rows), 0.05, row_offset=off,
                                 total_rows=total)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **TOL)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), **TOL)


def _jax_dedup(ids, g_rows, E):
    """(loc, gsum) as tests/test_pallas_kernels.py builds them."""
    ids, g_rows = jnp.asarray(ids), jnp.asarray(g_rows)
    order = jnp.argsort(ids)
    sid = jnp.take(ids, order)
    sg = jnp.take(g_rows, order, axis=0)
    is_start = jnp.concatenate([jnp.ones((1,), bool), sid[1:] != sid[:-1]])
    seg = jnp.cumsum(is_start.astype(jnp.int32)) - 1
    gsum = jnp.zeros_like(g_rows).at[seg].add(sg)
    loc = (E + jnp.arange(ids.shape[0], dtype=ids.dtype)).at[seg].set(sid)
    return np.asarray(loc), np.asarray(gsum)


@pytest.mark.parametrize("seed,E,d,N", [(4, 40, 8, 23), (5, 64, 75, 100)])
def test_apply_kernel_plain_matches_pallas(seed, E, d, N):
    param, acc, ids, g_rows = _state(seed, E, d, N)
    loc, gsum = _jax_dedup(ids, g_rows, E)
    want_p, want_a = fused_row_adagrad_pallas(
        jnp.asarray(param), jnp.asarray(acc), jnp.asarray(loc),
        jnp.asarray(gsum), 0.1, bl=8, interpret=True)
    got_p, got_a = tk.fused_row_adagrad_plain(
        torch.tensor(param), torch.tensor(acc), torch.tensor(loc),
        torch.tensor(gsum), 0.1)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **TOL)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), **TOL)


def test_port_dedup_matches_jax_dedup():
    param, acc, ids, g_rows = _state(6, 30, 4, 40)
    loc, gsum = _jax_dedup(ids, g_rows, 30)
    tloc, tgsum = tsa.dedup_rows(torch.tensor(ids).long(),
                                 torch.tensor(g_rows), 30)
    assert tloc.dtype == torch.int32
    u = len(np.unique(ids))
    np.testing.assert_array_equal(tloc.numpy()[:u], loc[:u])
    assert (tloc.numpy()[u:] >= 30).all()
    assert len(set(tloc.numpy().tolist())) == len(tloc)   # sentinels distinct
    np.testing.assert_allclose(tgsum.numpy()[:u], gsum[:u], **TOL)


def test_apply_kernel_sentinels_dropped_untouched_identical():
    E, d = 30, 4
    param, acc, _, _ = _state(7, E, d, 1)
    loc = np.array([2, 5, 17, E + 0, E + 1], np.int32)
    gsum = np.random.RandomState(7).randn(5, d).astype(np.float32)
    launches = tk.launches
    got_p, got_a = tk.fused_row_adagrad(torch.tensor(param), torch.tensor(acc),
                                        torch.tensor(loc), torch.tensor(gsum),
                                        0.05)
    assert tk.launches == launches          # the CPU runs the plain version
    untouched = sorted(set(range(E)) - {2, 5, 17})
    np.testing.assert_array_equal(got_p.numpy()[untouched], param[untouched])
    np.testing.assert_array_equal(got_a.numpy()[untouched], acc[untouched])
    assert not np.array_equal(got_p.numpy()[[2, 5, 17]], param[[2, 5, 17]])


def test_dense_apply_matches_jax():
    rng = np.random.RandomState(8)
    tree = {"rel": rng.randn(6, 4).astype(np.float32),
            "conv": {"w": rng.randn(3, 2).astype(np.float32)}}
    grads = {"rel": rng.randn(6, 4).astype(np.float32),
             "conv": {"w": rng.randn(3, 2).astype(np.float32)}}
    grads["rel"][1] = 0.0
    jtree = {"rel": jnp.asarray(tree["rel"]),
             "conv": {"w": jnp.asarray(tree["conv"]["w"])}}
    jg = {"rel": jnp.asarray(grads["rel"]),
          "conv": {"w": jnp.asarray(grads["conv"]["w"])}}
    want_p, want_a = jsa.dense_apply(jtree, jsa.init_acc(jtree), jg, 0.1)
    tt = {"rel": torch.tensor(tree["rel"]),
          "conv": {"w": torch.tensor(tree["conv"]["w"])}}
    tg = {"rel": torch.tensor(grads["rel"]),
          "conv": {"w": torch.tensor(grads["conv"]["w"])}}
    got_p, got_a = tsa.dense_apply(tt, tsa.init_acc(tt), tg, 0.1)
    np.testing.assert_allclose(got_p["rel"].numpy(), np.asarray(want_p["rel"]),
                               **TOL)
    np.testing.assert_allclose(got_a["conv"]["w"].numpy(),
                               np.asarray(want_a["conv"]["w"]), **TOL)
    np.testing.assert_array_equal(got_p["rel"].numpy()[1], tree["rel"][1])


def test_apply_kernel_wrapper_checks():
    p = torch.zeros(4, 3)
    a = torch.zeros(4, 3)
    g = torch.zeros(2, 3)
    with pytest.raises(TypeError):
        tk._check(p, a, torch.zeros(2, dtype=torch.int64), g)
    with pytest.raises(ValueError):
        tk._check(p, torch.zeros(5, 3), torch.zeros(2, dtype=torch.int32), g)
    with pytest.raises(ValueError):
        tk._check(p, a, torch.zeros(2, dtype=torch.int32), torch.zeros(3, 3))
    with pytest.raises(ValueError):
        tk._check(p, a, torch.zeros(2, dtype=torch.int32),
                  torch.zeros(3, 2).T)
    with pytest.raises(TypeError):
        tk._check(p.double(), a, torch.zeros(2, dtype=torch.int32), g)
