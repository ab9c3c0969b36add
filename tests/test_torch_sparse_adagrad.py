"""The PyTorch port's row-sparse Adagrad and K1's wrapper ``row_adagrad`` on
the CPU (its plain version) against the JAX package: ``row_apply`` with and
without its Pallas kernel (in interpret mode), and the plain version
``row_adagrad_plain`` on ``(ids, g_rows)`` against the JAX package's sort,
segment-sum and ``fused_row_adagrad_pallas``.

Tolerance rtol 2e-6 / atol 1e-7 (one rsqrt and a few float32 products per
element); rows the step does not touch stay bit-identical and ids outside
the table do nothing."""
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
                                 torch.tensor(g_rows), 0.05, row_offset=off)
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


@pytest.mark.parametrize("seed,E,d,N", [(4, 40, 8, 23), (5, 64, 75, 100),
                                        (6, 30, 4, 40)])
def test_apply_kernel_plain_matches_pallas(seed, E, d, N):
    """K1's plain version on ``(ids, g_rows)`` against the JAX package's
    sort and segment-sum, then its Pallas kernel in interpret mode."""
    param, acc, ids, g_rows = _state(seed, E, d, N)
    assert len(np.unique(ids)) < N           # duplicates present
    loc, gsum = _jax_dedup(ids, g_rows, E)
    want_p, want_a = fused_row_adagrad_pallas(
        jnp.asarray(param), jnp.asarray(acc), jnp.asarray(loc),
        jnp.asarray(gsum), 0.1, bl=8, interpret=True)
    got_p, got_a = tk.row_adagrad_plain(
        torch.tensor(param), torch.tensor(acc), torch.tensor(ids).long(),
        torch.tensor(g_rows), 0.1)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **TOL)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), **TOL)


def test_apply_kernel_sentinels_dropped_untouched_identical():
    """Ids outside ``[row_offset, row_offset + rows)`` leave those rows and
    accumulators bitwise untouched: the step is bitwise the step of the ids
    inside alone."""
    E, d, off = 30, 4, 10
    param, acc, _, _ = _state(7, E, d, 1)
    ids = np.array([12, 3, 15, 40, 27, 9, 15, 55, 0, 39], np.int64)
    g_rows = np.random.RandomState(7).randn(len(ids), d).astype(np.float32)
    got_p, got_a = tk.row_adagrad_plain(
        torch.tensor(param), torch.tensor(acc), torch.tensor(ids),
        torch.tensor(g_rows), 0.05, row_offset=off)
    inside = (ids >= off) & (ids < off + E)
    want_p, want_a = tk.row_adagrad_plain(
        torch.tensor(param), torch.tensor(acc), torch.tensor(ids[inside]),
        torch.tensor(g_rows[inside]), 0.05, row_offset=off)
    assert torch.equal(got_p, want_p) and torch.equal(got_a, want_a)
    touched = [2, 5, 17, 29]
    untouched = sorted(set(range(E)) - set(touched))
    np.testing.assert_array_equal(got_p.numpy()[untouched], param[untouched])
    np.testing.assert_array_equal(got_a.numpy()[untouched], acc[untouched])
    assert (got_p.numpy()[touched] != param[touched]).any(axis=1).all()


def _ids_case(name):
    """(E, d, ids, row_offset, total_rows) of one new case."""
    rng = np.random.RandomState(20 + ID_CASES.index(name))
    if name == "hub40":                 # one row 40 times among others
        ids = np.r_[rng.randint(0, 64, 100), np.full(40, 7)]
        return 64, 8, rng.permutation(ids), 0, None
    if name == "hub2000":
        ids = np.r_[np.full(2000, 5), np.arange(64)]
        return 64, 8, rng.permutation(ids), 0, None
    if name == "offset":                # a shard [10, 26) of 40 rows
        return 16, 6, rng.randint(0, 40, 60), 10, 40
    if name == "out_of_range":          # no id in the shard
        ids = np.r_[rng.randint(0, 10, 20), rng.randint(26, 50, 20)]
        return 16, 6, ids, 10, 50
    d = {"d1": 1, "d75": 75, "d384": 384}[name]
    return 64, d, rng.randint(0, 64, 150), 0, None


ID_CASES = ("hub40", "hub2000", "offset", "out_of_range", "d1", "d75",
            "d384")


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("case", ID_CASES)
def test_row_adagrad_matches_jax_row_apply(case, use_pallas):
    """K1's wrapper on the CPU against JAX ``row_apply``, with its Pallas
    kernel interpreted and without it: hub rows, a row shard with ids
    below and above it or none in it, and d = 1, 75, 384."""
    E, d, ids, off, total = _ids_case(case)
    rng = np.random.RandomState(len(ids))
    param = rng.randn(E, d).astype(np.float32)
    acc = (0.1 + rng.rand(E, d)).astype(np.float32)
    g_rows = rng.randn(len(ids), d).astype(np.float32)
    want_p, want_a = jsa.row_apply(
        jnp.asarray(param), jnp.asarray(acc), jnp.asarray(ids),
        jnp.asarray(g_rows), 0.1, row_offset=off, total_rows=total,
        use_pallas=use_pallas)
    launches = tk.launches
    got_p, got_a = tk.row_adagrad(torch.tensor(param), torch.tensor(acc),
                                  torch.tensor(ids).long(),
                                  torch.tensor(g_rows), 0.1, row_offset=off)
    assert tk.launches == launches          # the CPU runs the plain version
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **TOL)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), **TOL)
    local = ids - off
    untouched = sorted(set(range(E)) - set(local.tolist()))
    np.testing.assert_array_equal(got_p.numpy()[untouched], param[untouched])
    np.testing.assert_array_equal(got_a.numpy()[untouched], acc[untouched])
    if case == "out_of_range":
        assert len(untouched) == E


def test_row_adagrad_empty_step_leaves_tables():
    """N = 0: JAX ``row_apply`` refuses an empty step (its segment-sum
    cannot broadcast zero rows); the port's leaves both tables as they
    are."""
    param, acc, _, _ = _state(12, 20, 6, 1)
    p, a = torch.tensor(param), torch.tensor(acc)
    got_p, got_a = tk.row_adagrad(p, a, torch.zeros(0, dtype=torch.int64),
                                  torch.zeros(0, 6), 0.1)
    assert got_p is p and got_a is a
    np.testing.assert_array_equal(p.numpy(), param)
    np.testing.assert_array_equal(a.numpy(), acc)


def test_row_apply_is_row_adagrad_bitwise():
    """``sparse_adagrad.row_apply`` is K1's wrapper, bit for bit, and so is
    the plain version it runs on the CPU."""
    param, acc, ids, g_rows = _state(13, 50, 75, 400)
    outs = []
    for fn in (tsa.row_apply, tk.row_adagrad, tk.row_adagrad_plain):
        p, a = torch.tensor(param), torch.tensor(acc)
        fn(p, a, torch.tensor(ids).long(), torch.tensor(g_rows), 0.1)
        outs.append((p, a))
    for p, a in outs[1:]:
        assert torch.equal(p, outs[0][0]) and torch.equal(a, outs[0][1])


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
    """The dtypes, shapes and devices ``row_adagrad`` refuses."""
    p = torch.zeros(4, 3)
    a = torch.zeros(4, 3)
    ids = torch.zeros(2, dtype=torch.int64)
    g = torch.zeros(2, 3)
    with pytest.raises(TypeError):                      # ids int32
        tk.row_adagrad(p, a, ids.int(), g, 0.1)
    with pytest.raises(TypeError):                      # float64 param
        tk.row_adagrad(p.double(), a, ids, g, 0.1)
    with pytest.raises(TypeError):                      # float64 g_rows
        tk.row_adagrad(p, a, ids, g.double(), 0.1)
    with pytest.raises(ValueError):                     # acc of another shape
        tk.row_adagrad(p, torch.zeros(5, 3), ids, g, 0.1)
    with pytest.raises(ValueError):                     # g_rows not (n, d)
        tk.row_adagrad(p, a, ids, torch.zeros(3, 3), 0.1)
    with pytest.raises(ValueError):                     # ids not (n,)
        tk.row_adagrad(p, a, ids[:, None], g, 0.1)
    with pytest.raises(ValueError):                     # ids on another device
        tk.row_adagrad(p, a, ids.to("meta"), g, 0.1)
    with pytest.raises(ValueError):                     # no kernel for meta
        tk.row_adagrad(p.to("meta"), a.to("meta"), ids.to("meta"),
                       g.to("meta"), 0.1)
