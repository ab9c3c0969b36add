"""Per-slot negative sampling and the per-slot relation view against the
JAX package on the CPU.

* The samplers' properties, in the style of
  tests/test_training_streams.py:16-49: the relation is never corrupted,
  at most one side changes, candidates stay in the KG's range, and with
  neighbor rows the corrupted entity's candidates come from its row.
* One per-slot rel_view step, in the uniform and the truncated epoch, on
  both Adagrad branches, with a keep mask and without, against a JAX step
  composed from the package's parts (``streams._make_stream_update`` with
  ``losses.lean_relation_logistic_loss``), from the same parameters,
  accumulators and injected candidates; rtol 3e-5 / atol 1e-6.
* The chunk scheme's Bloom keep masks equal the JAX package's for the same
  pools, and a chunk step with them matches a JAX step.
* Epoch-level: the JAX presample rule, the drop count, and the in-step
  resample path trains.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multike_tpu import losses as jl
from multike_tpu import params as jp
from multike_tpu import sampling as js
from multike_tpu.config import Config as JConfig
from multike_tpu.train import streams as jst
from multike_tpu_torch import params as tp
from multike_tpu_torch import sampling as ts
from multike_tpu_torch.config import Config
from multike_tpu_torch.train import streams as tst


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = dict(rtol=3e-5, atol=1e-6)
E, R, D = 40, 5, 8
RANGES = ((0, 20), (20, 40))
CFG = dict(dim=D, batch_size=32, neg_triple_num=3, learning_rate=0.05,
           neg_scheme="per_slot", truncated_neg_scheme="per_slot",
           neg_chunk_size=8, neg_pool_size=4)


def _rows(rng, n, lo, hi):
    return np.stack([rng.randint(lo, hi, n), rng.randint(0, R, n),
                     rng.randint(lo, hi, n)], 1)


# ---------------------------------------------------------------------------
# sampler properties
# ---------------------------------------------------------------------------

def test_sample_negatives_properties():
    pos = torch.as_tensor(np.array([[0, 0, 1], [2, 1, 3]] * 10))
    neg = ts.sample_negatives(torch.Generator().manual_seed(0), pos, 0, 10,
                              5).numpy()
    assert neg.shape == (100, 3) and neg.dtype == np.int64
    rep = np.repeat(pos.numpy(), 5, axis=0)
    assert np.array_equal(neg[:, 1], rep[:, 1])
    changed_h, changed_t = neg[:, 0] != rep[:, 0], neg[:, 2] != rep[:, 2]
    assert not np.any(changed_h & changed_t)
    assert neg[:, [0, 2]].min() >= 0 and neg[:, [0, 2]].max() < 10
    # per-row ranges: the second KG's rows draw from [10, 20)
    lo = torch.tensor([0, 10] * 10)
    neg = ts.sample_negatives(torch.Generator().manual_seed(1), pos + lo[:,
                              None] * torch.tensor([1, 0, 1]), lo, lo + 10,
                              4).numpy().reshape(20, 4, 3)
    assert neg[1::2, :, [0, 2]].min() >= 10
    assert neg[0::2, :, [0, 2]].max() < 10


def test_sample_corruptions_coins_and_neighbors():
    state = ts.build_neighbor_state(20, [(np.array([0, 1]),
                                          np.array([[5, 6, 7], [8, 9, 10]]))])
    pos = torch.as_tensor(np.array([[0, 0, 1]] * 400))
    cand, ch, keep = ts.sample_corruptions(torch.Generator().manual_seed(1),
                                           pos, 0, 20, 4, state)
    assert cand.shape == ch.shape == (400, 4) and keep is None
    assert ch.dtype == torch.bool and 0.45 < float(ch.float().mean()) < 0.55
    assert set(cand[ch].tolist()) <= {5, 6, 7}          # head 0's row
    assert set(cand[~ch].tolist()) <= {8, 9, 10}        # tail 1's row
    assert len(set(cand[ch].tolist())) == 3
    neg = ts.sample_negatives(torch.Generator().manual_seed(2), pos[:50], 0,
                              20, 4, state).numpy()
    assert set(neg[neg[:, 0] != 0][:, 0].tolist()) <= {5, 6, 7}
    assert set(neg[neg[:, 2] != 1][:, 2].tolist()) <= {8, 9, 10}
    # an entity with no row draws uniformly from [lo, hi)
    far = torch.as_tensor(np.array([[12, 0, 13]] * 200))
    cand, _, _ = ts.sample_corruptions(torch.Generator().manual_seed(3), far,
                                       10, 20, 4, state)
    assert int(cand.min()) >= 10 and int(cand.max()) < 20
    assert len(set(cand.reshape(-1).tolist())) > 5


def test_sample_neg_heads():
    state = ts.build_neighbor_state(20, [(np.array([3]),
                                          np.array([[11, 12]]))])
    heads = torch.tensor([3, 4, 3])
    got = ts.sample_neg_heads(torch.Generator().manual_seed(0), heads, 0, 10,
                              6, state).reshape(3, 6)
    assert set(got[0].tolist()) <= {11, 12} and set(got[2].tolist()) <= {
        11, 12}
    assert int(got[1].min()) >= 0 and int(got[1].max()) < 10
    plain = ts.sample_neg_heads(torch.Generator().manual_seed(0), heads,
                                torch.tensor([0, 10, 0]),
                                torch.tensor([5, 20, 5]), 6).reshape(3, 6)
    assert int(plain[1].min()) >= 10 and int(plain[[0, 2]].max()) < 5


# ---------------------------------------------------------------------------
# step parity
# ---------------------------------------------------------------------------

def _j_per_slot(epoch):
    K, sizes = epoch.neg_num, epoch.sizes
    bs1, bs2 = epoch.bs1, epoch.bs2

    def prep(pos1, m1, c1, hb1, k1, pos2, m2, c2, hb2, k2):
        return {"rv_ent": jnp.concatenate(
            [pos1[:, 0], pos1[:, 2], c1.ravel(), pos2[:, 0], pos2[:, 2],
             c2.ravel()])}, None

    def loss(rows, dense, stopped, aux, pos1, m1, c1, hb1, k1, pos2, m2, c2,
             hb2, k2):
        rv = jp.l2_normalize(rows["rv_ent"], axis=-1)
        prs = jp.lookup_norm_fast(dense["rel"], jnp.concatenate(
            [pos1[:, 1], pos2[:, 1]]))
        ph1, pt1, c1r, ph2, pt2, c2r = jst._split(rv, sizes)
        return (jl.lean_relation_logistic_loss(
                    ph1, prs[:bs1], pt1, c1r.reshape(bs1, K, D), hb1, m1,
                    neg_keep=k1)
                + jl.lean_relation_logistic_loss(
                    ph2, prs[bs1:], pt2, c2r.reshape(bs2, K, D), hb2, m2,
                    neg_keep=k2))
    return prep, loss


def _state(seed):
    rng = np.random.RandomState(seed)
    jparams = jp.init_params(JConfig(dim=D), E, R, 2)
    np_params = {k: np.asarray(jparams[k]) for k in ("rv_ent", "rel")}
    np_acc = {k: (0.1 + rng.rand(*v.shape)).astype(np.float32)
              for k, v in np_params.items()}
    return rng, np_params, np_acc


def _check_step(cfg, jcfg, step, jprep, jloss, batch, np_params, np_acc):
    jupdate = jax.jit(jst._make_stream_update(jcfg, "rel_view", jprep,
                                              jloss))
    jpar = {k: jnp.asarray(v) for k, v in np_params.items()}
    jacc = {k: jnp.asarray(v) for k, v in np_acc.items()}
    jpar, jacc, want = jupdate(jpar, jacc, *[
        None if x is None else jnp.asarray(x) for x in batch])
    params = tp.params_from_reference(np_params, device="cpu")
    acc = tp.opt_states_from_reference(np_acc, device="cpu")
    loss = step(params, acc, *[None if x is None else torch.as_tensor(x)
                               for x in batch])
    np.testing.assert_allclose(float(loss), float(want), **TOL)
    for k in ("rv_ent", "rel"):
        np.testing.assert_allclose(params[k].numpy(), np.asarray(jpar[k]),
                                   **TOL, err_msg=k)
        np.testing.assert_allclose(acc[k].numpy(), np.asarray(jacc[k]),
                                   **TOL, err_msg=k)
        assert not np.array_equal(params[k].numpy(), np_params[k])


@pytest.mark.parametrize("keep", ["mask", None])
@pytest.mark.parametrize("sparse", [True, False])
@pytest.mark.parametrize("with_neighbors", [False, True])
def test_per_slot_step_matches_jax(with_neighbors, sparse, keep):
    cfg = Config(row_sparse_updates=sparse, **CFG)
    jcfg = JConfig(row_sparse_updates=sparse, **CFG)
    n1, n2 = 90, 70
    epoch, steps, trained = tst.build_rel_view_epoch(
        cfg, n1, n2, RANGES, with_neighbors=with_neighbors)
    assert isinstance(epoch, tst.PerSlotRelViewEpoch)
    assert epoch.scheme == "per_slot" and epoch.presample
    _, jsteps, jtrained = jst.build_rel_view_epoch(
        jcfg, n1, n2, RANGES, with_neighbors=with_neighbors)
    assert (steps, trained) == (jsteps, jtrained)
    rng, np_params, np_acc = _state(int(with_neighbors) + 2 * int(sparse))
    K = cfg.neg_triple_num
    batch = []
    for bs, n_rows, (lo, hi) in ((epoch.bs1, epoch.bs1 - 3, RANGES[0]),
                                 (epoch.bs2, epoch.bs2, RANGES[1])):
        pos = _rows(rng, bs, lo, hi)
        kmask = (rng.rand(bs, K) > 0.3).astype(np.float32)
        batch += [pos, (np.arange(bs) < n_rows).astype(np.float32),
                  rng.randint(lo, hi, (bs, K)), rng.rand(bs, K) < 0.5,
                  kmask if keep else None]
    _check_step(cfg, jcfg, epoch.step, *_j_per_slot(epoch), batch, np_params,
                np_acc)


def _j_chunk_keep(tfilter, trip, ch, ct, nc, s):
    """The JAX package's chunk_keep_masks (streams.py:412-427)."""
    h, r, t = (trip[:, k].reshape(nc, s)[..., None] for k in range(3))
    bad_h = js.triple_filter_contains(tfilter, ch[:, None, :], r, t)
    bad_t = js.triple_filter_contains(tfilter, h, r, ct[:, None, :])
    return (1.0 - bad_h.astype(jnp.float32), 1.0 - bad_t.astype(jnp.float32))


@pytest.mark.parametrize("sparse", [True, False])
def test_chunk_exact_rejection_masks_and_step(sparse):
    kw = dict(CFG, neg_scheme="chunk_shared", chunk_exact_rejection=True)
    cfg = Config(row_sparse_updates=sparse, **kw)
    jcfg = JConfig(row_sparse_updates=sparse, **kw)
    rng, np_params, np_acc = _state(7)
    # a dense small graph, so the pools hit true triples
    true = np.concatenate([_rows(rng, 300, 0, 20), _rows(rng, 300, 20, 40)])
    tf = ts.build_triple_filter(true, log2m=14)
    jtf = js.build_triple_filter(true.astype(np.int32), log2m=14)
    epoch, _, _ = tst.build_rel_view_epoch(cfg, 90, 70, RANGES, tfilter=tf)
    assert isinstance(epoch, tst.RelViewEpoch) and epoch.tfilter is tf
    batch, want_keep = [], []
    for nc, s, (lo, hi), src in ((epoch.nc1, epoch.s1, RANGES[0], true[:300]),
                                 (epoch.nc2, epoch.s2, RANGES[1],
                                  true[300:])):
        pos = src[rng.randint(0, 300, nc * s)]
        ch = rng.randint(lo, hi, (nc, epoch.pool))
        ct = rng.randint(lo, hi, (nc, epoch.pool))
        got = epoch.chunk_keep_masks(torch.as_tensor(pos),
                                     torch.as_tensor(ch),
                                     torch.as_tensor(ct), nc, s)
        want = _j_chunk_keep(jtf, jnp.asarray(pos, jnp.int32),
                             jnp.asarray(ch, jnp.int32),
                             jnp.asarray(ct, jnp.int32), nc, s)
        for g, w in zip(got, want):
            assert g.shape == (nc, s, epoch.pool)
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert float(got[0].mean()) < 1.0 or float(got[1].mean()) < 1.0
        want_keep.append(want)
        batch += [pos, (np.arange(nc * s) < nc * s - 2).astype(np.float32),
                  ch, ct]

    sizes, pool = epoch.sizes, epoch.pool
    lay = ((epoch.nc1, epoch.s1), (epoch.nc2, epoch.s2))

    def jprep(pos1, m1, ch1, ct1, pos2, m2, ch2, ct2):
        return {"rv_ent": jnp.concatenate(
            [pos1[:, 0], pos1[:, 2], ch1.ravel(), ct1.ravel(), pos2[:, 0],
             pos2[:, 2], ch2.ravel(), ct2.ravel()])}, None

    def jloss(rows, dense, stopped, aux, pos1, m1, ch1, ct1, pos2, m2, ch2,
              ct2):
        rv = jp.l2_normalize(rows["rv_ent"], axis=-1)
        prs = jp.lookup_norm_fast(dense["rel"], jnp.concatenate(
            [pos1[:, 1], pos2[:, 1]]))
        parts = jst._split(rv, sizes)
        out = 0.0
        for (nc, s), (ph, pt, chr_, ctr), pr, m, (kh, kt) in (
                (lay[0], parts[:4], prs[:pos1.shape[0]], m1, want_keep[0]),
                (lay[1], parts[4:], prs[pos1.shape[0]:], m2, want_keep[1])):
            out = out + jl.chunk_shared_relation_logistic_loss(
                ph.reshape(nc, s, D), pr.reshape(nc, s, D),
                pt.reshape(nc, s, D), chr_.reshape(nc, pool, D),
                ctr.reshape(nc, pool, D), neg_weight=epoch.neg_w,
                pos_mask=m.reshape(nc, s), keep_h=kh, keep_t=kt)
        return out

    _check_step(cfg, jcfg, epoch.step, jprep, jloss, batch, np_params,
                np_acc)


# ---------------------------------------------------------------------------
# epochs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,tries,with_filter,presample", [
    ("drop", 10, True, True), ("resample", 10, True, False),
    ("resample", 0, True, True), ("resample", 10, False, True)])
def test_presample_rule_matches_jax(mode, tries, with_filter, presample):
    """streams.py:437-439: in-step sampling only for a filter, tries > 0
    and "resample"."""
    cfg = Config(neg_reject_mode=mode, neg_rejection_tries=tries, **CFG)
    tf = ts.build_triple_filter(_rows(np.random.RandomState(0), 50, 0, 40),
                                log2m=12) if with_filter else None
    epoch, _, _ = tst.build_rel_view_epoch(cfg, 90, 70, RANGES, tfilter=tf)
    assert epoch.presample == presample


def test_per_slot_epochs_train_and_count_drops():
    rng = np.random.RandomState(0)
    t1 = torch.as_tensor(_rows(rng, 200, 0, 20))
    t2 = torch.as_tensor(_rows(rng, 150, 20, 40))
    tf = ts.build_triple_filter(torch.cat([t1, t2]).numpy(), log2m=14)
    nbr = ts.build_neighbor_state(E, [
        (np.arange(0, 20), rng.randint(0, 20, (20, 4))),
        (np.arange(20, 40), rng.randint(20, 40, (20, 4)))])
    for mode, with_nbr in (("drop", False), ("drop", True),
                           ("resample", False), ("resample", True)):
        cfg = Config(neg_reject_mode=mode, **CFG)
        params = tp.init_params(cfg, E, R, 2, device="cpu")
        opt = tst.init_stream_opt_states(cfg, params)["rel_view"]
        epoch, steps, trained = tst.build_rel_view_epoch(
            cfg, 200, 150, RANGES, with_neighbors=with_nbr, tfilter=tf)
        gen = torch.Generator().manual_seed(0)
        if mode == "drop":
            xs = epoch.draw(gen, t1, t2, nbr)
            pos1, m1, c1, hb1, k1 = xs[:5]
            assert c1.shape == hb1.shape == k1.shape == (steps, epoch.bs1, 3)
            assert int(c1.min()) >= 0 and int(c1.max()) < 20
            assert int(xs[7].min()) >= 20
            # a drop is exactly a slot whose assembled negative tests true
            neg_h = torch.where(hb1, c1, pos1[..., :1])
            neg_t = torch.where(hb1, pos1[..., 2:], c1)
            hits = ts.triple_filter_contains(tf, neg_h, pos1[..., 1:2], neg_t)
            assert torch.equal(k1 == 0, hits)
            dropped = float(epoch.dropped)
            assert 0 < dropped < epoch.slots == trained * 3
        losses = [float(epoch(params, opt, gen, t1, t2, nbr))
                  for _ in range(5)]
        assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
        assert (epoch.dropped is None) == (mode == "resample")
    with pytest.raises(ValueError):
        tst.build_rel_view_epoch(cfg, 200, 150, RANGES, with_neighbors=True,
                                 tfilter=tf)[0].draw(gen, t1, t2, None)
    with pytest.raises(ValueError):
        tst.build_rel_view_epoch(Config(**dict(CFG, neg_reject_mode="x")),
                                 200, 150, RANGES)
