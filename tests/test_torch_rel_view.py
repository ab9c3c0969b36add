"""The PyTorch port's relation-view step against a JAX step composed from
the JAX package's public parts, on the row-sparse and the dense-Adagrad
branch, plus the epoch-level invariants of the port's draws.

Both sides start from the same parameters (``params_from_reference``) and
accumulators (``opt_states_from_reference``) and get the same injected
positives, masks and chunk pools. Tolerance rtol 3e-5 / atol 1e-6, that of
the JAX package's own row-sparse-vs-dense epoch test."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multike_tpu import losses as jl
from multike_tpu import params as jp
from multike_tpu.config import Config as JConfig
from multike_tpu.train import sparse_adagrad as jsa
from multike_tpu.train import streams as jst
from multike_tpu_torch import params as tp
from multike_tpu_torch.config import Config
from multike_tpu_torch.train import streams as tst

TOL = dict(rtol=3e-5, atol=1e-6)
E, R = 40, 5
RANGES = ((0, 20), (20, 40))
CFG = dict(dim=8, batch_size=32, neg_triple_num=3, learning_rate=0.05,
           neg_chunk_size=8, neg_pool_size=4)


def _jax_step(cfg, params, acc, batch, sparse, layout):
    """gather -> l2_normalize -> lookup_norm_fast(rel) -> chunk loss ->
    value_and_grad -> row_apply / dense_apply, as streams.py composes it."""
    pos1, m1, ch1, ct1, pos2, m2, ch2, ct2 = batch
    (bs1, nc1, s1), (bs2, nc2, s2), pool = layout
    neg_w = cfg.neg_triple_num / (2.0 * pool)
    ids = jnp.concatenate([pos1[:, 0], pos1[:, 2], ch1.ravel(), ct1.ravel(),
                           pos2[:, 0], pos2[:, 2], ch2.ravel(), ct2.ravel()])
    sizes = [nc1 * s1, nc1 * s1, nc1 * pool, nc1 * pool,
             nc2 * s2, nc2 * s2, nc2 * pool, nc2 * pool]

    def loss_fn(rows, rel):
        d = rows.shape[-1]
        rv = jp.l2_normalize(rows, axis=-1)
        prs = jp.lookup_norm_fast(rel, jnp.concatenate([pos1[:, 1],
                                                        pos2[:, 1]]))
        prs1, prs2 = prs[:pos1.shape[0]], prs[pos1.shape[0]:]
        parts = jst._split(rv, sizes)
        loss = 0.0
        for (bs, nc, s), (ph, pt, chr_, ctr), pr, m in (
                ((bs1, nc1, s1), parts[:4], prs1, m1),
                ((bs2, nc2, s2), parts[4:], prs2, m2)):
            if bs > 0:
                loss = loss + jl.chunk_shared_relation_logistic_loss(
                    ph.reshape(nc, s, d), pr.reshape(nc, s, d),
                    pt.reshape(nc, s, d), chr_.reshape(nc, pool, d),
                    ctr.reshape(nc, pool, d), neg_weight=neg_w,
                    pos_mask=m.reshape(nc, s))
        return loss

    lr = cfg.learning_rate
    if sparse:
        loss, (g_rows, g_rel) = jax.value_and_grad(loss_fn, argnums=(0, 1))(
            params["rv_ent"][ids], params["rel"])
        rv, acc_rv = jsa.row_apply(params["rv_ent"], acc["rv_ent"], ids,
                                   g_rows, lr)
    else:
        loss, (g_rv, g_rel) = jax.value_and_grad(
            lambda t, rel: loss_fn(t[ids], rel), argnums=(0, 1))(
                params["rv_ent"], params["rel"])
        rv, acc_rv = jsa.dense_apply(params["rv_ent"], acc["rv_ent"], g_rv,
                                     lr)
    rel, acc_rel = jsa.dense_apply(params["rel"], acc["rel"], g_rel, lr)
    return float(loss), {"rv_ent": rv, "rel": rel}, \
        {"rv_ent": acc_rv, "rel": acc_rel}


def _batch(rng, epoch, n1_rows, n2_rows):
    def pos(n, lo, hi, fill):
        p = np.stack([rng.randint(lo, hi, n), rng.randint(0, R, n),
                      rng.randint(lo, hi, n)], 1)
        p[fill:] = 0                         # chunk padding slots
        return p

    m1 = (np.arange(epoch.bsp1) < n1_rows).astype(np.float32)
    m2 = (np.arange(epoch.bsp2) < n2_rows).astype(np.float32)
    (lo1, hi1), (lo2, hi2) = RANGES
    return [pos(epoch.bsp1, lo1, hi1, n1_rows), m1,
            rng.randint(lo1, hi1, (epoch.nc1, epoch.pool)),
            rng.randint(lo1, hi1, (epoch.nc1, epoch.pool)),
            pos(epoch.bsp2, lo2, hi2, n2_rows), m2,
            rng.randint(lo2, hi2, (epoch.nc2, epoch.pool)),
            rng.randint(lo2, hi2, (epoch.nc2, epoch.pool))]


@pytest.mark.parametrize("sparse", [True, False])
def test_rel_view_step_matches_jax(sparse):
    n1, n2 = 90, 70
    cfg = Config(row_sparse_updates=sparse, **CFG)
    jcfg = JConfig(row_sparse_updates=sparse, **CFG)
    epoch, steps, trained = tst.build_rel_view_epoch(cfg, n1, n2, RANGES)
    bs1, bs2 = jst.proportional_sizes(n1, n2, cfg.batch_size)
    (nc1, s1), (nc2, s2) = (jst._chunk_layout(bs1, cfg.neg_chunk_size),
                            jst._chunk_layout(bs2, cfg.neg_chunk_size))
    assert (epoch.bs1, epoch.nc1, epoch.s1) == (bs1, nc1, s1)
    assert (epoch.bs2, epoch.nc2, epoch.s2) == (bs2, nc2, s2)
    _, jsteps, jtrained = jst.build_rel_view_epoch(jcfg, n1, n2, RANGES,
                                                   with_neighbors=False)
    assert (steps, trained) == (jsteps, jtrained)
    assert tst.use_row_sparse(cfg, E, 1) == sparse

    jparams = jp.init_params(jcfg, E, R, 2)
    rng = np.random.RandomState(0)
    np_params = {k: np.asarray(v) for k, v in jparams.items()
                 if k in ("rv_ent", "rel")}
    np_acc = {k: (0.1 + rng.rand(*v.shape)).astype(np.float32)
              for k, v in np_params.items()}
    params = tp.params_from_reference(np_params, device="cpu")
    acc = tp.opt_states_from_reference(np_acc, device="cpu")
    jpar = {k: jnp.asarray(v) for k, v in np_params.items()}
    jacc = {k: jnp.asarray(v) for k, v in np_acc.items()}
    layout = ((bs1, nc1, s1), (bs2, nc2, s2), epoch.pool)

    # two steps: a full one, then one with a masked tail
    for n1_rows, n2_rows in ((bs1, bs2), (bs1 - 3, bs2 - 5)):
        b = _batch(rng, epoch, n1_rows, n2_rows)
        want_loss, jpar, jacc = _jax_step(
            jcfg, jpar, jacc, [jnp.asarray(x) for x in b], sparse, layout)
        tb = [torch.as_tensor(x) for x in b]
        tb = [x.long() if x.dtype == torch.int64 else x for x in tb]
        loss = epoch.step(params, acc, *tb)
        np.testing.assert_allclose(float(loss), want_loss, **TOL)
        for k in ("rv_ent", "rel"):
            np.testing.assert_allclose(params[k].numpy(),
                                       np.asarray(jpar[k]), **TOL, err_msg=k)
            np.testing.assert_allclose(acc[k].numpy(), np.asarray(jacc[k]),
                                       **TOL, err_msg=k)


def test_ckge_rel_step_matches_jax():
    """The swapped-supervision stream of the relation view: positives only,
    loss weight 2, one fused entity gather and one row-sparse apply."""
    cfg = Config(row_sparse_updates=True, **CFG)
    jparams = jp.init_params(JConfig(**CFG), E, R, 2)
    np_params = {k: np.asarray(jparams[k]) for k in ("rv_ent", "rel")}
    rng = np.random.RandomState(1)
    pos = np.stack([rng.randint(0, E, 24), rng.randint(0, R, 24),
                    rng.randint(0, E, 24)], 1)
    epoch, steps, trained = tst.build_ckge_rel_epoch(cfg, 24)
    assert (steps, trained) == (1, 24)

    jpos = jnp.asarray(pos)
    ids = jnp.concatenate([jpos[:, 0], jpos[:, 2]])

    def loss_fn(rows, rel):
        h = jp.l2_normalize(rows, axis=-1)
        prs = jp.lookup_norm_fast(rel, jpos[:, 1])
        return 2.0 * jl.relation_logistic_loss_wo_negs(h[:24], prs, h[24:])

    jv = {k: jnp.asarray(v) for k, v in np_params.items()}
    jacc = jsa.init_acc(jv)
    want, (g_rows, g_rel) = jax.value_and_grad(loss_fn, argnums=(0, 1))(
        jv["rv_ent"][ids], jv["rel"])
    want_rv, _ = jsa.row_apply(jv["rv_ent"], jacc["rv_ent"], ids, g_rows,
                               cfg.learning_rate)
    want_rel, _ = jsa.dense_apply(jv["rel"], jacc["rel"], g_rel,
                                  cfg.learning_rate)

    params = tp.params_from_reference(np_params, device="cpu")
    acc = tst.init_stream_opt_states(cfg, {**params, **{
        k: torch.zeros(1) for k in ("av_ent", "attr", "ent", "nv_mapping",
                                    "rv_mapping", "av_mapping", "conv_av",
                                    "conv_ckge", "conv_ckga")}})["ckge_rel"]
    loss = epoch.step(params, acc, torch.as_tensor(pos))
    np.testing.assert_allclose(float(loss), float(want), **TOL)
    np.testing.assert_allclose(params["rv_ent"].numpy(), np.asarray(want_rv),
                               **TOL)
    np.testing.assert_allclose(params["rel"].numpy(), np.asarray(want_rel),
                               **TOL)


@pytest.mark.parametrize("n,bs,bsp,steps", [(90, 18, 24, 5), (10, 4, 4, 3),
                                            (7, 3, 5, 4)])
def test_padded_epoch_indices_invariants(n, bs, bsp, steps):
    gen = torch.Generator().manual_seed(3)
    idx, m = tst._padded_epoch_indices(gen, n, bs, bsp, steps)
    jidx, jm = jst._padded_epoch_indices(jax.random.PRNGKey(0), n, bs, bsp,
                                         steps)
    assert idx.shape == (steps, bsp) and m.shape == (steps, bsp)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))  # same masks
    mm = m.numpy()
    assert (np.diff(mm, axis=1) <= 0).all()      # 1s then 0s in every row
    assert (mm[:, bs:] == 0).all()               # chunk padding masked
    assert mm.sum() == min(n, steps * bs)        # tail masked
    real = idx.numpy()[:, :bs].reshape(-1)[:min(n, steps * bs)]
    assert len(set(real.tolist())) == len(real)  # no repeat within an epoch
    assert set(real.tolist()) <= set(range(n))


def test_epoch_pools_in_range_and_sparse_equals_dense():
    rng = np.random.RandomState(1)
    t1 = np.stack([rng.randint(0, 20, 90), rng.randint(0, R, 90),
                   rng.randint(0, 20, 90)], 1)
    t2 = np.stack([rng.randint(20, 40, 70), rng.randint(0, R, 70),
                   rng.randint(20, 40, 70)], 1)
    t1, t2 = torch.as_tensor(t1), torch.as_tensor(t2)
    epoch, steps, _ = tst.build_rel_view_epoch(Config(**CFG), 90, 70, RANGES)
    xs = epoch.draw(torch.Generator().manual_seed(0), t1, t2)
    pos1, m1, ch1, ct1, pos2, m2, ch2, ct2 = xs
    assert ch1.shape == (steps, epoch.nc1, epoch.pool)
    for pool, (lo, hi) in ((ch1, RANGES[0]), (ct1, RANGES[0]),
                           (ch2, RANGES[1]), (ct2, RANGES[1])):
        assert int(pool.min()) >= lo and int(pool.max()) < hi
    assert int(pos1[..., 0].max()) < 20 and int(pos2[..., 0].min()) >= 20

    jparams = jp.init_params(JConfig(**CFG), E, R, 2)
    results = []
    for sparse in (True, False):
        cfg = Config(row_sparse_updates=sparse, **CFG)
        ep, _, _ = tst.build_rel_view_epoch(cfg, 90, 70, RANGES)
        params = tp.params_from_reference(
            {k: np.asarray(jparams[k]) for k in ("rv_ent", "rel")},
            device="cpu")
        acc = {k: torch.full_like(v, 0.1) for k, v in params.items()}
        gen = torch.Generator().manual_seed(7)
        losses = [float(ep(params, acc, gen, t1, t2)) for _ in range(2)]
        results.append((params, losses))
    for k in ("rv_ent", "rel"):
        np.testing.assert_allclose(results[0][0][k].numpy(),
                                   results[1][0][k].numpy(), **TOL)
    np.testing.assert_allclose(results[0][1], results[1][1], rtol=1e-4)


@pytest.mark.parametrize("kw,build_kw", [
    (dict(neg_scheme="per_slot"), {}),
    (dict(chunk_exact_rejection=True), {}),
    (dict(truncated_neg_scheme="per_slot"), dict(with_neighbors=True)),
])
def test_later_slices_raise(kw, build_kw):
    """These configurations raised until per-slot sampling and the Bloom
    filter were ported; now each builds and trains one finite step."""
    from multike_tpu_torch.sampling import (build_neighbor_state,
                                            build_triple_filter)

    rng = np.random.RandomState(4)
    t1 = np.stack([rng.randint(0, 20, 90), rng.randint(0, R, 90),
                   rng.randint(0, 20, 90)], 1)
    t2 = np.stack([rng.randint(20, 40, 70), rng.randint(0, R, 70),
                   rng.randint(20, 40, 70)], 1)
    tf = build_triple_filter(np.concatenate([t1, t2]), log2m=14)
    cfg = Config(**CFG, **kw)
    epoch, steps, _ = tst.build_rel_view_epoch(cfg, 90, 70, RANGES,
                                               tfilter=tf, **build_kw)
    assert epoch.scheme == ("chunk_shared" if "chunk_exact_rejection" in kw
                            else "per_slot")
    nbr = build_neighbor_state(E, [(np.arange(E), rng.randint(0, 20, (E, 3))
                                    + 20 * (np.arange(E)[:, None] >= 20))])
    jparams = jp.init_params(JConfig(**CFG), E, R, 2)
    params = tp.params_from_reference(
        {k: np.asarray(jparams[k]) for k in ("rv_ent", "rel")}, device="cpu")
    before = params["rv_ent"].clone()
    acc = {k: torch.full_like(v, 0.1) for k, v in params.items()}
    xs = epoch.draw(torch.Generator().manual_seed(0), torch.as_tensor(t1),
                    torch.as_tensor(t2), nbr)
    loss = epoch.step(params, acc, *(x[0] for x in xs))
    assert np.isfinite(float(loss)) and float(loss) > 0
    assert not torch.equal(params["rv_ent"], before)
