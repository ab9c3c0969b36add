"""The port's ITC streams against the JAX package on the CPU.

One step of attr_view, ckge_attr, ckga_attr, ckgp_rel, common_space and the
truncated rel_view, from the same parameters, accumulators and injected
batches (and pools), against a JAX step composed from the package's parts
(``streams._make_stream_update`` with the JAX losses and conv scorer), on
the row-sparse and the dense-Adagrad branch, and the attribute streams
and common_space at d = 384 too; tolerance rtol 3e-5 / atol 1e-6, as in
tests/test_torch_rel_view.py. Then the neighbor refresh
against the JAX exact top-k (per-row sets), the neighbor-pool sampler's
source properties (tests/test_neg_schemes.py) and the epochs' step counts.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multike_tpu import losses as jl
from multike_tpu import params as jp
from multike_tpu.config import Config as JConfig
from multike_tpu.train import streams as jst
from multike_tpu.train import trainer as jtr
from multike_tpu.views.attr_conv import conv_score as jconv_score
from multike_tpu_torch import params as tp
from multike_tpu_torch.config import Config
from multike_tpu_torch.sampling import (build_neighbor_state,
                                        sample_shared_neighbor_corruptions)
from multike_tpu_torch.train import streams as tst
from multike_tpu_torch.train import trainer as ttr

TOL = dict(rtol=3e-5, atol=1e-6)
E, R, A, L, D = 40, 5, 4, 30, 8
RANGES = ((0, 20), (20, 40))
CFG = dict(dim=D, batch_size=32, attribute_batch_size=24,
           entity_batch_size=16, neg_triple_num=3, learning_rate=0.05,
           ITC_learning_rate=0.02, truncated_chunk_size=8,
           truncated_pool_size=6, neg_chunk_size=16, neg_pool_size=4)


# ---------------------------------------------------------------------------
# JAX losses, composed from the package's parts
# ---------------------------------------------------------------------------

def _j_conv(conv):
    def loss(rows, dense, stopped, aux, constants, trip, *rest):
        phs = jp.l2_normalize(rows["av_ent"], axis=-1)
        pas = dense["attr"][trip[:, 1]]
        pvs = constants["literal_embeds"][trip[:, 2]]
        if conv == "conv_av":
            w, mask = rest
            score = jconv_score(dense[conv], phs, pas, pvs, mask=mask)
            return jl.positive_logistic_from_scores(score, weights=w,
                                                    mask=mask)
        score = jconv_score(dense[conv], phs, pas, pvs)
        if conv == "conv_ckge":
            return 2.0 * jl.positive_logistic_from_scores(score)
        return jl.positive_logistic_from_scores(score, weights=rest[0])
    return lambda constants, trip, *rest: ({"av_ent": trip[:, 0]}, None), loss


def _j_ckgp():
    def loss(rows, dense, stopped, aux, pos, w):
        h = jp.l2_normalize(rows["rv_ent"], axis=-1)
        prs = jp.lookup_norm_fast(dense["rel"], pos[:, 1])
        return 2.0 * jl.logistic_loss_wo_negs(h[:pos.shape[0]], prs,
                                              h[pos.shape[0]:], w)
    return (lambda pos, w: ({"rv_ent": jnp.concatenate([pos[:, 0],
                                                        pos[:, 2]])}, None),
            loss)


def _j_common(cfg):
    def loss(rows, dense, stopped, aux, constants, ents):
        final = jp.l2_normalize(rows["ent"], axis=-1)
        out = cfg.cv_name_weight * jl.alignment_loss(
            final, constants["name_embeds"][ents])
        out += jl.alignment_loss(final, jp.l2_normalize(rows["rv_ent"], -1))
        out += jl.alignment_loss(final, jp.l2_normalize(rows["av_ent"], -1))
        return cfg.cv_weight * out
    return (lambda constants, ents: ({"ent": ents, "rv_ent": ents,
                                      "av_ent": ents}, None), loss)


def _j_rel_view(epoch):
    sizes, pool = epoch.sizes, epoch.pool
    layout = ((epoch.bs1, epoch.nc1, epoch.s1), (epoch.bs2, epoch.nc2,
                                                 epoch.s2))

    def prep(pos1, m1, ch1, ct1, pos2, m2, ch2, ct2):
        return {"rv_ent": jnp.concatenate(
            [pos1[:, 0], pos1[:, 2], ch1.ravel(), ct1.ravel(),
             pos2[:, 0], pos2[:, 2], ch2.ravel(), ct2.ravel()])}, None

    def loss(rows, dense, stopped, aux, pos1, m1, ch1, ct1, pos2, m2, ch2,
             ct2):
        rv = jp.l2_normalize(rows["rv_ent"], axis=-1)
        prs = jp.lookup_norm_fast(dense["rel"], jnp.concatenate(
            [pos1[:, 1], pos2[:, 1]]))
        parts = jst._split(rv, sizes)
        out = 0.0
        for (bs, nc, s), (ph, pt, chr_, ctr), pr, m in (
                (layout[0], parts[:4], prs[:pos1.shape[0]], m1),
                (layout[1], parts[4:], prs[pos1.shape[0]:], m2)):
            if bs > 0:
                out = out + jl.chunk_shared_relation_logistic_loss(
                    ph.reshape(nc, s, D), pr.reshape(nc, s, D),
                    pt.reshape(nc, s, D), chr_.reshape(nc, pool, D),
                    ctr.reshape(nc, pool, D), neg_weight=epoch.neg_w,
                    pos_mask=m.reshape(nc, s))
        return out
    return prep, loss


# ---------------------------------------------------------------------------
# step parity
# ---------------------------------------------------------------------------

def _state(rng, d=D):
    jparams = jp.init_params(JConfig(dim=d), E, R, A)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    np_acc = jax.tree_util.tree_map(
        lambda x: (0.1 + rng.rand(*x.shape)).astype(np.float32), np_params)
    consts = {"name_embeds": rng.normal(size=(E, d)).astype(np.float32),
              "literal_embeds": rng.normal(size=(L, d)).astype(np.float32)}
    consts["name_embeds"] /= np.linalg.norm(consts["name_embeds"], axis=1,
                                            keepdims=True)
    return np_params, np_acc, consts


def _trip(rng, n, hi_ent, hi_rel, hi_tail):
    return np.stack([rng.randint(0, hi_ent, n), rng.randint(0, hi_rel, n),
                     rng.randint(0, hi_tail, n)], 1)


def _case(stream, cfg, jcfg, rng):
    """(port step, JAX (prep, loss), batch as numpy, uses constants)."""
    w = (0.2 + rng.rand(20)).astype(np.float32)
    if stream == "attr_view":
        epoch, _, _ = tst.build_attr_view_epoch(cfg, 50, 40)
        mask = (np.arange(20) < 17).astype(np.float32)
        return (epoch.step, _j_conv("conv_av"),
                [_trip(rng, 20, E, A, L), w, mask], True)
    if stream in ("ckge_attr", "ckga_attr"):
        epoch, _, _ = getattr(tst, f"build_{stream}_epoch")(cfg, 20)
        conv = "conv_ckge" if stream == "ckge_attr" else "conv_ckga"
        batch = [_trip(rng, 20, E, A, L)] + ([w] if stream == "ckga_attr"
                                              else [])
        return epoch.step, _j_conv(conv), batch, True
    if stream == "ckgp_rel":
        epoch, _, _ = tst.build_ckgp_rel_epoch(cfg, 20)
        return epoch.step, _j_ckgp(), [_trip(rng, 20, E, R, E), w], False
    if stream == "common_space":
        epoch, _, _ = tst.build_common_space_epoch(cfg, 16)
        return (epoch.step, _j_common(jcfg), [rng.permutation(E)[:16]],
                True)
    epoch, _, _ = tst.build_rel_view_epoch(cfg, 50, 40, RANGES,
                                           with_neighbors=True)
    assert epoch.pool == cfg.truncated_pool_size
    assert epoch.s1 <= cfg.truncated_chunk_size and epoch.nc1 > 1
    (lo1, hi1), (lo2, hi2) = RANGES
    batch = []
    for bsp, nc, n_rows, lo, hi in ((epoch.bsp1, epoch.nc1, epoch.bs1 - 3,
                                     lo1, hi1),
                                    (epoch.bsp2, epoch.nc2, epoch.bs2, lo2,
                                     hi2)):
        pos = np.stack([rng.randint(lo, hi, bsp), rng.randint(0, R, bsp),
                        rng.randint(lo, hi, bsp)], 1)
        pos[n_rows:] = pos[0]                    # padding copies a triple
        batch += [pos, (np.arange(bsp) < n_rows).astype(np.float32),
                  rng.randint(lo, hi, (nc, epoch.pool)),
                  rng.randint(lo, hi, (nc, epoch.pool))]
    return epoch.step, _j_rel_view(epoch), batch, False


STREAMS = ("attr_view", "ckge_attr", "ckga_attr", "ckgp_rel", "common_space",
           "rel_view")


# every stream on both branches at width D; the conv scorer and the
# common-space combination also at d = 384, the width at which
# chip_smoke.py runs the ITC driver on the card
@pytest.mark.parametrize("stream,sparse,d", [
    pytest.param(stream, sparse, D, id=f"{stream}-{sparse}")
    for sparse in (True, False) for stream in STREAMS] + [
    pytest.param(stream, True, 384, id=f"{stream}-True-d384")
    for stream in ("attr_view", "ckge_attr", "ckga_attr", "common_space")])
def test_stream_step_matches_jax(stream, sparse, d):
    cfg = Config(row_sparse_updates=sparse, **dict(CFG, dim=d))
    jcfg = JConfig(row_sparse_updates=sparse, **dict(CFG, dim=d))
    assert tst.use_row_sparse(cfg, E, 1) == sparse
    rng = np.random.RandomState(STREAMS.index(stream))
    np_params, np_acc, consts = _state(rng, d)
    step, (jprep, jloss), batch, with_consts = _case(stream, cfg, jcfg, rng)
    names = jst.STREAM_VARS[stream]

    jupdate = jst._make_stream_update(jcfg, stream, jprep, jloss)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    jacc = {k: jax.tree_util.tree_map(jnp.asarray, np_acc[k]) for k in names}
    jbatch = [jnp.asarray(x) for x in batch]
    if with_consts:
        jbatch = [{k: jnp.asarray(v) for k, v in consts.items()}] + jbatch
    jparams, jacc, want = jupdate(jparams, jacc, *jbatch)

    params = tp.params_from_reference(np_params, device="cpu")
    acc = tp.opt_states_from_reference({k: np_acc[k] for k in names},
                                       device="cpu")
    tbatch = [torch.as_tensor(x) for x in batch]
    if with_consts:
        tbatch = [{k: torch.as_tensor(v) for k, v in consts.items()}] + tbatch
    loss = step(params, acc, *tbatch)

    np.testing.assert_allclose(float(loss), float(want), **TOL)
    flat = lambda t: jax.tree_util.tree_leaves(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, t))
    for k in names:
        got_p = flat({k: jax.tree_util.tree_map(lambda x: x.numpy(),
                                                params[k])})
        got_a = flat({k: jax.tree_util.tree_map(lambda x: x.numpy(),
                                                acc[k])})
        for g, w_ in zip(got_p, flat({k: jparams[k]})):
            np.testing.assert_allclose(g, w_, **TOL, err_msg=k)
        for g, w_ in zip(got_a, flat({k: jacc[k]})):
            np.testing.assert_allclose(g, w_, **TOL, err_msg=k)
    # the step moved every variable of the stream
    before = tp.params_from_reference(np_params, device="cpu")
    for k in names:
        moved = [not torch.equal(x, y) for x, y in
                 zip(tst._leaves(params[k]), tst._leaves(before[k]))]
        assert any(moved), k


def test_epoch_sizes_match_jax():
    """Step counts and trained counts as the JAX builders give them (the
    attribute view's batch_size / attribute_batch_size quirk included);
    sampled streams at their true size, since the port has no capacity
    buckets."""
    cfg, jcfg = Config(**CFG), JConfig(**CFG)
    _, steps, trained = tst.build_attr_view_epoch(cfg, 300, 200)
    assert (steps, trained) == jst.build_attr_view_epoch(jcfg, 300, 200)[1:]
    assert steps == 16 and trained == min(300, 16 * 14) + min(200, 16 * 10)
    for name in ("ckge_rel", "ckgp_rel", "ckge_attr", "ckga_attr",
                 "common_space"):
        for n in (7, 100):
            got = getattr(tst, f"build_{name}_epoch")(cfg, n)[1:]
            want = getattr(jst, f"build_{name}_epoch")(jcfg, n)[1:]
            assert got == want, (name, n)


def _train_rows(rng, n, lo, hi):
    return torch.as_tensor(np.stack([rng.randint(lo, hi, n),
                                     rng.randint(0, R, n),
                                     rng.randint(lo, hi, n)], 1))


def test_truncated_rel_view_epoch_runs_and_learns():
    cfg = Config(**CFG)
    rng = np.random.RandomState(0)
    t1, t2 = _train_rows(rng, 200, 0, 20), _train_rows(rng, 150, 20, 40)
    nbr = build_neighbor_state(E, [
        (np.arange(0, 20), rng.randint(0, 20, (20, 4))),
        (np.arange(20, 40), rng.randint(20, 40, (20, 4)))])
    params = tp.init_params(cfg, E, R, A, device="cpu")
    opt = tst.init_stream_opt_states(cfg, params)["rel_view"]
    epoch, steps, _ = tst.build_rel_view_epoch(cfg, 200, 150, RANGES,
                                               with_neighbors=True)
    gen = torch.Generator().manual_seed(0)
    xs = epoch.draw(gen, t1, t2, nbr)
    nbr_sets = [set(nbr.nbr[e, :4].tolist()) for e in range(E)]
    for pos, m, ch, ct in (xs[:4], xs[4:]):
        assert ch.shape[0] == steps and ch.shape[2] == epoch.pool
        s = pos.shape[1] // ch.shape[1]
        for i in range(steps):
            for c in range(ch.shape[1]):
                rows = slice(c * s, (c + 1) * s)
                real = m[i, rows] != 0
                heads = pos[i, rows, 0][real].tolist()
                tails = pos[i, rows, 2][real].tolist()
                allowed_h = set().union(*(nbr_sets[e] for e in heads))
                allowed_t = set().union(*(nbr_sets[e] for e in tails))
                assert set(ch[i, c].tolist()) <= allowed_h
                assert set(ct[i, c].tolist()) <= allowed_t
    losses = [float(epoch(params, opt, gen, t1, t2, nbr)) for _ in range(6)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    with pytest.raises(ValueError):
        epoch.draw(gen, t1, t2, None)


# ---------------------------------------------------------------------------
# neighbor refresh and the neighbor-pool sampler
# ---------------------------------------------------------------------------

def test_neighbor_ids_match_jax_exact_topk():
    rng = np.random.RandomState(5)
    emb = rng.normal(size=(E, D)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    u1 = np.sort(rng.choice(20, 15, replace=False))
    u2 = np.sort(rng.choice(np.arange(20, 40), 12, replace=False))
    for u, k in ((u1, 4), (u2, 3)):
        got = ttr.topk_global_ids(torch.tensor(emb[u]), torch.tensor(u), k,
                                  row_block=4)
        want = np.asarray(jtr._topk_global_ids(
            jnp.asarray(emb[u]), jnp.asarray(u, jnp.int32), k, row_block=8,
            use_approx=False))
        assert got.dtype == torch.int32 and got.shape == want.shape
        for g, w in zip(got.tolist(), want.tolist()):
            assert set(g) == set(w)
    state = ttr.refresh_neighbor_state(
        torch.tensor(emb), (torch.tensor(u1), torch.tensor(u2)), (4, 3), 8)
    jstate = jtr._refresh_neighbor_state(
        jnp.asarray(emb), (u1.astype(np.int32), u2.astype(np.int32)), E=E,
        kmax=8, ks=(4, 3), use_approx=False)
    np.testing.assert_array_equal(state.cnt.numpy(), np.asarray(jstate.cnt))
    np.testing.assert_array_equal(state.has.numpy(), np.asarray(jstate.has))
    assert state.nbr.dtype == torch.int32 and state.nbr.shape == (E, 8)
    for e in range(E):
        k = int(state.cnt[e])
        assert set(state.nbr[e, :k].tolist()) == \
            set(np.asarray(jstate.nbr)[e, :k].tolist())


def test_shared_neighbor_pools_sources():
    """Every pool candidate comes from a chunk member's neighbor row, or
    from [lo, hi) when the donor has none; most come from neighbor rows."""
    rng = np.random.RandomState(1)
    lo, hi = 20, 80
    useful = np.arange(20, 50)
    nbrs = rng.randint(60, 80, size=(30, 5))
    state = build_neighbor_state(100, [(useful, nbrs)])
    nc, s, C = 3, 8, 16
    pos = _train_rows(rng, nc * s, 20, 80)
    ch, ct = sample_shared_neighbor_corruptions(
        torch.Generator().manual_seed(3), pos, nc, s, C, lo, hi, state)
    nbr_of = {int(e): set(map(int, row)) for e, row in zip(useful, nbrs)}
    for pool_arr, ents in ((ch, pos[:, 0].reshape(nc, s)),
                           (ct, pos[:, 2].reshape(nc, s))):
        assert pool_arr.shape == (nc, C) and pool_arr.dtype == torch.int64
        assert int(pool_arr.min()) >= lo and int(pool_arr.max()) < hi
        for c in range(nc):
            from_nbr = set().union(*(nbr_of.get(int(e), set())
                                     for e in ents[c]))
            assert len(set(pool_arr[c].tolist()) & from_nbr) > 0


def test_shared_neighbor_donor_mask_excludes_padding():
    lo, hi = 0, 50
    nc, s, C = 2, 8, 64
    useful = np.array([60, 61, 62, 63, 70])
    nbrs = np.stack([np.arange(200, 205), np.arange(202, 207),
                     np.arange(204, 209), np.arange(205, 210),
                     np.arange(300, 305)])
    state = build_neighbor_state(400, [(useful, nbrs)])
    h = np.array([60, 61, 62, 63] + [70] * 4 + [62, 63, 60, 61] + [70] * 4)
    pos = torch.as_tensor(np.stack([h, np.zeros_like(h), h], 1))
    mask = torch.tensor(np.tile([1.0] * 4 + [0.0] * 4, nc))
    ch, ct = sample_shared_neighbor_corruptions(
        torch.Generator().manual_seed(7), pos, nc, s, C, lo, hi, state,
        mask=mask)
    for pool_arr in (ch, ct):
        assert int(pool_arr.min()) >= 200 and int(pool_arr.max()) < 210, \
            "the padding entity's neighbor rows leaked into the pools"
