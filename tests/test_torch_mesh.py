"""The port's mesh (parallel/*, eval/ring.py) against the JAX package on
the CPU.

Four rank processes (tests/test_torch_mesh_ranks.py: gloo, a file store,
the port alone) run, at dp=2 x tp=2: ``row_apply_sharded``, the placement
helpers (``table_spec``, ``round_batch``,
``put_edge_partitioned``, ``to_host``), ``tp_lookup``,
the ring over all four ranks, one injected step of each stream case and
``spmd.dryrun``. The JAX package, on conftest's 8 virtual CPU devices, is
the oracle: ``row_apply_sharded`` on a (2, 2) mesh (rtol 1e-6 / atol
1e-7), ``make_tp_lookup``, the JAX ring on a 4-device mesh (counts and
argmax exactly equal, and equal to the port's one-rank ``rank_and_align``),
and ``streams._make_stream_update(pctx=...)`` on a (2, 2) mesh (rtol 3e-5
/ atol 1e-6, as the one-device step tests). The steps cover the conv
scorer's whole-tensor norm (attr_view, ckge_attr), space_mapping's
whole-batch norm and its once-only terms. ``dryrun`` at (2, 2) must equal
the one-rank dryrun (rtol 1e-3, the JAX package's own contract,
tests/test_spmd.py). Also here: K2 with gold columns outside the block,
against ``rank_count_pallas`` in interpret mode, and the single-process
helpers of parallel/distributed.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import test_torch_mesh_ranks as ranks
from multike_tpu import params as jp
from multike_tpu.config import Config as JConfig
from multike_tpu.eval.ring import ring_rank_and_align as jring
from multike_tpu.kernels.rank_kernel import rank_count_pallas
from multike_tpu.parallel import context as jctx
from multike_tpu.parallel.mesh import make_mesh as jmake_mesh
from multike_tpu.parallel.tp_lookup import make_tp_lookup as jmake_tp_lookup
from multike_tpu.train import sparse_adagrad as jsa
from multike_tpu.train import streams as jst
from multike_tpu_torch.config import Config
from multike_tpu_torch.eval.alignment import rank_and_align
from multike_tpu_torch.kernels import rank_kernel as trk
from multike_tpu_torch.parallel import distributed
from multike_tpu_torch.parallel.context import MeshContext
from multike_tpu_torch.parallel.spmd import dryrun
from multike_tpu_torch.train import sparse_adagrad, streams as tst
from test_torch_per_slot import _j_per_slot
from test_torch_ssl import _j_space_mapping
from test_torch_streams_itc import _j_common, _j_conv, _j_rel_view

TOL = dict(rtol=3e-5, atol=1e-6)
E, R, A, L, D = 41, 5, 4, 30, 8          # E pads to 42 rows at tp = 2
EP = 42
CFG = dict(dim=D, batch_size=32, attribute_batch_size=24,
           entity_batch_size=16, neg_triple_num=3, learning_rate=0.05,
           ITC_learning_rate=0.02, truncated_chunk_size=8,
           truncated_pool_size=6, neg_chunk_size=16, neg_pool_size=4,
           orthogonal_weight=2.0)
ROW_TABLES = ("rv_ent", "av_ent", "ent")
# the four cases of tests/test_ring_eval.py: (n1, n2, d, csls_k, shift)
RING_CASES = ((96, 160, 12, 0, 2.0), (61, 115, 9, 0, 1.5),
              (72, 136, 10, 5, 1.5), (53, 101, 8, 4, 1.5))


# ---------------------------------------------------------------------------
# inputs, from seeds
# ---------------------------------------------------------------------------

def _row_apply_inputs():
    rng = np.random.RandomState(0)
    Et, d, N = 32, 6, 21                  # N deliberately not divisible by dp
    return dict(param=rng.randn(Et, d).astype(np.float32),
                acc=(0.1 + rng.rand(Et, d)).astype(np.float32),
                ids=rng.randint(0, Et, N).astype(np.int64),
                g=rng.randn(N, d).astype(np.float32), lr=0.1)


def _edges():
    return np.random.RandomState(2).randint(0, 40, (21, 3)).astype(np.int64)


def _tp_lookup_inputs():
    rng = np.random.RandomState(1)
    return dict(table=rng.randn(32, 16).astype(np.float32),
                ids=rng.randint(0, 32, 40).astype(np.int64))


def _ring_inputs():
    rng = np.random.RandomState(11)
    out = []
    for n1, n2, d, k, shift in RING_CASES:
        e1 = rng.randn(n1, d).astype(np.float32)
        e2 = rng.randn(n2, d).astype(np.float32)
        e2[:n1] += shift * e1
        out.append(dict(e1=e1, e2=e2, csls_k=k))
    return out


def _state(seed):
    """Whole tables (row tables padded to EP rows), random accumulators
    and the constants."""
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        np.asarray, jp.init_params(JConfig(dim=D), E, R, A))
    acc = jax.tree_util.tree_map(
        lambda x: (0.1 + rng.rand(*x.shape)).astype(np.float32), params)
    for t in ROW_TABLES:
        params[t] = np.concatenate([params[t], np.zeros((1, D), np.float32)])
        acc[t] = np.concatenate([acc[t], np.full((1, D), 0.1, np.float32)])
    names = rng.normal(size=(E, D)).astype(np.float32)
    consts = {"name_embeds": names / np.linalg.norm(names, axis=1,
                                                    keepdims=True),
              "literal_embeds": rng.normal(size=(L, D)).astype(np.float32)}
    return rng, params, acc, consts


def _trip(rng, n, hi_ent, hi_rel, hi_tail):
    return np.stack([rng.randint(0, hi_ent, n), rng.randint(0, hi_rel, n),
                     rng.randint(0, hi_tail, n)], 1)


def _rel_rows(rng, epoch, bsp, nc, n_rows, lo, hi, per_slot):
    pos = np.stack([rng.randint(lo, hi, bsp), rng.randint(0, R, bsp),
                    rng.randint(lo, hi, bsp)], 1)
    pos[n_rows:] = pos[0]                          # padding copies a triple
    m = (np.arange(bsp) < n_rows).astype(np.float32)
    if per_slot:
        K = epoch.neg_num
        return [pos, m, rng.randint(lo, hi, (bsp, K)), rng.rand(bsp, K) < 0.5,
                (rng.rand(bsp, K) > 0.3).astype(np.float32)]   # Bloom drops
    return [pos, m, rng.randint(lo, hi, (nc, epoch.pool)),
            rng.randint(lo, hi, (nc, epoch.pool))]


def _step_cases():
    """{case: (stream, build kwargs, cfg overrides, (jprep, jloss), batch,
    uses constants, seed)}: one step of each stream case."""
    cases = {}
    for i, name in enumerate(("rel_view_chunk", "rel_view_per_slot",
                              "attr_view", "ckge_attr", "common_space",
                              "space_mapping")):
        rng, params, acc, consts = _state(10 + i)
        over = {}
        if name.startswith("rel_view"):
            per_slot = name.endswith("per_slot")
            if per_slot:
                over = dict(neg_scheme="per_slot",
                            truncated_neg_scheme="per_slot")
            build = dict(kind="rel_view", n1=50, n2=40, nbr=True)
            epoch = tst.build_rel_view_epoch(
                Config(**CFG, **over), 50, 40, ranks.RANGES,
                with_neighbors=True)[0]
            if per_slot:      # (rows, chunks, real rows) of each KG
                layout = ((epoch.bs1, 0, epoch.bs1 - 3),
                          (epoch.bs2, 0, epoch.bs2))
            else:
                layout = ((epoch.bsp1, epoch.nc1, epoch.bs1 - 3),
                          (epoch.bsp2, epoch.nc2, epoch.bs2))
            batch = []
            for (bsp, nc, cut), (lo, hi) in zip(layout, ranks.RANGES):
                batch += _rel_rows(rng, epoch, bsp, nc, cut, lo, hi,
                                   per_slot)
            j = _j_per_slot(epoch) if per_slot else _j_rel_view(epoch)
            cases[name] = ("rel_view", build, over, j, batch, False, params,
                           acc, consts)
            continue
        w = (0.2 + rng.rand(20)).astype(np.float32)
        if name == "attr_view":
            build = dict(kind="attr_view", n1=50, n2=40)
            batch = [_trip(rng, 20, E, A, L), w,
                     (np.arange(20) < 17).astype(np.float32)]
            j = _j_conv("conv_av")
        elif name == "ckge_attr":
            build = dict(kind="ckge_attr", n=20)
            batch = [_trip(rng, 20, E, A, L)]
            j = _j_conv("conv_ckge")
        elif name == "common_space":
            build = dict(kind="common_space", n=16)
            batch = [rng.permutation(E)[:16]]
            j = _j_common(JConfig(**CFG))
        else:
            build = dict(kind="space_mapping", n=16)
            batch = [rng.permutation(E)[:16]]
            j = _j_space_mapping(CFG["orthogonal_weight"])
        cases[name] = (name, build, over, j, batch, True, params, acc,
                       consts)
    return cases


def _t(x):
    return None if x is None else torch.tensor(x)


def _payload():
    steps = {}
    for name, (stream, build, over, _, batch, with_c, params, acc,
               consts) in _step_cases().items():
        names = tst.STREAM_VARS[stream]
        steps[name] = dict(
            build, cfg=over,
            params=jax.tree_util.tree_map(_t, params),
            acc={k: jax.tree_util.tree_map(_t, acc[k]) for k in names},
            batch=[_t(x) for x in batch],
            consts={k: _t(v) for k, v in consts.items()} if with_c else None)
    return dict(
        row_apply={k: (_t(v) if k != "lr" else v)
                   for k, v in _row_apply_inputs().items()},
        tp_lookup={k: _t(v) for k, v in _tp_lookup_inputs().items()},
        edges=_t(_edges()),
        ring=[dict(e1=_t(c["e1"]), e2=_t(c["e2"]), csls_k=c["csls_k"])
              for c in _ring_inputs()],
        steps=steps, cfg=CFG)


class _Ranked:
    """The four rank processes, started at once; calling it waits for rank
    0's results, so each test computes its JAX oracle while they run."""

    def __init__(self, folder):
        self.handle = ranks.start("kernels", 4, _payload(), folder)
        self.results = None

    def __call__(self):
        if self.results is None:
            self.results = ranks.finish(self.handle)[0]
        return self.results


@pytest.fixture(scope="module")
def ranked(tmp_path_factory):
    r = _Ranked(str(tmp_path_factory.mktemp("mesh_kernels")))
    yield r
    r()                                    # no rank outlives the module


@pytest.fixture(scope="module")
def jpctx():
    return jctx.MeshContext.from_config(JConfig(mesh_dp=2, mesh_tp=2))


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def test_row_apply_sharded_matches_jax(ranked, jpctx):
    a = _row_apply_inputs()
    tp_rows = NamedSharding(jpctx.mesh, P("tp", None))
    want = jctx.row_apply_sharded(
        jpctx, "rv_ent", jax.device_put(a["param"], tp_rows),
        jax.device_put(a["acc"], tp_rows), jnp.asarray(a["ids"], jnp.int32),
        jnp.asarray(a["g"]), a["lr"])
    one = sparse_adagrad.row_apply(torch.tensor(a["param"]),
                                   torch.tensor(a["acc"]),
                                   torch.tensor(a["ids"]),
                                   torch.tensor(a["g"]), a["lr"])
    for got, w, o in zip(ranked()["row_apply"], want, one):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(got.numpy(), o.numpy(), rtol=1e-6,
                                   atol=1e-7)
    # the JAX package's one-device apply agrees too
    jp_, ja = jsa.row_apply(jnp.asarray(a["param"]), jnp.asarray(a["acc"]),
                            jnp.asarray(a["ids"], jnp.int32),
                            jnp.asarray(a["g"]), a["lr"])
    np.testing.assert_allclose(ranked()["row_apply"][0].numpy(),
                               np.asarray(jp_), rtol=1e-6, atol=1e-7)


def test_placement_helpers_match_jax(ranked, jpctx):
    """Rank 0 of (2, 2): which tables are row-sharded (``table_spec``) as
    in the JAX package's trainer, ``round_batch``, its dp block of 21 edges
    padded by wraparound to 22, and ``to_host`` of a row-sharded table,
    which is the whole table."""
    h = ranked()["helpers"]
    assert set(h["specs"]) == set(ranks.SPEC_TABLES)
    for t, spec in h["specs"].items():
        assert (spec == "rows") == (jpctx.table_spec(t) == P("tp", None)), t
    assert [t for t, s in h["specs"].items() if s == "rows"] == list(
        ROW_TABLES)
    assert h["round_batch"] == [jpctx.round_batch(n) for n in (1, 20, 21)]
    edges = _edges()
    assert h["edge_n"] == 21
    np.testing.assert_array_equal(h["edge_block"].numpy(),
                                  np.concatenate([edges, edges[:1]])[:11])
    np.testing.assert_array_equal(h["to_host"].numpy(),
                                  ranked()["row_apply"][0].numpy())


@pytest.mark.parametrize("normalize", [False, True])
def test_tp_lookup_matches_jax(ranked, normalize):
    t = _tp_lookup_inputs()
    mesh = jmake_mesh(2, 2)
    sharded = jax.device_put(t["table"], NamedSharding(mesh, P("tp", None)))
    want = np.asarray(jax.jit(jmake_tp_lookup(mesh, normalize=normalize))(
        sharded, jnp.asarray(t["ids"], jnp.int32)))
    got = ranked()["tp_lookup"][int(normalize)].numpy()
    if normalize:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, t["table"][t["ids"]])


@pytest.mark.parametrize("case", range(len(RING_CASES)))
def test_ring_matches_jax_and_one_rank(ranked, case):
    c = _ring_inputs()[case]
    want_c, want_b = jring(jmake_mesh(4, 1), c["e1"], c["e2"],
                           csls_k=c["csls_k"])
    one_c, one_b = rank_and_align(c["e1"], c["e2"], csls_k=c["csls_k"],
                                  device="cpu")
    got_c, got_b = (x.numpy() for x in ranked()["ring"][case])
    assert got_c.dtype == np.int64 and len(got_c) == len(c["e1"])
    np.testing.assert_array_equal(got_c, np.asarray(want_c))
    np.testing.assert_array_equal(got_b, np.asarray(want_b))
    np.testing.assert_array_equal(got_c, one_c)
    np.testing.assert_array_equal(got_b, one_b)


@pytest.mark.parametrize("name", ["rel_view_chunk", "rel_view_per_slot",
                                  "attr_view", "ckge_attr", "common_space",
                                  "space_mapping"])
def test_mesh_step_matches_jax(ranked, jpctx, name):
    stream, _, over, (jprep, jloss), batch, with_c, params, acc, consts = \
        _step_cases()[name]
    names = jst.STREAM_VARS[stream]
    jcfg = JConfig(row_sparse_updates=True, **CFG, **over)
    jupdate = jax.jit(jst._make_stream_update(jcfg, stream, jprep, jloss,
                                              pctx=jpctx))
    jparams = jpctx.shard_params(jax.tree_util.tree_map(jnp.asarray, params))
    jacc = jpctx.shard_params({k: jax.tree_util.tree_map(jnp.asarray,
                                                         acc[k])
                               for k in names})
    jbatch = [None if x is None else jnp.asarray(x) for x in batch]
    if with_c:
        jbatch = [jpctx.replicate({k: jnp.asarray(v)
                                   for k, v in consts.items()})] + jbatch
    jparams, jacc, want = jupdate(jparams, jacc, *jbatch)

    got = ranked()["steps"][name]
    np.testing.assert_allclose(got["loss"], float(want), **TOL)
    leaves = jax.tree_util.tree_leaves
    for k in names:
        for g, w in zip(leaves(jax.tree_util.tree_map(
                lambda x: x.numpy(), got["params"][k])),
                leaves(jax.tree_util.tree_map(np.asarray, jparams[k]))):
            np.testing.assert_allclose(g, w, **TOL, err_msg=k)
        for g, w in zip(leaves(jax.tree_util.tree_map(
                lambda x: x.numpy(), got["acc"][k])),
                leaves(jax.tree_util.tree_map(np.asarray, jacc[k]))):
            np.testing.assert_allclose(g, w, **TOL, err_msg=k)
        moved = [not np.array_equal(g.numpy(), p) for g, p in zip(
            leaves(got["params"][k]), leaves(params[k]))]
        assert any(moved), k
    if stream == "space_mapping":                    # frozen reads
        for k in ("rv_ent", "av_ent"):
            np.testing.assert_array_equal(got["params"][k].numpy(),
                                          params[k])


def test_dryrun_four_ranks_matches_one(ranked):
    one = dryrun(1, 1, device="cpu")
    got = ranked()["dryrun"]
    assert set(got) == set(one) | {"eval_rows"} and len(one) == 8
    assert got["eval_rows"] == 32.0
    for k, v in one.items():
        assert np.isclose(got[k], v, rtol=1e-3), (k, got[k], v)


@pytest.mark.parametrize("csls", [False, True])
def test_rank_plain_gold_outside_block_matches_pallas(csls):
    """The ring's K2 call: gold column ids shifted by the block's first
    column, so they fall below 0 or at n2 and beyond; none may match a
    column. The plain version equals rank_count_pallas in interpret mode
    and counts every beating column."""
    rng = np.random.RandomState(3 + int(csls))
    n1, n2, d = 40, 70, 8
    e1 = rng.randint(-3, 4, (n1, d)).astype(np.float32)
    e2 = rng.randint(-3, 4, (n2, d)).astype(np.float32)
    gidx = np.where(np.arange(n1) % 2 == 0, -rng.randint(1, 100, n1),
                    n2 + rng.randint(0, 100, n1)).astype(np.int32)
    gidx[:2] = (-1, n2)                             # the nearest outside ids
    s = e1.astype(np.int64) @ e2.T.astype(np.int64)
    r2 = rng.randint(-4, 5, n2).astype(np.float32) if csls else None
    if csls:
        s = 2 * s - r2.astype(np.int64)[None, :]
    gold = np.median(s, axis=1).astype(np.float32)
    cnt, bidx, bval = rank_count_pallas(
        jnp.asarray(e1), jnp.asarray(gold), jnp.asarray(gidx),
        jnp.asarray(e2), None if r2 is None else jnp.asarray(r2), bm=16,
        bn=32, use_csls=csls, interpret=True)
    got = trk.rank_count(torch.tensor(e1), torch.tensor(gold),
                         torch.tensor(gidx), torch.tensor(e2),
                         None if r2 is None else torch.tensor(r2),
                         row_block=16)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(cnt))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(bidx))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(bval))
    np.testing.assert_array_equal(got[0].numpy(),
                                  (s > gold[:, None]).sum(1))


def test_single_process_helpers():
    """With no process group: init_distributed with one process is a
    no-op, the whole list is this process's block, and a mesh that the
    world cannot hold raises instead of running on one rank."""
    distributed.init_distributed(num_processes=1)
    assert not torch.distributed.is_initialized()
    assert distributed.local_data_slice(100) == slice(0, 100)
    assert distributed.padded_rows_per_process(7) == 7
    assert not distributed.is_multiprocess()
    assert [distributed.block_slice(10, 4, i) for i in range(4)] == [
        slice(0, 3), slice(3, 6), slice(6, 9), slice(9, 10)]
    assert distributed.block_slice(1, 4, 3) == slice(1, 1)
    assert MeshContext.from_config(Config()) is None
    with pytest.raises(RuntimeError, match="needs a process group of 4"):
        MeshContext.from_config(Config(mesh_dp=2, mesh_tp=2), "cpu")
    with pytest.raises(ValueError):
        MeshContext.from_config(Config(mesh_dp=0), "cpu")
