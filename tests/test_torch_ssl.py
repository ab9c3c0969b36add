"""The port's SSL driver against the JAX package on the CPU.

* One space_mapping step against a JAX step composed from the package's
  parts (its loss reads rv/av through ``stopped``), on both Adagrad
  branches, at rtol 3e-5 / atol 1e-6; rv and av stay untouched.
* ``wva`` / ``_compute_weight`` and ``valid_WVA`` / ``test_WVA`` against
  the JAX functions on the same embeddings.
* ``cli.main(["-m", "SSL", ..., "--device", "cpu"])`` at the settings of
  tests/test_integration_ssl.py: rv test MRR rises over the untrained
  model's, 6 finite keys, 6 space_mapping records, and nv test MRR equals
  the JAX driver's (its literal vectors read through the JAX DataModel's
  cache). Then the driver's cadences: the predicate refresh inside the
  evaluation branch, the interrupt checkpoint, and the ``wvag`` lines.
"""
import glob
import json
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multike_tpu import losses as jl
from multike_tpu import params as jp
from multike_tpu.align.predicates import PredicateAlignModel as JPAM
from multike_tpu.config import Config as JConfig
from multike_tpu.data.dataset import DataModel as JDataModel
from multike_tpu.eval import views as jvw
from multike_tpu.train import streams as jst
from multike_tpu.train.ssl import MultiKE_SSL as JSSL
from multike_tpu_torch import cli
from multike_tpu_torch import params as tp
from multike_tpu_torch.align.predicates import PredicateAlignModel
from multike_tpu_torch.config import Config
from multike_tpu_torch.data import synthetic
from multike_tpu_torch.data.dataset import DataModel
from multike_tpu_torch.eval import views as vw
from multike_tpu_torch.persistence import EMBEDDING_FILES, ID_FILES
from multike_tpu_torch.train import streams as tst
from multike_tpu_torch.train.ssl import MultiKE_SSL


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = dict(rtol=3e-5, atol=1e-6)
E, R, D = 40, 5, 8


# ---------------------------------------------------------------------------
# space_mapping step
# ---------------------------------------------------------------------------

def _j_space_mapping(ow):
    """streams.py:821-843 as a (prep, loss) pair."""
    eye = jnp.eye(D, dtype=jnp.float32)

    def prep(constants, ents):
        return {"ent": ents}, None

    def loss(rows, dense, stopped, aux, constants, ents):
        final = jp.l2_normalize(rows["ent"], axis=-1)
        out = jl.space_mapping_loss(constants["name_embeds"][ents], final,
                                    dense["nv_mapping"], eye, ow)
        out += jl.space_mapping_loss(jp.lookup_norm(stopped["rv_ent"], ents),
                                     final, dense["rv_mapping"], eye, ow)
        out += jl.space_mapping_loss(jp.lookup_norm(stopped["av_ent"], ents),
                                     final, dense["av_mapping"], eye, ow)
        return out
    return prep, loss


@pytest.mark.parametrize("sparse", [True, False])
def test_space_mapping_step_matches_jax(sparse):
    kw = dict(dim=D, entity_batch_size=16, learning_rate=0.05,
              orthogonal_weight=2.0)
    cfg = Config(row_sparse_updates=sparse, **kw)
    jcfg = JConfig(row_sparse_updates=sparse, **kw)
    rng = np.random.RandomState(int(sparse))
    np_params = jax.tree_util.tree_map(
        np.asarray, jp.init_params(JConfig(dim=D), E, R, 3))
    names = jst.STREAM_VARS["space_mapping"]
    assert names == tst.STREAM_VARS["space_mapping"]
    np_acc = {k: (0.1 + rng.rand(*np_params[k].shape)).astype(np.float32)
              for k in names}
    names_emb = rng.normal(size=(E, D)).astype(np.float32)
    names_emb /= np.linalg.norm(names_emb, axis=1, keepdims=True)
    ents = rng.permutation(E)[:16]

    jupdate = jax.jit(jst._make_stream_update(jcfg, "space_mapping",
                                              *_j_space_mapping(2.0)))
    jparams, jacc, want = jupdate(
        jax.tree_util.tree_map(jnp.asarray, np_params),
        {k: jnp.asarray(v) for k, v in np_acc.items()},
        {"name_embeds": jnp.asarray(names_emb)}, jnp.asarray(ents))

    epoch, steps, trained = tst.build_space_mapping_epoch(cfg, 16)
    assert (steps, trained) == jst.build_space_mapping_epoch(jcfg, 16)[1:]
    params = tp.params_from_reference(np_params, device="cpu")
    acc = tp.opt_states_from_reference(np_acc, device="cpu")
    loss = epoch.step(params, acc, {"name_embeds": torch.tensor(names_emb)},
                      torch.as_tensor(ents))
    np.testing.assert_allclose(float(loss), float(want), **TOL)
    for k in names:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(jparams[k]),
                                   **TOL, err_msg=k)
        np.testing.assert_allclose(acc[k].numpy(), np.asarray(jacc[k]),
                                   **TOL, err_msg=k)
        assert not np.array_equal(params[k].numpy(), np_params[k]), k
    for k in ("rv_ent", "av_ent"):                   # frozen reads
        np.testing.assert_array_equal(params[k].numpy(), np_params[k])


# ---------------------------------------------------------------------------
# WVA
# ---------------------------------------------------------------------------

def _views(seed, n=60):
    rng = np.random.RandomState(seed)
    base = rng.normal(size=(n, D)).astype(np.float32)
    out = {}
    for v, noise in (("nv", 0.3), ("rv", 0.6), ("av", 1.2)):
        x = base + noise * rng.normal(size=(2 * n, D)).astype(np.float32) \
            .reshape(2, n, D)
        out[v] = x.reshape(2 * n, D)
    out["nv"] /= np.linalg.norm(out["nv"], axis=1, keepdims=True)
    return out


def test_wva_weights_match_jax():
    v = _views(0)
    want = jvw.wva(v["nv"], v["rv"], v["av"])
    got = vw.wva(*(torch.tensor(v[k]) for k in ("nv", "rv", "av")))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(
        vw._compute_weight(*(torch.tensor(v[k]) for k in ("av", "nv", "rv"))),
        jvw._compute_weight(v["av"], v["nv"], v["rv"], jnp), rtol=1e-6)
    z = np.zeros((3, D), np.float32)                 # zero rows stay zero
    np.testing.assert_array_equal(vw._normalize_rows(torch.tensor(z)).numpy(),
                                  np.asarray(jvw._normalize_rows(z)))


class _Trainer:
    """What the WVA evaluation reads of a trainer."""

    def __init__(self, embeds, cfg):
        n = embeds["nv"].shape[0] // 2
        ids = list(range(n))
        self.kgs = types.SimpleNamespace(
            valid_entities1=ids[:20], valid_entities2=[n + i for i in ids[:20]],
            test_entities1=ids[20:], test_entities2=[n + i for i in ids[20:]])
        self.embeds, self.cfg, self.verbose, self.pctx = embeds, cfg, True, None

    def current_embeds_device(self, which):
        return self.embeds[which]


def test_valid_and_test_wva_match_jax(capsys):
    v = _views(1)
    jt = _Trainer({k: jnp.asarray(x) for k, x in v.items()}, JConfig())
    t = _Trainer({k: torch.tensor(x) for k, x in v.items()}, Config())
    for fn in ("valid_WVA", "test_WVA"):
        want = getattr(jvw, fn)(jt)
        capsys.readouterr()
        got = getattr(vw, fn)(t)
        out = capsys.readouterr().out
        assert 0 < got <= 1
        assert got == pytest.approx(want, rel=1e-6, abs=1e-9), fn
        label = "valid" if fn == "valid_WVA" else "test"
        assert out.startswith("weights ") and f"wvag {label} results:" in out


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

SSL_KW = dict(dim=16, batch_size=256, entity_batch_size=128,
              attribute_batch_size=256, encoder_epoch=2, neg_triple_num=5,
              max_epoch=8, shared_learning_max_epoch=6, learning_rate=0.02,
              start_valid=99, eval_freq=99, truncated_freq=5,
              start_predicate_soft_alignment=3, is_save=False)


@pytest.fixture(scope="module")
def ssl_data(tmp_path_factory):
    """The JAX DataModel writes the literal cache; the port reads it."""
    root = tmp_path_factory.mktemp("ssl")
    folder = synthetic.generate(str(root / "ds") + "/", seed=13)
    kw = dict(SSL_KW, training_data=folder,
              word2vec_path=folder + "mini_word2vec.vec")
    jcfg = JConfig(**kw)
    jdata = JDataModel(jcfg)
    jmodel = JSSL(jcfg, jdata, JPAM(jdata.kgs, jcfg), verbose=False)
    cfg = Config(retrain_literal_embeds=False, **kw)
    return root, folder, cfg, DataModel(cfg, device="cpu"), jmodel


def _model(cfg, data, **kw):
    cfg = cfg.replace(**kw)
    return MultiKE_SSL(cfg, data, PredicateAlignModel(data.kgs, cfg),
                       verbose=False, device="cpu")


def test_cli_ssl_on_cpu(ssl_data, capsys):
    root, folder, cfg, data, jmodel = ssl_data
    args = root / "args.json"
    args.write_text(json.dumps({k: v for k, v in SSL_KW.items()}))
    metrics = str(root / "metrics.jsonl")
    out_dir = str(root / "out") + "/"
    results = cli.main(["-m", "SSL", "-d", folder, "--args", str(args),
                        "--device", "cpu", "--set",
                        "retrain_literal_embeds=false", "--set",
                        f"word2vec_path={folder}mini_word2vec.vec", "--set",
                        f"metrics_log_path={metrics}", "--set",
                        "is_save=true", "--set", f"output={out_dir}"])
    out = capsys.readouterr().out
    assert set(results) == {"nv", "rv", "av", "avg", "wva", "final"}
    assert all(np.isfinite(v) and 0 < v <= 1 for v in results.values())
    assert "wvag test results:" in out and "final test MRRs:" in out
    assert "epoch 6 of shared space learning, avg. loss:" in out
    recs = [json.loads(ln) for ln in open(metrics)]
    sm = [r for r in recs if r.get("stream") == "space_mapping"]
    assert len(sm) == 6 and all(np.isfinite(r["loss"]) for r in sm)
    rel = [r for r in recs if r.get("stream") == "rel_view"]
    assert len(rel) == 8 and [r["truncated"] for r in rel] == \
        [False] * 5 + [True] * 3
    assert not [r for r in recs if r.get("stream") == "common_space"]
    untrained = _model(cfg, data)
    assert results["rv"] > vw.test(untrained, embed_choice="rv")
    assert results["nv"] == jvw.test(jmodel, embed_choice="nv")
    saved = glob.glob(os.path.join(out_dir, "MultiKE_SSL", "ds", "*"))
    assert len(saved) == 1
    assert set(os.listdir(saved[0])) == \
        {f + ".npy" for f in EMBEDDING_FILES} | set(ID_FILES)


def test_ssl_cadences(ssl_data, monkeypatch, tmp_path):
    """Per-slot draws with Bloom drop in both phases; valid + WVA at every
    evaluation; the predicate refresh inside the evaluation branch from
    start_predicate_soft_alignment (SSL), not every 10 epochs (ITC); a
    ``final`` valid at phase 2's cadence; an exception leaves an
    ``ssl_interrupt`` checkpoint."""
    _, _, cfg, data, _ = ssl_data
    model = _model(cfg, data, max_epoch=6, shared_learning_max_epoch=4,
                   start_valid=2, eval_freq=2, truncated_freq=3,
                   start_predicate_soft_alignment=3, neg_scheme="per_slot",
                   truncated_neg_scheme="per_slot")
    assert model.triple_filter is not None
    refreshes, wva = [], []
    pam = model.predicate_align_model
    update = pam.update_predicate_alignment
    monkeypatch.setattr(pam, "update_predicate_alignment",
                        lambda *a, **k: refreshes.append(k) or update(*a, **k))
    valid_wva = vw.valid_WVA
    monkeypatch.setattr(vw, "valid_WVA",
                        lambda m: wva.append(1) or valid_wva(m))
    results = model.run()
    assert len(results) == 6
    assert len(wva) == 3                              # epochs 2, 4, 6
    assert len(refreshes) == 4                        # epochs 4, 6; both types
    rel = model.metrics.stream_records("rel_view")
    assert [r["scheme"] for r in rel] == ["per_slot"] * 6
    assert [r["truncated"] for r in rel] == [False] * 3 + [True] * 3
    # uniform draws rarely hit a true triple; with k = 2 neighbors the
    # entity itself is one of them, so about half the truncated draws do
    assert all(0 < r["dropped_share"] < 0.1 for r in rel[:3])
    assert all(0.3 < r["dropped_share"] < 0.7 for r in rel[3:])
    valid = model.metrics.stream_records("valid")
    assert [r["epoch"] for r in valid] == [2, 4, 6]
    assert all(np.isfinite(r["mrr_wva"]) for r in valid)
    assert [r["epoch"] for r in model.metrics.stream_records(
        "valid_final")] == [2, 4]

    crash = _model(cfg, data, checkpoint_dir=str(tmp_path))

    def boom(*a, **k):
        raise RuntimeError("boom")
    monkeypatch.setattr(crash, "train_attribute_view_1epo", boom)
    with pytest.raises(RuntimeError, match="boom"):
        crash.run()
    assert os.path.exists(crash.checkpoint_path("ssl_interrupt"))
    assert _model(cfg, data, checkpoint_dir=str(tmp_path)).try_resume(
        "ssl_interrupt") == -1
