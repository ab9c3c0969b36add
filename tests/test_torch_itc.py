"""The port's ITC driver end to end on the CPU.

* ``cli.main([... "--device", "cpu"])`` with the verify recipe's settings
  logs every stream, saves the 6 ``.npy`` files and the id dicts, and
  returns a finite 4-key MRR dict; without ``--device`` and without a card
  it stops instead of running on the CPU, in either mode.
* ``MultiKE_ITC`` at the settings of tests/test_integration_itc.py: rv and
  final valid MRR rise, nv test MRR is above 0.9 and, with the JAX
  DataModel's literal vectors read through the cache, equals the JAX
  driver's nv test MRR exactly.
* A checkpoint the JAX package wrote loads with equal tables and
  accumulators; a port checkpoint round-trips and loads into the JAX
  package, an interrupt checkpoint (epoch -1) included.
* The early-stop gate is armed only by ``enable_early_stop``.
"""
import glob
import json
import os

import numpy as np
import pytest
import torch

import jax

from multike_tpu.align.predicates import PredicateAlignModel as JPAM
from multike_tpu.config import Config as JConfig
from multike_tpu.data.dataset import DataModel as JDataModel
from multike_tpu.eval import views as jvw
from multike_tpu.persistence import load_checkpoint as jload_checkpoint
from multike_tpu.train.itc import MultiKE_ITC as JITC
from multike_tpu_torch import cli
from multike_tpu_torch.align.predicates import PredicateAlignModel
from multike_tpu_torch.config import Config
from multike_tpu_torch.data import synthetic
from multike_tpu_torch.data.dataset import DataModel
from multike_tpu_torch.eval import views as vw
from multike_tpu_torch.persistence import EMBEDDING_FILES, ID_FILES
from multike_tpu_torch.train.itc import MultiKE_ITC

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the steps here are many tiny ops, which the
    thread pool slows by orders of magnitude when test workers share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


STREAM_LINES = ("of rel. view", "of cross-kg entity inference in rel. view",
                "of cross-kg relation inference in rel. view",
                "of att. view", "of cross-kg entity inference in attr. view",
                "of cross-kg attribute inference in attr. view",
                "of common space learning")


def _verify_args(folder, out):
    return {"training_data": folder, "output": out,
            "word2vec_path": folder + "mini_word2vec.vec",
            "dim": 16, "max_epoch": 3, "shared_learning_max_epoch": 2,
            "batch_size": 256, "entity_batch_size": 128,
            "attribute_batch_size": 256, "encoder_epoch": 2,
            "neg_triple_num": 3, "truncated_freq": 2, "start_valid": 2,
            "eval_freq": 2, "start_predicate_soft_alignment": 1}


@pytest.fixture(scope="module")
def verify_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    folder = synthetic.generate(str(root / "mtpu_ds") + "/", seed=11)
    args = root / "args.json"
    args.write_text(json.dumps(_verify_args(folder, str(root / "out") + "/")))
    return root, folder, str(args)


def test_cli_itc_on_cpu(verify_run, capsys):
    root, folder, args = verify_run
    results = cli.main(["-m", "ITC", "-d", folder, "--args", args,
                        "--device", "cpu"])
    out = capsys.readouterr().out
    assert set(results) == {"nv", "rv", "av", "final"}
    assert all(np.isfinite(v) and 0 < v <= 1 for v in results.values())
    for line in STREAM_LINES:
        assert f"epoch 3 {line}, avg. loss:" in out, line
    assert "generating neighbors of 240 entities" in out
    assert "Embeddings saved!" in out and "final test MRRs:" in out
    saved = glob.glob(str(root / "out" / "MultiKE_ITC" / "mtpu_ds" / "*"))
    assert len(saved) == 1
    names = set(os.listdir(saved[0]))
    assert names == {f + ".npy" for f in EMBEDDING_FILES} | set(ID_FILES)
    ent = np.load(os.path.join(saved[0], "ent_embeds.npy"))
    assert ent.shape == (240, 16) and np.isfinite(ent).all()


def test_cli_needs_the_card_unless_told(verify_run):
    _, folder, args = verify_run
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would use it")
    for mode in ("ITC", "SSL"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["-m", mode, "-d", folder, "--args", args])


# ---------------------------------------------------------------------------
# the settings of tests/test_integration_itc.py
# ---------------------------------------------------------------------------

ITC_KW = dict(dim=16, batch_size=256, entity_batch_size=128,
              attribute_batch_size=256, encoder_epoch=2, neg_triple_num=5,
              max_epoch=12, learning_rate=0.02, start_valid=99, eval_freq=99,
              truncated_freq=6, start_predicate_soft_alignment=4,
              is_save=False)


@pytest.fixture(scope="module")
def itc(tmp_path_factory):
    """The JAX DataModel writes the literal cache; the port reads it."""
    root = tmp_path_factory.mktemp("itc")
    folder = synthetic.generate(str(root / "ds") + "/", seed=9)
    kw = dict(ITC_KW, training_data=folder,
              word2vec_path=folder + "mini_word2vec.vec",
              checkpoint_dir=str(root / "ckpt"))
    jcfg = JConfig(**kw)
    jdata = JDataModel(jcfg)
    jmodel = JITC(jcfg, jdata, JPAM(jdata.kgs, jcfg), verbose=False)
    cfg = Config(retrain_literal_embeds=False, **kw)
    data = DataModel(cfg, device="cpu")
    return cfg, data, jmodel


def _model(cfg, data, **kw):
    cfg = cfg.replace(**kw)
    return MultiKE_ITC(cfg, data, PredicateAlignModel(data.kgs, cfg),
                       verbose=False, device="cpu")


def test_itc_driver_improves_alignment(itc):
    cfg, data, jmodel = itc
    model = _model(cfg, data, checkpoint_dir="")
    before_rv = vw.valid(model, embed_choice="rv")
    before_final = vw.valid(model, embed_choice="final")
    results = model.run()
    after_rv = vw.valid(model, embed_choice="rv")
    after_final = vw.valid(model, embed_choice="final")
    assert after_rv > before_rv, (before_rv, after_rv)
    assert after_final > before_final, (before_final, after_final)
    assert all(np.isfinite(v) for v in results.values())
    assert results["nv"] > 0.9
    assert results["nv"] == jvw.test(jmodel, embed_choice="nv")
    assert model.metrics.throughput("rel_view") is not None
    rel = model.metrics.stream_records("rel_view")
    assert [r["truncated"] for r in rel] == [False] * 6 + [True] * 6
    assert len(model.metrics.stream_records("neighbors")) == 2
    assert len(model.metrics.stream_records("ckgp_rel")) == 8
    avg = vw.valid(model)                   # the default choice, 'avg'
    assert 0 < avg <= 1


def test_jax_checkpoint_loads_and_port_checkpoint_roundtrips(itc):
    cfg, data, jmodel = itc
    rng = np.random.RandomState(0)
    jmodel.opt_states = jax.tree_util.tree_map(
        lambda x: x + rng.rand(*x.shape).astype(np.float32),
        jmodel.opt_states)
    jmodel.save_checkpoint_tag("itc", 3)
    model = _model(cfg, data)
    assert model.try_resume("itc") == 3
    want_p = jax.tree_util.tree_map(np.asarray, jmodel.params)
    want_a = jax.tree_util.tree_map(np.asarray, jmodel.opt_states)

    def check(tree, want):
        if isinstance(want, dict):
            assert set(tree) == set(want)
            for k in want:
                check(tree[k], want[k])
        else:
            np.testing.assert_array_equal(tree.numpy(), want)

    check(model.params, want_p)
    check(model.opt_states, want_a)

    model.params["rv_ent"] += 1.0
    model.save_checkpoint_tag("port", 7)
    other = _model(cfg, data)
    assert other.try_resume("port") == 7
    port_p = jax.tree_util.tree_map(lambda t: t.numpy(), model.params)
    port_a = jax.tree_util.tree_map(lambda t: t.numpy(), model.opt_states)
    check(other.params, port_p)
    check(other.opt_states, port_a)
    # ... and loads into the JAX package (its key does not carry over)
    p, a, _, epoch, _ = jload_checkpoint(model.checkpoint_path("port"),
                                         jmodel.params, jmodel.opt_states,
                                         jmodel.key)
    assert epoch == 7
    check(model.params, jax.tree_util.tree_map(np.asarray, p))
    check(model.opt_states, jax.tree_util.tree_map(np.asarray, a))
    model.save_checkpoint_tag("interrupt", -1)       # as run() does
    assert _model(cfg, data).try_resume("interrupt") == -1


def _early_stop_evals(cfg, data, monkeypatch, **kw):
    model = _model(cfg, data, max_epoch=6, start_valid=1, eval_freq=1,
                   truncated_freq=6, start_predicate_soft_alignment=99,
                   checkpoint_dir="", **kw)
    calls = []
    monkeypatch.setattr(vw, "valid", lambda *a, **k: 0.0)
    monkeypatch.setattr(vw, "test", lambda *a, **k: 0.0)

    def declining(trainer, embed_choice="avg", w=(1, 1, 1)):
        calls.append(embed_choice)
        v = 0.9 - 0.1 * len(calls)
        return v, v

    monkeypatch.setattr(vw, "valid_metrics", declining)
    model.run()
    return len(calls)


@pytest.mark.parametrize("enable,metric,evals", [
    (False, "mrr", 6), (True, "mrr", 3), (True, "hits1", 3)])
def test_early_stop_gate(itc, monkeypatch, enable, metric, evals):
    """Off by default (train to max_epoch); on, two declines stop it."""
    cfg, data, _ = itc
    assert _early_stop_evals(cfg, data, monkeypatch, enable_early_stop=enable,
                             stop_metric=metric) == evals


def test_driver_epoch_is_one_call(itc, monkeypatch):
    """``_run`` trains every epoch through ``train_streams_1epo``. The call
    runs five streams up to ``start_predicate_soft_alignment`` and all
    seven after it, inside one ``itc.epoch`` span, and the supervision
    lists it trains on keep their identity from call to call, so the
    trainer makes their device arrays once."""
    from torch.profiler import ProfilerActivity, profile

    from multike_tpu_torch.utils import profiling

    cfg, data, _ = itc
    model = _model(cfg, data, checkpoint_dir="", max_epoch=3,
                   start_predicate_soft_alignment=2)
    calls = []
    epoch = MultiKE_ITC.train_streams_1epo
    monkeypatch.setattr(MultiKE_ITC, "train_streams_1epo",
                        lambda self, i, *a: calls.append(i)
                        or epoch(self, i, *a))
    model.run()
    assert calls == [1, 2, 3]

    pam = model.predicate_align_model
    rel = pam.sup_relation_alignment_triples1 \
        + pam.sup_relation_alignment_triples2
    attr = pam.sup_attribute_alignment_triples1 \
        + pam.sup_attribute_alignment_triples2
    assert set(epoch(model, 2, rel, attr)) == {
        "rel_view", "ckge_rel", "attr_view", "ckge_attr", "common_space"}
    arrays = {k: v[2] for k, v in model._arr_cache.items()
              if k in ("ckge_rel", "ckge_attr", "common_space_ents")}
    assert len(arrays) == 3
    profiling.drain()
    with profile(activities=[ProfilerActivity.CPU]):
        losses = epoch(model, 3, rel, attr)
    spans = profiling.drain()["spans"]
    assert set(losses) == {"rel_view", "ckge_rel", "ckgp_rel", "attr_view",
                           "ckge_attr", "ckga_attr", "common_space"}
    assert all(np.isfinite(v) for v in losses.values())
    top = [i for i, (n, p, _, _) in enumerate(spans) if p < 0]
    assert [spans[i][0] for i in top] == ["itc.epoch"]
    assert sorted(n for n, p, _, _ in spans if p == top[0]) == sorted(
        f"{s}.epoch" for s in losses)
    assert all(model._arr_cache[k][2] is v for k, v in arrays.items())
