"""End to end on a synthetic KG pair: the port's ``MultiKETrainer`` trains
the relation view (plus the swapped-supervision stream that carries its
cross-KG signal) on the CPU, ``views.valid_metrics`` ranks it, and the rv
valid MRR must rise and land within a band of the JAX package's rv MRR on
the same KGs and config.

The JAX side runs ``streams.build_rel_view_epoch`` / ``build_ckge_rel_epoch``
and ``evaluation.valid`` directly (its ``MultiKETrainer`` needs a full
``DataModel``). Band: over seeds 0-9 at this config (300 entities per KG,
d=16, 15 epochs) the port's final MRR had mean 0.870 (sd 0.029) and the JAX
package's 0.877 (sd 0.030); the per-seed difference has sd about 0.042, so
the means of 3 seeds differ by 0.024 sd and are held within 0.08."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multike_tpu.config import Config as JConfig
from multike_tpu.data.kg import read_kgs_from_folder as jax_read_kgs
from multike_tpu.data.kg import triples_to_array
from multike_tpu.eval import evaluation as jeva
from multike_tpu.params import init_params as jax_init_params
from multike_tpu.params import l2_normalize as jax_l2_normalize
from multike_tpu.train import streams as jst
from multike_tpu_torch.config import Config
from multike_tpu_torch.data import synthetic
from multike_tpu_torch.data.kg import read_kgs_from_folder
from multike_tpu_torch.eval import views
from multike_tpu_torch.train.trainer import MultiKETrainer

KW = dict(dim=16, batch_size=200, neg_triple_num=5, learning_rate=0.05,
          row_sparse_updates=True)
EPOCHS = 15
SEEDS = (0, 1, 2)
BAND = 0.08


class _Data:
    """The part of a DataModel the port's trainer reads in this slice."""

    def __init__(self, kgs):
        self.kgs = kgs


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return synthetic.generate(str(tmp_path_factory.mktemp("slice")) + "/",
                              n_entities=300, n_rel_triples=1500, seed=3)


def _sup(kgs):
    return kgs.kg1.sup_relation_triples_list + kgs.kg2.sup_relation_triples_list


def _port_mrr(folder, seed):
    kgs = read_kgs_from_folder(folder, "631/", "swapping", False)
    trainer = MultiKETrainer(Config(seed=seed, **KW), _Data(kgs),
                             verbose=False, device="cpu")
    before = views.valid_metrics(trainer, "rv")[1]
    sup = _sup(kgs)
    for ep in range(1, EPOCHS + 1):
        loss = trainer.train_relation_view_1epo(ep)
        trainer.train_cross_kg_entity_inference_relation_view_1epo(ep, sup)
        assert np.isfinite(loss)
    after = views.valid_metrics(trainer, "rv")[1]
    test_mrr = views.test(trainer, "rv")
    assert 0.0 < test_mrr <= 1.0
    return before, after


def _jax_mrr(folder, seed):
    kgs = jax_read_kgs(folder, "631/", "swapping", False)
    cfg = JConfig(seed=seed, **KW)
    params = jax_init_params(cfg, kgs.entities_num, kgs.relations_num,
                             kgs.attributes_num)
    opt = jst.init_stream_opt_states(cfg, params)
    rt1 = jnp.asarray(triples_to_array(kgs.kg1.local_relation_triples_set))
    rt2 = jnp.asarray(triples_to_array(kgs.kg2.local_relation_triples_set))
    sup = jnp.asarray(np.asarray(_sup(kgs), np.int32))
    rv_epoch, _, _ = jst.build_rel_view_epoch(
        cfg, len(rt1), len(rt2), kgs.entity_id_ranges(), with_neighbors=False)
    ckge_epoch, _, _ = jst.build_ckge_rel_epoch(cfg, len(sup))
    key = jax.random.PRNGKey(seed)
    for _ in range(EPOCHS):
        params, opt["rel_view"], key, _ = rv_epoch(
            params, opt["rel_view"], key, rt1, rt2)
        params, opt["ckge_rel"], key, _ = ckge_epoch(
            params, opt["ckge_rel"], key, sup)
    e = jax_l2_normalize(params["rv_ent"], axis=1)
    e1 = e[np.asarray(kgs.valid_entities1)]
    e2 = e[np.asarray(kgs.valid_entities2 + kgs.test_entities2)]
    return jeva.valid(e1, e2, None, cfg.top_k, 1, normalize=True,
                      use_pallas=False, verbose=False)[1]


def test_rel_view_slice_improves_and_matches_jax_band(folder):
    port, ref = [], []
    for seed in SEEDS:
        before, after = _port_mrr(folder, seed)
        assert after > before + 0.3, (seed, before, after)
        port.append(after)
        ref.append(_jax_mrr(folder, seed))
    assert abs(np.mean(port) - np.mean(ref)) <= BAND, (port, ref)


def test_entry_points_need_cuda_or_explicit_cpu(folder):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    kgs = read_kgs_from_folder(folder, "631/", "swapping", False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiKETrainer(Config(**KW), _Data(kgs), verbose=False)
    e = np.eye(3, dtype=np.float32)
    from multike_tpu_torch.eval.alignment import rank_and_align

    with pytest.raises(RuntimeError):
        rank_and_align(e, e)
    assert [r.tolist() for r in rank_and_align(e, e, device="cpu")] == \
        [[0, 0, 0], [0, 1, 2]]


def test_mesh_config_raises(folder):
    """A mesh needs a process group of mesh_dp * mesh_tp ranks: without
    one the trainer raises, and does not train on one rank instead."""
    kgs = read_kgs_from_folder(folder, "631/", "swapping", False)
    with pytest.raises(RuntimeError, match="needs a process group of 2"):
        MultiKETrainer(Config(mesh_dp=2, **KW), _Data(kgs), verbose=False,
                       device="cpu")
