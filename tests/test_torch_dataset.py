"""The port's DataModel against the JAX package's on one synthetic KG pair
(CPU): the literal list, the value ids, both KGs' attribute sets and the
swapped supervision attribute triples are equal; with the JAX DataModel's
literal vectors read back through the cache (``retrain_literal_embeds``
off), the name and value matrices are bit-equal."""
import os

import numpy as np
import pytest
import torch

from multike_tpu.config import Config as JConfig
from multike_tpu.data.dataset import DataModel as JDataModel
from multike_tpu_torch.config import Config
from multike_tpu_torch.data import synthetic
from multike_tpu_torch.data.dataset import LITERAL_EMBEDDINGS_FILE, DataModel


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the steps here are many tiny ops, which the
    thread pool slows by orders of magnitude when test workers share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _kw(folder):
    return dict(training_data=folder, dim=8, batch_size=256, encoder_epoch=1,
                word2vec_path=folder + "mini_word2vec.vec")


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    folder = synthetic.generate(str(tmp_path_factory.mktemp("dm")) + "/",
                                seed=5)
    port = DataModel(Config(**_kw(folder)), device="cpu")
    ref = JDataModel(JConfig(**_kw(folder)))      # rewrites the cache
    cached = DataModel(Config(retrain_literal_embeds=False, **_kw(folder)),
                       device="cpu")
    return folder, port, ref, cached


def test_datamodel_tables_equal_jax(models):
    _, port, ref, _ = models
    assert port.literal_list == ref.literal_list
    assert port.values_id_dic == ref.values_id_dic
    assert port.literal_id_dic == ref.literal_id_dic
    for kg, rkg in ((port.kgs.kg1, ref.kgs.kg1), (port.kgs.kg2, ref.kgs.kg2)):
        assert kg.local_attribute_triples_set == rkg.local_attribute_triples_set
        assert kg.local_attribute_triples_list == \
            rkg.local_attribute_triples_list
        assert kg.sup_attribute_triples_list == rkg.sup_attribute_triples_list
        assert kg.attributes_id_dict == rkg.attributes_id_dict
    assert len(port.kgs.kg1.sup_attribute_triples_list) > 0
    n = port.kgs.entities_num
    assert port.local_name_vectors.shape == ref.local_name_vectors.shape \
        == (n, 8)
    assert port.value_vectors.shape == ref.value_vectors.shape
    norms = np.linalg.norm(port.local_name_vectors, axis=1)
    np.testing.assert_allclose(norms[norms > 1e-6], 1.0, atol=1e-4)


def test_datamodel_from_cache_is_bit_equal(models):
    folder, _, ref, cached = models
    assert os.path.exists(os.path.join(folder, LITERAL_EMBEDDINGS_FILE))
    assert cached.literal_list == ref.literal_list
    np.testing.assert_array_equal(cached.literal_vectors_mat,
                                  ref.literal_vectors_mat)
    np.testing.assert_array_equal(cached.local_name_vectors,
                                  ref.local_name_vectors)
    np.testing.assert_array_equal(cached.value_vectors, ref.value_vectors)
    assert cached.local_name_vectors.dtype == np.float32
