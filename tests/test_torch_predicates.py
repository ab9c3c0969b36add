"""The port's predicate alignment against the JAX package's (CPU): the
Levenshtein matrix, and the alignment sets, supervision 4-tuples and
weighted triples at initialisation and after each refresh from the same
embeddings; the ``version`` counter moves alike."""
import numpy as np
import pytest

from multike_tpu.align import predicates as jpred
from multike_tpu.config import Config as JConfig
from multike_tpu.data.kg import read_kgs_from_folder as jread_kgs
from multike_tpu.utils import native as jnative
from multike_tpu_torch.align import predicates as tpred
from multike_tpu_torch.config import Config
from multike_tpu_torch.data import synthetic
from multike_tpu_torch.data.kg import read_kgs_from_folder
from multike_tpu_torch.utils import native as tnative

FIELDS = ("version", "relation_alignment_set", "attribute_alignment_set",
          "relation_id_alignment_set", "attribute_id_alignment_set",
          "train_relations1", "train_relations2", "train_attributes1",
          "train_attributes2",
          "sup_relation_alignment_triples1", "sup_relation_alignment_triples2",
          "sup_attribute_alignment_triples1",
          "sup_attribute_alignment_triples2",
          "relation_triples_w_weights1", "relation_triples_w_weights2",
          "attribute_triples_w_weights1", "attribute_triples_w_weights2")


def test_levenshtein_matrix_equal():
    names1 = ["birth date", "name", "zzz", "", "relation kadobe", "héllo"]
    names2 = ["birth date", "naame", "relation kadobi", "date of birth", "",
              "hello"]
    py = tnative.lev_ratio_matrix_py(names1, names2)
    np.testing.assert_array_equal(
        tnative.levenshtein_ratio_matrix(names1, names2), py)
    np.testing.assert_array_equal(
        jnative.levenshtein_ratio_matrix(names1, names2), py)
    assert py[0, 0] == 1.0 and py[3, 4] == 1.0


def test_helpers_equal_jax():
    d1 = {"p1": "birth date", "p2": "name", "p3": "zzz"}
    d2 = {"q1": "birth date", "q2": "naame"}
    assert tpred.init_predicate_alignment(d1, d2, 0.9) == \
        jpred.init_predicate_alignment(d1, d2, 0.9)
    emb = np.array([[1, 0], [0, 1], [0.9, 0.1], [0.1, 0.9]], np.float32)
    assert tpred.find_predicate_alignment_by_embedding(emb, [0, 1], [2, 3]) \
        == jpred.find_predicate_alignment_by_embedding(emb, [0, 1], [2, 3])
    assert tpred.zoom_weight(0.925, 0.85) == jpred.zoom_weight(0.925, 0.85)


@pytest.fixture(scope="module")
def pams(tmp_path_factory):
    folder = synthetic.generate(str(tmp_path_factory.mktemp("pa")) + "/",
                                seed=4, n_relations=12, n_attributes=8)
    kw = dict(training_data=folder)
    port = tpred.PredicateAlignModel(
        read_kgs_from_folder(folder, "631/", "swapping", False), Config(**kw))
    ref = jpred.PredicateAlignModel(
        jread_kgs(folder, "631/", "swapping", False), JConfig(**kw))
    return port, ref


def _assert_same(port, ref):
    for f in FIELDS:
        assert getattr(port, f) == getattr(ref, f), f


def test_predicate_alignment_equal_jax(pams):
    port, ref = pams
    _assert_same(port, ref)
    assert len(port.relation_alignment_set) > 0
    assert len(port.sup_relation_alignment_triples1) > 0
    rng = np.random.RandomState(0)
    for ptype, num in (("relation", port.kgs.relations_num),
                       ("attribute", port.kgs.attributes_num)):
        # embeddings that keep some predicate pairs above the soft cut
        emb = rng.normal(size=(num, 6)).astype(np.float32)
        half = num // 2
        emb[half:2 * half] = emb[:half] + 0.3 * rng.normal(size=(half, 6))
        port.update_predicate_alignment(emb, predicate_type=ptype)
        ref.update_predicate_alignment(emb, predicate_type=ptype)
        _assert_same(port, ref)
    assert port.version == 4


def _add_weights_by_sets(predicate_links, triples1, triples2, min_w_before):
    """``add_weights`` as it was written before it made each list in one
    pass: a set of weighted rows a KG, then sorted."""
    dic1, dic2 = tpred.link2dic(predicate_links)

    def weight_triples(triples, dic):
        out = set()
        for (s, p, o) in triples:
            if p in dic:
                out.add((s, p, o, tpred.zoom_weight(dic[p][1], min_w_before)))
            else:
                out.add((s, p, o, tpred.UNALIGNED_WEIGHT))
        return out

    w1 = weight_triples(triples1, dic1)
    w2 = weight_triples(triples2, dic2)
    return sorted(w1), sorted(w2), w1, w2


@pytest.mark.parametrize("presorted", [True, False])
def test_add_weights_equals_the_set_version(presorted):
    rng = np.random.RandomState(2)
    trip = [sorted({tuple(int(x) for x in row) for row in
                    rng.randint(0, n, size=(3000, 3))}) for n in (40, 50)]
    if not presorted:
        for t in trip:
            rng.shuffle(t)
    links = {(1, 41, 0.95), (3, 45, 0.875), (7, 49, 0.99)}
    assert tpred.add_weights(links, *trip, 0.85) == \
        _add_weights_by_sets(links, *trip, 0.85)
