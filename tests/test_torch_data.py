"""The PyTorch port's data layer against the JAX package's: the synthetic
generator writes byte-identical files from the same seed, and the folder
reader builds the same id maps, triple arrays, id ranges and link splits."""
import filecmp
import os

import numpy as np
import pytest

from multike_tpu.data import kg as jkg
from multike_tpu.data import synthetic as jsyn
from multike_tpu_torch.data import kg as tkg
from multike_tpu_torch.data import synthetic as tsyn


def _files(folder):
    out = []
    for root, _, names in os.walk(folder):
        for n in names:
            out.append(os.path.relpath(os.path.join(root, n), folder))
    return sorted(out)


@pytest.fixture(scope="module")
def both_folders(tmp_path_factory):
    kw = dict(n_entities=150, n_rel_triples=700, seed=5)
    jf = jsyn.generate(str(tmp_path_factory.mktemp("jax_ds")) + "/", **kw)
    tf = tsyn.generate(str(tmp_path_factory.mktemp("torch_ds")) + "/", **kw)
    return jf, tf


def test_synthetic_generate_byte_identical(both_folders):
    jf, tf = both_folders
    names = _files(jf)
    assert names == _files(tf)
    assert "rel_triples_1" in names and "631/train_links" in names
    for n in names:
        assert filecmp.cmp(os.path.join(jf, n), os.path.join(tf, n),
                           shallow=False), n


def test_config_fields_and_load_match(tmp_path_factory):
    import dataclasses
    import json

    from multike_tpu import config as jcfg
    from multike_tpu_torch import config as tcfg

    jf = [(f.name, getattr(jcfg.Config(), f.name))
          for f in dataclasses.fields(jcfg.Config)]
    tf = [(f.name, getattr(tcfg.Config(), f.name))
          for f in dataclasses.fields(tcfg.Config)]
    assert jf == tf
    path = str(tmp_path_factory.mktemp("cfg") / "args.json")
    with open(path, "w") as f:
        json.dump({"dim": 16, "batch_size": 77, "top_k": [1, 3],
                   "row_sparse_updates": "on", "not_a_field": 1}, f)
    a = dataclasses.asdict(jcfg.load_config(path, seed=5))
    b = dataclasses.asdict(tcfg.load_config(path, seed=5))
    assert a == b and b["batch_size"] == 77 and b["seed"] == 5


@pytest.mark.parametrize("ordered", [False, True])
def test_read_kgs_from_folder_matches(both_folders, ordered):
    jf, _ = both_folders
    j = jkg.read_kgs_from_folder(jf, "631/", "swapping", ordered)
    t = tkg.read_kgs_from_folder(jf, "631/", "swapping", ordered)
    for side in ("kg1", "kg2"):
        a, b = getattr(j, side), getattr(t, side)
        assert a.entities_id_dict == b.entities_id_dict
        assert a.relations_id_dict == b.relations_id_dict
        assert a.attributes_id_dict == b.attributes_id_dict
        np.testing.assert_array_equal(a.local_relation_triples_array,
                                      b.local_relation_triples_array)
        np.testing.assert_array_equal(a.sup_relation_triples_array,
                                      b.sup_relation_triples_array)
        assert a.sup_relation_triples_list == b.sup_relation_triples_list
    for name in ("train_links", "valid_links", "test_links",
                 "valid_entities1", "valid_entities2", "test_entities1",
                 "test_entities2", "entities_num", "relations_num",
                 "attributes_num"):
        assert getattr(j, name) == getattr(t, name), name
    if not ordered:
        assert j.entity_id_ranges() == t.entity_id_ranges()


KG_VIEWS = ("relation_triples_list", "local_relation_triples_list",
            "entities_list", "relations_list", "attribute_triples_list",
            "local_attribute_triples_list", "attributes_list", "rt_dict",
            "hr_dict", "av_dict", "entity_relations_dict",
            "entity_attributes_dict", "relation_triples_num",
            "attribute_triples_num", "local_relation_triples_num",
            "local_attribute_triples_num", "entities_num")


def test_kg_views_made_at_first_read_equal_the_eager_ones(both_folders):
    """The port's KG makes its sorted lists and per-entity dicts at their
    first read (at DWY100K's size each takes seconds, and the URI-level
    KGs never read them): after the swap they equal the JAX package's,
    which makes them at once, and a KG that only carries URIs has made
    none."""
    jf, _ = both_folders
    j = jkg.read_kgs_from_folder(jf, "631/", "swapping", False)
    t = tkg.read_kgs_from_folder(jf, "631/", "swapping", False)
    for uri_kg in (t.uri_kg1, t.uri_kg2):
        assert not set(tkg.KG._RELATION_VIEWS + tkg.KG._ATTRIBUTE_VIEWS) \
            & set(vars(uri_kg))
    for side in ("kg1", "kg2"):
        a, b = getattr(j, side), getattr(t, side)
        for name in KG_VIEWS:
            assert getattr(a, name) == getattr(b, name), (side, name)


def test_kg_views_follow_the_triples():
    """Setting the attributes again (as the DataModel does when it
    re-indexes values) and adding supervision triples make the views
    anew."""
    kg = tkg.KG({(1, "r", 2), (2, "r", 3)}, {(1, "a", "x"), (3, "b", "y")})
    assert kg.av_dict == {1: {("a", "x")}, 3: {("b", "y")}}
    assert kg.relation_triples_list == [(1, "r", 2), (2, "r", 3)]
    kg.set_attributes({(2, "a", 7)})
    assert kg.av_dict == {2: {("a", 7)}}
    assert kg.attribute_triples_list == [(2, "a", 7)]
    assert kg.attributes_list == ["a"]
    kg.add_sup_attribute_triples({(1, "a", 7)})
    assert kg.attribute_triples_list == [(1, "a", 7), (2, "a", 7)]
    assert kg.local_attribute_triples_list == [(2, "a", 7)]
    kg.add_sup_relation_triples({(4, "r", 2)})
    assert kg.relation_triples_list == [(1, "r", 2), (2, "r", 3),
                                        (4, "r", 2)]
    assert kg.relation_triples_num == 3
    assert kg.local_relation_triples_list == [(1, "r", 2), (2, "r", 3)]
    kg.set_relations({(5, "q", 6)})
    assert kg.rt_dict == {5: {("q", 6)}} and kg.hr_dict == {6: {(5, "q")}}
    assert kg.entities_list == [5, 6] and kg.relations_list == ["q"]
    assert kg.entity_relations_dict == {5: {"q"}}
