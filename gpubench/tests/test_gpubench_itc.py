"""The ``itc`` traffic kind on the CPU at a small size: a run of the cell
``itc-dwy100k`` is correct, its traced run reports the program's own
``.itc`` readers, the control (the reference in TF32) and broken timed
paths are not correct, and a program without the driver's epoch method
fails at once. Also the seeded pair and the ITC operation counts."""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from conftest import ROOT
from gpubench import faults, run
from gpubench.lib import bounds, bounds_itc, itc_data, spec
from gpubench.readings import readings
from multike_tpu_torch.utils import profiling

CELL = "itc-dwy100k"
SMALL = {"entities_per_kg": 300, "triples": [1400, 1300], "relations": [6, 5],
         "attributes": [7, 9], "attribute_triples": [900, 1100],
         "shared_names": {"relations": 2, "attributes": 3},
         "neighbor_sample": 64,
         "config": {"batch_size": 500, "entity_batch_size": 200,
                    "attribute_batch_size": 500, "truncated_chunk_size": 128,
                    "truncated_pool_size": 16, "row_sparse_updates": "on"}}
SEED = 2**31 + 17
PROGRAM = ("itc_epoch_host_ms.itc", "attr_streams_host_ms.itc",
           "rel_streams_host_ms.itc")


def _limits():
    return json.load(open(os.path.join(ROOT, "gpubench", "limits",
                                       CELL + ".json")))


def test_a_small_run_is_correct():
    out = run.run_cell(CELL, SEED, 0.01, False, torch.device("cpu"),
                       mix_overrides=SMALL)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"rel_card_ms_per_step", "setup_s"}
    assert list(out["checks"]) == list(_limits())


def test_traced_run_reads_the_program_record(monkeypatch):
    drained = []
    drain = profiling.drain
    monkeypatch.setattr(profiling, "drain",
                        lambda: drained.append(drain()) or drained[-1])
    out = run.run_cell(CELL, SEED, 0.3, True, torch.device("cpu"),
                       mix_overrides=SMALL)
    assert out["correct"], out["checks"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(PROGRAM) <= set(got) and "rel_triples_per_s.traced" in got
    assert all(got[k] > 0 for k in PROGRAM), got
    assert got["attr_streams_host_ms.itc"] + got["rel_streams_host_ms.itc"] \
        < got["itc_epoch_host_ms.itc"]
    rec = drained[0]
    by_name, counters = rec["by_name"], rec["counters"]
    epochs = by_name["itc.epoch"]["count"]
    # the CNN scorer's span in every CNN-scored step, its rows (the
    # attribute view alone scores every attribute triple an epoch), and
    # K1's counters (row_sparse_updates "on")
    cnn_steps = sum(by_name[f"{s}.step"]["count"]
                    for s in ("attr_view", "ckge_attr", "ckga_attr"))
    assert by_name["step.conv"]["count"] == cnn_steps
    mix = {**spec.traffic("dwy100k-itc"), **SMALL}
    attr_triples = sum(mix["attribute_triples"])
    assert counters["conv.rows"] >= epochs * attr_triples
    assert 0 < counters["apply.unique"] <= counters["apply.ids"]


def test_the_control_fails_and_the_program_does_not():
    limits = _limits()
    for line in readings(CELL, [5, 6], 2, torch.device("cpu"), SMALL,
                         emit=lambda _: None):
        assert not [k for k, v in line["program"].items() if v > limits[k]]
        assert [k for k, v in line["control"].items() if v > limits[k]]


@pytest.mark.parametrize("fault", ["state_unchanged", "same_padding_flipped"])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    """A step that leaves the dense tables unchanged (faults.py), and the
    CNN scorer with its SAME padding's extra row and column before the
    image instead of after it."""
    if fault == "same_padding_flipped":
        from multike_tpu_torch.views import attr_conv

        monkeypatch.setattr(attr_conv, "SAME_PAD", (2, 1, 1, 0))
        out = run.run_cell(CELL, 9, 0.01, False, torch.device("cpu"),
                           mix_overrides=SMALL)
    else:
        with faults.planted(fault, False):
            out = run.run_cell(CELL, 9, 0.01, False, torch.device("cpu"),
                               mix_overrides=SMALL)
    assert not out["correct"], out["checks"]


def test_a_program_without_the_epoch_method_fails_at_once(monkeypatch):
    from multike_tpu_torch.train.itc import MultiKE_ITC

    monkeypatch.delattr(MultiKE_ITC, "train_streams_1epo")
    with pytest.raises(RuntimeError, match="train_streams_1epo"):
        run.run_cell(CELL, 9, 0.01, False, torch.device("cpu"),
                     mix_overrides=SMALL)


def test_itc_readers_return_none_without_what_they_read():
    empty = {"spans": [], "counters": {}, "by_name": {}}
    trace = {"device_ops": 0, "busy_s": 0.0, "range_device_s": {}}
    for m in spec.benchmark()["per_layer"]:
        if m["name"].endswith(".itc"):
            read = spec.metric_reader(m["name"])
            for program in (None, empty):
                assert read({"program": program, "counters": {},
                             "trace": trace, "window_s": 1.0,
                             "card": "cpu"}) is None, m["name"]


def test_k1_roofline_reads_the_program_counters():
    from gpubench.lib.peaks import card_peaks

    read = spec.metric_reader("k1_roofline_pct.itc")
    card = "NVIDIA H100 80GB HBM3"
    run_ = {"program": {"spans": [], "by_name": {},
                        "counters": {"apply.ids": 60_000,
                                     "apply.unique": 51_891}},
            "counters": {"dim": 75}, "window_s": 1.0, "card": card,
            "trace": {"device_ops": 5, "range_device_s": {"k1": 1e-4}}}
    want = 100 * bounds.k1_bytes(60_000, 51_891, 75) / (
        1e-4 * card_peaks(card)[0])
    assert read(run_) == pytest.approx(want)


def test_itc_bounds_match_hand_counts():
    d = 75
    # one scorer: gamma, beta (2d); conv0 2*4*1*2 + 2; conv1 2*4*2*2 + 2;
    # dense 4d x d + d
    assert bounds_itc.conv_params(d) == 2 * d + 18 + 34 + 4 * d * d + d
    # a row: head norm 3d, batch norm 2 x 2d, conv0 2d x 2 maps x (2*8*1
    # + 2), conv1 2d x 2 x (2*8*2 + 2), l2 3 x 4d, dense d x (2 x 4d + 2),
    # norm 3d, score 3d, loss 3
    row = 3 * d + 4 * d + 4 * d * 18 + 4 * d * 34 + 12 * d \
        + d * (8 * d + 2) + 6 * d + 3
    assert bounds_itc.conv_row_flops(d) == row
    assert bounds_itc.conv_step_flops(d, 10, 7) == \
        10 * row * 3 + 6 * (7 * d + bounds_itc.conv_params(d))
    assert bounds_itc.transe_pos_step_flops(d, 10, 7) == \
        10 * (13 * d + 2) * 3 + 6 * 7 * d
    assert bounds_itc.common_space_step_flops(d, 10, 21) == \
        10 * 18 * d * 3 + 6 * 21 * d


def test_the_seeded_pair():
    mix = {**spec.traffic("dwy100k-itc"), **SMALL}
    p = itc_data.pair(SEED, mix)
    q = itc_data.pair(SEED, mix)
    assert all(np.array_equal(a, b) for a, b in zip(p["rel"], q["rel"]))
    n = mix["entities_per_kg"]
    for k in range(2):
        rel, attr = p["rel"][k], p["attr"][k]
        lo, hi = k * n, (k + 1) * n
        # every entity heads a relation triple; ids in their KG's ranges
        assert set(rel[:, 0].tolist()) == set(range(lo, hi))
        assert rel[:, [0, 2]].min() >= lo and rel[:, [0, 2]].max() < hi
        assert len(np.unique(rel, axis=0)) == len(rel)
        r0, a0 = p["rel_lo"][k], p["attr_lo"][k]
        assert rel[:, 1].min() >= r0 and \
            rel[:, 1].max() < r0 + mix["relations"][k]
        assert attr[:, 1].min() >= a0 and \
            attr[:, 1].max() < a0 + mix["attributes"][k]
        assert abs(len(rel) - mix["triples"][k]) <= 2
    assert np.concatenate(p["attr"])[:, 2].max() < p["values"]
    links = np.concatenate(list(p["links"].values()))
    assert sorted(links[:, 0].tolist()) == list(range(n))
    assert sorted(links[:, 1].tolist()) == list(range(n, 2 * n))
    assert len(p["links"]["train"]) == int(0.3 * n)
    for names, shared in ((p["rel_names"], 2), (p["attr_names"], 3)):
        assert len(set(names[0]) & set(names[1])) == shared
