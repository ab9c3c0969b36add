"""The per-layer metrics read from the program's own record (the port's
tracer, ``multike_tpu_torch.utils.profiling``): a traced CPU run of each
cell at a small size reports them, the program's step span agrees with the
benchmark's own ``step`` span around the same calls, and an untraced run
reports none of them."""
from __future__ import annotations

import pytest
import torch

from gpubench import run
from gpubench.lib import spec
from multike_tpu_torch.utils import profiling

SMALL = {"entities_per_kg": 400, "triples": [1500, 1400],
         "relations": [6, 5]}
MIXES = {
    "rv-dwy100k-chunk-b80k": dict(SMALL, config={"batch_size": 1000,
                                                 "neg_pool_size": 64}),
    "rv-dwy100k-perslot-trunc": dict(SMALL, config={"batch_size": 500},
                                     neighbors={"useful_share": 0.3,
                                                "k": 20}),
}
SEED = 2**31 + 11


def _program_metrics(cell):
    return {m["name"] for m in spec.metrics_of(spec.benchmark(), "per_layer",
                                               cell)
            if m["source"] in ("program_span", "program_counter")}


@pytest.mark.parametrize("cell", sorted(MIXES))
def test_traced_run_reads_the_program_record(cell, monkeypatch):
    drained = []
    drain = profiling.drain
    monkeypatch.setattr(profiling, "drain",
                        lambda: drained.append(drain()) or drained[-1])
    names = _program_metrics(cell)
    assert len(names) == (6 if cell.endswith("trunc") else 5)
    out = run.run_cell(cell, SEED, 0.5, True, torch.device("cpu"),
                       mix_overrides=MIXES[cell])
    assert out["correct"]
    got = {k: v["value"] for k, v in out["metrics"].items() if k in names}
    assert set(got) == names
    assert all(v > 0 for v in got.values()), got
    assert len(drained) == 1

    by_name = drained[0]["by_name"]
    suffix = "card" if cell.endswith("trunc") else "rv"
    step = by_name["rel_view.step"]
    inside_ms = step["total_ns"] / step["count"] / 1e6
    outside_ms = out["metrics"][f"step_dispatch_ms.{suffix}"]["value"]
    assert inside_ms == pytest.approx(outside_ms, rel=0.2)
    # the five host metrics partition the program's epoch spans
    epochs = by_name["rel_view.epoch"]["count"]
    steps = step["count"]
    parts = got[f"sampling_host_ms.{suffix}"] * epochs + steps * sum(
        got[f"{k}_host_ms.{suffix}"]
        for k in ("loss", "backward", "apply", "loop"))
    assert parts == pytest.approx(
        by_name["rel_view.epoch"]["total_ns"] / 1e6, rel=1e-6)


def test_untraced_run_reports_none_of_them():
    cell = "rv-dwy100k-perslot-trunc"
    out = run.run_cell(cell, SEED, 0.2, False, torch.device("cpu"),
                       mix_overrides=MIXES[cell])
    assert not set(out["metrics"]) & _program_metrics(cell)
    assert set(out["metrics"]) == {"rel_card_ms_per_step", "setup_s"}


def test_readers_return_none_without_the_program_tracer():
    """A program without the tracer, or a record without the spans: no
    value, and no error."""
    empty = {"spans": [], "counters": {}, "by_name": {}}
    for name in _program_metrics("rv-dwy100k-perslot-trunc") | \
            _program_metrics("rv-dwy100k-chunk-b80k"):
        read = spec.metric_reader(name)
        assert read({"program": None}) is None
        assert read({"program": empty}) is None
