"""The port's tracer (utils/profiling.py) on the CPU.

* With no profiler session, ``span`` is one shared null context that enters
  no ``record_function``, and nothing is recorded.
* Under a CPU ``torch.profiler`` session, tiny relation-view epochs (per-slot
  truncated with Bloom "drop" on the row-sparse path, chunk-shared on the
  dense path) and a sampled stream's epoch give the span tree the program
  is built to give; every span lies inside the profiler's event of the same
  name, their starts and ends within 0.2 ms of each other (the shared
  clock), self times partition the epoch span, and the drop counter equals
  the epoch's own count.
* On the card, the chunk-shared loss's kernel counts its pairs under a
  session only (skipped without a card).
* The record restarts with a new session and at each ``trace``, which
  writes it beside the Chrome trace.
"""
import json
from collections import Counter

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from multike_tpu_torch import params as tp
from multike_tpu_torch import sampling as ts
from multike_tpu_torch.config import Config
from multike_tpu_torch.eval.alignment import rank_and_align
from multike_tpu_torch.train import streams as tst
from multike_tpu_torch.utils import profiling

E, R, D = 40, 5, 8
RANGES = ((0, 20), (20, 40))
CFG = dict(dim=D, batch_size=64, neg_triple_num=3, learning_rate=0.05,
           neg_chunk_size=8, neg_pool_size=4, truncated_chunk_size=8,
           truncated_pool_size=4)


@pytest.fixture(autouse=True)
def _empty_record():
    profiling.drain()
    yield
    profiling.drain()


def _rows(rng, n, lo, hi):
    return torch.as_tensor(np.stack([rng.randint(lo, hi, n),
                                     rng.randint(0, R, n),
                                     rng.randint(lo, hi, n)], 1))


def _data(seed=0):
    rng = np.random.RandomState(seed)
    t1, t2 = _rows(rng, 200, 0, 20), _rows(rng, 150, 20, 40)
    nbr = ts.build_neighbor_state(E, [
        (np.arange(0, 20), rng.randint(0, 20, (20, 4))),
        (np.arange(20, 40), rng.randint(20, 40, (20, 4)))])
    tf = ts.build_triple_filter(torch.cat([t1, t2]).numpy(), log2m=14)
    return t1, t2, nbr, tf


def _rel_view(scheme, **kw):
    """An epoch callable of ``scheme`` and a function that runs it once."""
    t1, t2, nbr, tf = _data()
    cfg = Config(**CFG, **kw)
    params = tp.init_params(cfg, E, R, 2, device="cpu")
    opt = tst.init_stream_opt_states(cfg, params)["rel_view"]
    if scheme == "ckge_rel":
        epoch, steps, _ = tst.build_ckge_rel_epoch(cfg, len(t1))
        gen = torch.Generator().manual_seed(0)
        return epoch, steps, lambda: epoch(params, opt, gen, t1)
    truncated = scheme == "per_slot"
    epoch, steps, _ = tst.build_rel_view_epoch(
        cfg, len(t1), len(t2), RANGES, with_neighbors=truncated, tfilter=tf)
    gen = torch.Generator().manual_seed(0)
    return epoch, steps, lambda: epoch(params, opt, gen, t1, t2, nbr)


def _tree(spans):
    """Counts of (name, parent's name) pairs."""
    return Counter((n, spans[p][0] if p >= 0 else None)
                   for n, p, _, _ in spans)


def _step_tree(stream, steps):
    tree = Counter({(f"{stream}.step", f"{stream}.epoch"): steps})
    for part in ("gather", "forward", "backward", "apply"):
        tree[(f"step.{part}", f"{stream}.step")] = steps
    return tree


def _expected(scheme, steps):
    stream = "ckge_rel" if scheme == "ckge_rel" else "rel_view"
    tree = _step_tree(stream, steps)
    tree[(f"{stream}.epoch", None)] = 1
    if scheme == "ckge_rel":
        return tree
    tree[("rel_view.draw", "rel_view.epoch")] = 1
    tree[("draw.positives", "rel_view.draw")] = 1
    if scheme == "per_slot":
        # one negatives draw per KG, each with one Bloom pass ("drop")
        tree[("draw.negatives", "rel_view.draw")] = 2
        tree[("draw.bloom", "draw.negatives")] = 2
    else:
        tree[("draw.negatives", "rel_view.draw")] = 1
    return tree


def test_off_span_is_one_null_context_and_records_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError("a range was entered with no session")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    a, b = profiling.span("rel_view.step"), profiling.span("step.apply")
    assert a is b
    with profiling.span("rel_view.epoch"):
        profiling.count("sampling.slots", 3)
    epoch, steps, run = _rel_view("per_slot", neg_reject_mode="drop")
    run()
    rec = profiling.drain()
    assert rec == {"spans": [], "counters": {}, "by_name": {}}


@pytest.mark.parametrize("scheme,kw", [
    ("per_slot", dict(truncated_neg_scheme="per_slot",
                      neg_reject_mode="drop", row_sparse_updates="on")),
    ("chunk_shared", dict(neg_scheme="chunk_shared",
                          row_sparse_updates="off")),
    ("ckge_rel", dict(row_sparse_updates="off")),
])
def test_session_gives_the_span_tree_on_the_profiler_clock(scheme, kw):
    epoch, steps, run = _rel_view(scheme, **kw)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # the first range of a process pays a one-time set-up
        with profiling.span("eval.rank"):
            pass
        profiling.drain()
        run()
    rec = profiling.drain()
    spans = rec["spans"]
    assert _tree(spans) == _expected(scheme, steps)
    assert {n for n, _, _, _ in spans} <= set(profiling.SPANS)
    assert set(rec["counters"]) <= set(profiling.COUNTERS)

    # every span lies inside the profiler's event of the same name, and
    # the two start and end within 0.2 ms of each other but where a pause
    # of the host falls between the two clock reads (one was seen of 5 ms)
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU and e.name() in profiling.SPANS:
            events.setdefault(e.name(), []).append((e.start_ns(),
                                                    e.end_ns()))
    offsets = []
    for name in {n for n, _, _, _ in spans}:
        ours = sorted((s, e) for n, _, s, e in spans if n == name)
        theirs = sorted(events[name])[-len(ours):]
        for (s0, e0), (s1, e1) in zip(ours, theirs):
            assert s1 <= s0 < e0 <= e1, name
            offsets += [s0 - s1, e1 - e0]
    assert np.median(offsets) < 200_000
    assert np.mean(np.array(offsets) < 200_000) > 0.9

    # self times partition the epoch span
    by_name = rec["by_name"]
    top = [n for n, p, _, _ in spans if p < 0]
    assert len(top) == 1
    whole = by_name[top[0]]["total_ns"]
    assert sum(v["self_ns"] for v in by_name.values()) == \
        pytest.approx(whole, rel=1e-3)
    assert all(v["self_ns"] >= 0 for v in by_name.values())

    if scheme == "per_slot":
        assert rec["counters"]["sampling.dropped"] == float(epoch.dropped)
        assert rec["counters"]["sampling.slots"] == epoch.slots
        assert 0 < rec["counters"]["sampling.dropped"] < epoch.slots
    else:
        assert rec["counters"] == {}


@pytest.mark.cuda
def test_chunk_pairs_counted_under_a_session_only():
    """Each launch of K3, the chunk-shared loss's kernel, adds its pairs
    (NC x S x 2C) to loss.chunk_pairs while a profiler session runs, and
    nothing without one: a chunk-shared epoch on the card counts every
    step's pairs of both KGs. (The CPU's plain version counts nothing: the
    chunk_shared case above.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the counter counts the kernel's "
                    "launches, and the kernel has no CPU mode")
    dev = torch.device("cuda")
    t1, t2, _, _ = _data()
    cfg = Config(**CFG, neg_scheme="chunk_shared", row_sparse_updates="off")
    params = tp.init_params(cfg, E, R, 2, device=dev)
    opt = tst.init_stream_opt_states(cfg, params)["rel_view"]
    epoch, steps, _ = tst.build_rel_view_epoch(cfg, len(t1), len(t2), RANGES)
    gen = torch.Generator(device=dev).manual_seed(0)
    t1, t2 = t1.to(dev), t2.to(dev)
    epoch(params, opt, gen, t1, t2)
    assert profiling.drain() == {"spans": [], "counters": {}, "by_name": {}}
    with profile(activities=[ProfilerActivity.CPU]):
        epoch(params, opt, gen, t1, t2)
    rec = profiling.drain()
    pairs = steps * (epoch.nc1 * epoch.s1 + epoch.nc2 * epoch.s2) \
        * 2 * epoch.pool
    assert rec["counters"] == {"loss.chunk_pairs": pairs}
    assert rec["by_name"]["rel_view.step"]["count"] == steps


def test_resample_draws_are_spans_of_the_epoch():
    """The in-step resample path: one draw of the positives, then each
    step's negatives, every one inside rel_view.draw."""
    epoch, steps, run = _rel_view("per_slot", truncated_neg_scheme="per_slot",
                                  neg_reject_mode="resample")
    assert not epoch.presample
    with profile(activities=[ProfilerActivity.CPU]):
        run()
    tree = _tree(profiling.drain()["spans"])
    assert tree[("rel_view.draw", "rel_view.epoch")] == 1 + steps
    assert tree[("draw.positives", "rel_view.draw")] == 1
    assert tree[("draw.negatives", "rel_view.draw")] == 2 * steps
    assert tree[("draw.bloom", "draw.negatives")] >= 2 * steps
    assert tree[("rel_view.step", "rel_view.epoch")] == steps


def test_a_new_session_starts_a_fresh_record(tmp_path):
    _, steps, run = _rel_view("chunk_shared")
    with profile(activities=[ProfilerActivity.CPU]):
        run()
    run()            # untraced work between sessions, as set-up is
    with profile(activities=[ProfilerActivity.CPU]):
        run()
    assert profiling.drain()["by_name"]["rel_view.epoch"]["count"] == 1

    with profile(activities=[ProfilerActivity.CPU]):
        run()
    with profiling.trace(str(tmp_path)):   # straight after another session
        run()
    assert (tmp_path / "trace.json").exists()
    written = json.loads((tmp_path / "spans.json").read_text())
    assert written["by_name"]["rel_view.epoch"]["count"] == 1
    assert written["by_name"]["rel_view.step"]["count"] == steps
    assert profiling.drain()["spans"] == []


def test_setup_and_evaluation_spans():
    rng = np.random.RandomState(3)
    e1, e2 = torch.randn(30, D), torch.randn(40, D)
    with profile(activities=[ProfilerActivity.CPU]):
        ts.build_triple_filter(_rows(rng, 50, 0, 20).numpy(), log2m=12)
        rank_and_align(e1, e2)
    assert _tree(profiling.drain()["spans"]) == Counter(
        {("setup.triple_filter", None): 1, ("eval.rank", None): 1})


def test_every_stream_has_its_spans():
    assert set(profiling.STREAMS) == set(tst.STREAM_SPEC)
    assert len(set(profiling.SPANS)) == len(profiling.SPANS)
    for s in tst.STREAM_SPEC:
        assert {f"{s}.epoch", f"{s}.step"} <= set(profiling.SPANS)


def _k1_case(dev):
    from multike_tpu_torch.kernels.apply_kernel import row_adagrad

    param = torch.zeros(10, 4, device=dev)
    acc = torch.full_like(param, 0.1)
    # 12 lies outside the 10-row table and touches nothing
    ids = torch.tensor([1, 3, 3, 12, 1, 0], device=dev)
    g = torch.ones(6, 4, device=dev)
    return lambda: row_adagrad(param, acc, ids, g, 0.1)


def test_k1_counts_its_ids_and_rows_under_a_session_only():
    """Each call of K1 (here its CPU plain version) adds its ids to
    ``apply.ids`` and the distinct rows they touch to ``apply.unique``
    while a profiler session runs, and nothing without one."""
    call = _k1_case("cpu")
    call()
    assert profiling.drain()["counters"] == {}
    with profile(activities=[ProfilerActivity.CPU]):
        call()
        call()
    assert profiling.drain()["counters"] == {"apply.ids": 12,
                                             "apply.unique": 6}


@pytest.mark.cuda
def test_k1_counts_its_rows_on_the_card():
    """On the card ``apply.unique`` is the kernel's own count of the rows
    it touched, copied once a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the count is the kernel's, which "
                    "has no CPU mode")
    call = _k1_case(torch.device("cuda"))
    call()
    assert profiling.drain()["counters"] == {}
    with profile(activities=[ProfilerActivity.CPU]):
        call()
        call()
    assert profiling.drain()["counters"] == {"apply.ids": 12,
                                             "apply.unique": 6}
