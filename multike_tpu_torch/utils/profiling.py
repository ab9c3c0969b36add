"""The port's tracer (counterpart of multike_tpu/utils/profiling.py).

  * ``span(name)``: a context manager around one piece of the program's
    work. While a ``torch.profiler`` session runs, it is a
    ``record_function`` range of that name, so the span lies in the
    profiler's trace with the device work launched inside it, and it is
    also kept in memory as ``(name, parent index, start_ns, end_ns)`` on
    the profiler's own clock (``time.time_ns``: the profiler stamps its
    events with the wall clock). With no session running it is one shared
    null context: no range, no clock read, no allocation;
  * ``count(name, n)``: adds ``n`` to a counter while a session runs. ``n``
    may be a device tensor: it is kept as it is and read to the host only
    when the record is read;
  * ``recording()``: whether a session runs, for a counter whose value
    costs work to make;
  * ``drain()``: the record (spans, counters, and each span name's count,
    total and self time), cleared;
  * ``SPANS``: every span name the program emits;
  * ``trace(dir)``: a ``torch.profiler`` session (host and, where there is
    a card, CUDA activity) that writes its Chrome trace, ``trace.json``,
    and the drained record, ``spans.json``, into ``dir``.

The record follows the profiler, which is one per process: it restarts at
the first span or count of a session that follows one made with no session
running, and at each ``trace``. So a reader sees only the traced window.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List

import torch
from torch.autograd import profiler as _autograd_profiler

# the streams of train/streams.py; each has an epoch span and a step span
STREAMS = ("rel_view", "attr_view", "ckge_rel", "ckgp_rel", "ckge_attr",
           "ckga_attr", "common_space", "space_mapping")

SPANS = tuple(f"{s}.{part}" for s in STREAMS for part in ("epoch", "step")) \
    + (
        # inside rel_view.epoch: the epoch's draws (the in-step resample
        # path's too)
        "rel_view.draw", "draw.positives", "draw.negatives", "draw.bloom",
        # inside every <stream>.step; step.conv (the CNN scorer) inside the
        # attribute streams' step.forward
        "step.gather", "step.forward", "step.backward", "step.allreduce",
        "step.apply", "step.conv",
        # around one ITC driver epoch's streams (train/itc.py)
        "itc.epoch",
        # once a refresh, an evaluation, a trainer
        "refresh.neighbors", "refresh.predicates", "eval.rank",
        "setup.triple_filter")

# the counters: with Bloom "drop", the per-slot draws' dropped real slots
# and all their real slots, once an epoch; the (positive, pool member)
# pairs of each launch of K3, the chunk-shared loss's kernel
# (kernels/chunk_loss.py); the slots (positive, candidate) of each call of
# the per-slot loss, K5 on the card (kernels/per_slot_loss.py); the rows of
# each call of the CNN scorer (views/attr_conv.py), and of each forward
# launch of K4, its kernels (kernels/conv_score.py); the ids of each call
# of K1, the row-sparse apply (kernels/apply_kernel.py), and the distinct
# rows they touch
COUNTERS = ("sampling.dropped", "sampling.slots", "loss.chunk_pairs",
            "loss.slot_pairs", "conv.rows", "conv.kernel_rows", "apply.ids",
            "apply.unique")


class _Record:
    """Spans and counters of the current profiler session."""

    def __init__(self):
        self.live = False
        self.restart()

    def restart(self):
        self.spans: List[list] = []      # [name, parent, start_ns, end_ns]
        self.stack: List[int] = []       # indices of the open spans
        self.counters: Dict[str, list] = defaultdict(list)


_REC = _Record()
_OFF = contextlib.nullcontext()


def _session() -> bool:
    """Whether a profiler session runs; restarts the record at the first
    call of a session that follows a call made with none."""
    if not _autograd_profiler._is_profiler_enabled:
        _REC.live = False
        return False
    if not _REC.live:
        _REC.live = True
        _REC.restart()
    return True


class _Span:
    __slots__ = ("name", "spans", "index", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        rec = _REC
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.spans, self.index = rec.spans, len(rec.spans)
        rec.spans.append([self.name, rec.stack[-1] if rec.stack else -1,
                          time.time_ns(), 0])
        rec.stack.append(self.index)
        return self

    def __exit__(self, *exc):
        self.spans[self.index][3] = time.time_ns()
        stack = _REC.stack
        if self.spans is _REC.spans and stack and stack[-1] == self.index:
            stack.pop()
        return self.rf.__exit__(*exc)


def span(name: str):
    """A span of the program's work named ``name`` (one of ``SPANS``)."""
    return _Span(name) if _session() else _OFF


def recording() -> bool:
    """Whether a profiler session runs, so that :func:`count` keeps what it
    is given."""
    return _session()


def count(name: str, n) -> None:
    """Adds ``n`` (a number or a device scalar) to counter ``name`` while a
    profiler session runs."""
    if _session():
        _REC.counters[name].append(n)


def _total(values) -> float:
    """The sum of numbers and tensors, the tensors summed where they lie
    and read once."""
    tensors = [v for v in values if torch.is_tensor(v)]
    out = float(sum(v for v in values if not torch.is_tensor(v)))
    if tensors:
        out += float(torch.stack([t.reshape(()).to(torch.float64)
                                  for t in tensors]).sum())
    return out


def drain() -> dict:
    """The record, cleared: ``spans``, a list of ``(name, parent, start_ns,
    end_ns)`` (``parent`` the index of the enclosing span, -1 at the top),
    ``counters`` ``{name: total}`` and ``by_name`` ``{name: {"count",
    "total_ns", "self_ns"}}``: a span's self time is its duration less the
    part its child spans cover. Read it with no span open."""
    rec = _REC
    spans = [tuple(s) for s in rec.spans]
    counters = {k: _total(v) for k, v in rec.counters.items()}
    rec.restart()
    child_ns = [0] * len(spans)
    for _, parent, start, end in spans:
        if parent >= 0:
            child_ns[parent] += end - start
    by_name: Dict[str, dict] = {}
    for (name, _, start, end), inner in zip(spans, child_ns):
        agg = by_name.setdefault(name, {"count": 0, "total_ns": 0,
                                        "self_ns": 0})
        agg["count"] += 1
        agg["total_ns"] += end - start
        agg["self_ns"] += end - start - inner
    return {"spans": spans, "counters": counters, "by_name": by_name}


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """A profiler session over the block; writes ``trace.json`` (the Chrome
    trace) and ``spans.json`` (:func:`drain`'s record) into ``log_dir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        _REC.live = True
        _REC.restart()
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump(drain(), f)
