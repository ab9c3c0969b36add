"""Spans, counters and the device trace of one run.

The benchmark records spans from its own files, around the calls it makes
into each layer: a span is a host-clock interval and, in a traced run, a
``record_function`` range of the same name. After the window,
:func:`reduce_profile` turns the profiler's raw events into what the
per-layer readers need:

  * ``busy_s``: the union of the device's kernel and copy intervals;
  * ``range_device_s[name]``: the device time of the work launched inside
    range ``name``. A device op belongs to the range whose host interval
    holds the start of the host op that launched it. The backward pass runs
    on the autograd engine's own thread, which the profiler does not nest
    under the caller's range, while the caller waits inside its range: so
    the host interval decides, not the stack. Ranges nest, and a device op
    counts for every range that holds it;
  * the top device ops by name, and the longest idle gaps of the device
    with what the host was doing when each began.

:func:`device_busy` takes the busy seconds alone, from a trace of the
device's activity without the host's.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict


class Recorder:
    """Spans (host seconds of each call, by name) and counters of one run.
    With ``traced`` every span is also a profiler range."""

    def __init__(self, traced: bool = False):
        self.traced = traced
        self.spans = defaultdict(list)
        self.counters = defaultdict(float)

    @contextlib.contextmanager
    def span(self, name: str):
        if self.traced:
            from torch.profiler import record_function

            with record_function(name):
                t0 = time.perf_counter()
                try:
                    yield
                finally:
                    self.spans[name].append(time.perf_counter() - t0)
        else:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.spans[name].append(time.perf_counter() - t0)

    def wrap(self, fn, name: str):
        """``fn`` with every call inside span ``name``."""
        def wrapped(*a, **kw):
            with self.span(name):
                return fn(*a, **kw)
        return wrapped

    def count(self, name: str, n: float = 1):
        self.counters[name] += n


def _merge(intervals):
    """The union of (start, end) intervals, as sorted disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _holds(merged, starts, t) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= merged[i][1]


def device_busy(prof) -> dict:
    """The device's busy seconds (the union of its kernel and copy
    intervals) and its count of operations, from a stopped profiler that
    traced the device alone: what an end-to-end metric read from the
    device's clock needs, without the host side of
    :func:`reduce_profile`."""
    from torch.autograd import DeviceType

    device = [(e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() != DeviceType.CPU
              and not e.is_user_annotation()]
    busy = _merge(device)
    return dict(busy_s=sum(e - s for s, e in busy) / 1e9,
                device_ops=len(device))


def reduce_profile(prof, ranges, top: int = 10) -> dict:
    """The device's busy seconds, each range's device seconds and the
    breakdown, from a stopped ``torch.profiler.profile``. ``ranges`` names
    the spans whose device time is wanted. Reads the profiler's raw events:
    building its event tree takes minutes on a window of many small
    steps."""
    from torch.autograd import DeviceType

    device, host_ranges, ops, cpu = [], defaultdict(list), {}, []
    for e in prof.profiler.kineto_results.events():
        kind, name = e.device_type(), e.name()
        if kind == DeviceType.CPU:
            start, end = e.start_ns(), e.end_ns()
            if name in ranges:
                host_ranges[name].append((start, end))
            elif e.linked_correlation_id() == 0:
                ops[e.correlation_id()] = start
                cpu.append((start, end, name))
        elif not e.is_user_annotation() and name not in ranges:
            device.append((e.start_ns(), e.end_ns(), name,
                           e.linked_correlation_id()))

    busy = _merge((s, e) for s, e, _, _ in device)
    busy_ns = sum(e - s for s, e in busy)
    by_name = defaultdict(float)
    for s, e, name, _ in device:
        by_name[name] += e - s

    merged = {n: _merge(iv) for n, iv in host_ranges.items()}
    starts = {n: [s for s, _ in iv] for n, iv in merged.items()}
    range_ns = {n: 0.0 for n in ranges}
    attributed_ns = 0.0
    for s, e, name, corr in device:
        t = ops.get(corr)
        if t is not None:
            attributed_ns += e - s
            for n in ranges:
                if n in merged and _holds(merged[n], starts[n], t):
                    range_ns[n] += e - s

    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1])
                   for i in range(len(busy) - 1)), reverse=True)[:top]
    labels = _host_at([g[1] for g in gaps], cpu, merged, starts)
    return dict(
        busy_s=busy_ns / 1e9,
        device_ops=len(device),
        attributed_s=attributed_ns / 1e9,
        device_op_s=sum(by_name.values()) / 1e9,
        range_device_s={n: ns / 1e9 for n, ns in range_ns.items()},
        breakdown=dict(
            device_ops=[[n[:120], ns / 1e9] for n, ns in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:top]],
            idle_gaps=[[label, g[0] / 1e9]
                       for label, g in zip(labels, gaps)]))


def _host_at(points, cpu, merged, starts):
    """For each time point, the innermost host op that holds it (the latest
    to start), prefixed with the benchmark's spans that do; "host Python"
    where no op ran."""
    best = [None] * len(points)
    for s, e, name in cpu:
        for i, p in enumerate(points):
            if s <= p < e and (best[i] is None or s > best[i][0]):
                best[i] = (s, name)
    out = []
    for i, p in enumerate(points):
        inner = [n for n in merged if _holds(merged[n], starts[n], p)]
        op = best[i][1] if best[i] is not None else "host Python"
        out.append(" / ".join(sorted(inner) + [op])[:120])
    return out
