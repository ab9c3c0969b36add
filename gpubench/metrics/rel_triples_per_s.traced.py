"""Positive relation triples trained per second of the traced window, on
the host's clock: ``rel_triples_per_s`` where it is not an end-to-end
metric, read under the profiler, which slows the host about twice."""


def read(run):
    n = run["counters"].get("triples")
    return n / run["window_s"] if n else None
