"""What the readers of the program's own spans and counters share.

The port records spans and counters inside its own modules while a profiler
session runs (``multike_tpu_torch.utils.profiling``): ``rel_view.epoch``
holds the epoch's ``rel_view.draw`` and its ``rel_view.step`` spans, and
each step holds ``step.gather``, ``step.forward``, ``step.backward`` and
``step.apply``. The first of these readers in a traced run drains that
record and keeps it on the run's dict; each then reads its numbers from it,
on the host's clock. Where the program has no tracer, or the record lacks
what a reader reads, the reader returns None."""
from __future__ import annotations

EPOCH, STEP, DRAW = "rel_view.epoch", "rel_view.step", "rel_view.draw"


def record(run):
    """The program's record of the traced window, drained once a run; None
    where the program has no tracer."""
    if "program" not in run:
        from multike_tpu_torch.utils import profiling

        drain = getattr(profiling, "drain", None)
        run["program"] = drain() if drain is not None else None
    return run["program"]


def _count(rec, name):
    return rec["by_name"].get(name, {}).get("count", 0)


def _per(run, per, ns_of):
    """``ns_of(record)`` nanoseconds in milliseconds per span ``per``."""
    rec = record(run)
    if rec is None or not _count(rec, per):
        return None
    ns = ns_of(rec)
    return ns / 1e6 / _count(rec, per) if ns else None


def _inside_steps(*names):
    """Host nanoseconds of the spans ``names`` directly inside a
    ``rel_view.step``."""
    def ns_of(rec):
        spans = rec["spans"]
        return sum(end - start for name, parent, start, end in spans
                   if name in names and parent >= 0
                   and spans[parent][0] == STEP)
    return ns_of


def sampling_ms(run):
    """Host milliseconds of the epoch's draws (sampling.py), per epoch."""
    return _per(run, EPOCH, lambda rec: rec["by_name"].get(DRAW, {}).get(
        "total_ns", 0))


def loss_ms(run):
    """Host milliseconds of a step's gathers and its loss's forward
    (losses.py), per step."""
    return _per(run, STEP, _inside_steps("step.gather", "step.forward"))


def backward_ms(run):
    """Host milliseconds of a step's ``torch.autograd.grad``, per step."""
    return _per(run, STEP, _inside_steps("step.backward"))


def apply_ms(run):
    """Host milliseconds of a step's optimizer applies
    (train/sparse_adagrad.py), per step."""
    return _per(run, STEP, _inside_steps("step.apply"))


def loop_ms(run):
    """Host milliseconds of the epoch loop's own Python (train/streams.py):
    the self time of the epoch span and of the step spans, per step."""
    def ns_of(rec):
        return sum(rec["by_name"].get(name, {}).get("self_ns", 0)
                   for name in (EPOCH, STEP))
    return _per(run, STEP, ns_of)


def drop_pct(run):
    """The share of the per-slot draws' real slots that the Bloom filter
    dropped (sampling.py): computed, then masked out of the loss."""
    rec = record(run)
    counters = rec["counters"] if rec is not None else {}
    if not counters.get("sampling.slots"):
        return None
    return 100.0 * counters.get("sampling.dropped", 0.0) \
        / counters["sampling.slots"]
