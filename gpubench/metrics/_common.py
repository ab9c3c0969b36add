"""What several per-layer readers share. Each reader is ``read(run)`` of a
dict: ``spans`` (host seconds of each call, by span name), ``counters``,
``trace`` (lib/trace.py ``reduce_profile``, or ``device_busy`` for an
end-to-end metric read from the device's clock), ``window_s`` (the window's
host seconds) and ``card`` (the card's name). A reader that finds nothing
to read returns None, and the metric is left out of the line."""
from __future__ import annotations

from gpubench.lib.peaks import card_peaks


def idle_pct(run):
    """100 - the device's busy share of the traced window."""
    if not run["trace"]["device_ops"]:
        return None
    return 100.0 * (1.0 - run["trace"]["busy_s"] / run["window_s"])


def mfu_pct(run):
    """The model FLOPs of the window (counted by lib/bounds.py from the
    shapes that ran) over the window's time at the card's published
    float32 rate; None where the trace saw no device."""
    flops = run["counters"].get("model_flops", 0)
    if not flops or not run["trace"]["device_ops"]:
        return None
    return 100.0 * flops / (run["window_s"] * card_peaks(run["card"])[1])


def range_ms(run, name, per):
    """Device milliseconds launched inside span ``name``, per counter
    ``per``."""
    n = run["counters"].get(per)
    s = run["trace"]["range_device_s"].get(name)
    if not n or not s:
        return None
    return 1e3 * s / n


def step_dispatch_ms(run):
    """Host milliseconds of each ``epoch.step`` call, with no synchronize:
    the enqueue of one step (the epoch loop, train/streams.py). Mean per
    step."""
    spans = run["spans"].get("step")
    return 1e3 * sum(spans) / len(spans) if spans else None


def sampling_ms(run):
    """Device milliseconds launched by ``epoch.draw`` (sampling.py), per
    epoch."""
    return range_ms(run, "draw", "epochs")


def loss_ms(run):
    """Device milliseconds launched by ``epoch.step`` less the applies
    inside it: the gathers, the loss (losses.py) and autograd's backward,
    per step."""
    step, apply = range_ms(run, "step", "steps"), range_ms(run, "apply",
                                                            "steps")
    if step is None:
        return None
    return step - (apply or 0.0)


def apply_ms(run):
    """Device milliseconds launched by the optimizer's applies
    (train/sparse_adagrad.py ``dense_apply`` and ``row_apply``), per
    step."""
    return range_ms(run, "apply", "steps")
