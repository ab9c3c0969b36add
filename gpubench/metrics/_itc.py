"""What the readers of the ITC cell's own metrics share (the ``.itc``
readers): host milliseconds of the program's stream spans per driver epoch
(``itc.epoch``), the device time of the CNN scorer per CNN-scored step, and
K1's share of its bytes roofline. Each returns None where the record or the
trace lacks what it reads, as ``_program.py``'s readers do."""
from __future__ import annotations

from gpubench.lib.bounds import k1_bytes
from gpubench.lib.peaks import card_peaks
from gpubench.metrics._common import range_ms
from gpubench.metrics._program import record

EPOCH = "itc.epoch"
ATTR_STREAMS = ("attr_view.epoch", "ckge_attr.epoch", "ckga_attr.epoch")
REL_STREAMS = ("rel_view.epoch", "ckge_rel.epoch", "ckgp_rel.epoch")


def _per_epoch(run, names):
    """Host milliseconds of the spans ``names`` per ``itc.epoch``."""
    rec = record(run)
    if rec is None:
        return None
    by_name = rec["by_name"]
    epochs = by_name.get(EPOCH, {}).get("count", 0)
    ns = sum(by_name.get(n, {}).get("total_ns", 0) for n in names)
    return ns / 1e6 / epochs if epochs and ns else None


def epoch_ms(run):
    return _per_epoch(run, (EPOCH,))


def attr_streams_ms(run):
    return _per_epoch(run, ATTR_STREAMS)


def rel_streams_ms(run):
    return _per_epoch(run, REL_STREAMS)


def conv_ms(run):
    """Device milliseconds launched inside the benchmark's ``conv`` range
    (the CNN scorer's forward, views/attr_conv.py), per CNN-scored step."""
    return range_ms(run, "conv", "conv_steps")


def k1_roofline_pct(run):
    """K1's bytes (``lib/bounds.k1_bytes`` over the program's counters
    ``apply.ids`` and ``apply.unique``, summed over its calls: the bound is
    linear in both) at the card's published memory rate, over the device
    time launched inside the benchmark's ``k1`` range (every call of
    ``sparse_adagrad.row_apply``)."""
    if not run["trace"]["device_ops"]:
        return None
    rec = record(run)
    counters = rec["counters"] if rec is not None else {}
    ids, unique = counters.get("apply.ids"), counters.get("apply.unique")
    seconds = run["trace"]["range_device_s"].get("k1")
    dim = run["counters"].get("dim")
    if not ids or not unique or not seconds or not dim:
        return None
    return 100.0 * k1_bytes(ids, unique, int(dim)) / (
        seconds * card_peaks(run["card"])[0])
