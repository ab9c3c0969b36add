"""End to end: the card's busy milliseconds per training step over the
whole untraced window, on the device's clock. The union of every kernel's
and copy's interval, over the window's steps (each epoch's draws shared out
over its steps): the card time that a step costs, which host dispatch
leaves out."""


def read(run):
    steps = run["counters"].get("steps")
    if not steps or not run["trace"] or not run["trace"]["device_ops"]:
        return None
    return 1e3 * run["trace"]["busy_s"] / steps
