"""Device milliseconds launched by ``epoch.step`` less the applies inside
it: the gathers, the loss (losses.py) and autograd's backward, per step.
Moves ``rel_triples_per_s``."""
from gpubench.metrics._common import loss_ms as read  # noqa: F401
