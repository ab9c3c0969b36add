"""Device milliseconds launched by ``epoch.step`` less the applies inside
it: the gathers, the loss (losses.py) and autograd's backward, per step.
Moves ``rel_card_ms_per_step``."""
from gpubench.metrics._common import loss_ms as read  # noqa: F401
