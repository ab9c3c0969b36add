"""Device milliseconds launched by every stream's step less the applies
inside it: the gathers, the losses and autograd's backward, per step of
any stream.
Moves ``rel_card_ms_per_step``."""
from gpubench.metrics._common import loss_ms as read  # noqa: F401
