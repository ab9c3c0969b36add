"""Host milliseconds of the program's ``step.gather`` and ``step.forward``
spans (the gathers and the loss of losses.py) inside each ``rel_view.step``,
per step, from the program's own record of the traced window.
Moves ``rel_triples_per_s``."""
from gpubench.metrics._program import loss_ms as read  # noqa: F401
