"""Host milliseconds of the program's ``step.backward`` span (autograd's
backward of the loss) inside each ``rel_view.step``, per step, from the
program's own record of the traced window.
Moves ``rel_triples_per_s``."""
from gpubench.metrics._program import backward_ms as read  # noqa: F401
