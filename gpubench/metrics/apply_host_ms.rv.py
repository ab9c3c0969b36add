"""Host milliseconds of the program's ``step.apply`` span (the optimizer's
applies, train/sparse_adagrad.py) inside each ``rel_view.step``, per step,
from the program's own record of the traced window.
Moves ``rel_triples_per_s``."""
from gpubench.metrics._program import apply_ms as read  # noqa: F401
