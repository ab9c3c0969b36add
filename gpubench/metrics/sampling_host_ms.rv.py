"""Host milliseconds of the program's ``rel_view.draw`` spans (sampling.py),
per epoch, from the program's own record of the traced window.
Moves ``rel_triples_per_s``."""
from gpubench.metrics._program import sampling_ms as read  # noqa: F401
