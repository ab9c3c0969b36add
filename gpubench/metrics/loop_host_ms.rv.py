"""Host milliseconds of the epoch loop's own Python (train/streams.py): the
self time of the program's ``rel_view.epoch`` and ``rel_view.step`` spans,
per step, from the program's own record of the traced window.
Moves ``rel_triples_per_s``."""
from gpubench.metrics._program import loop_ms as read  # noqa: F401
