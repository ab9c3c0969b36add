"""Host milliseconds of each ``epoch.step`` call, with no synchronize:
the enqueue of one step (the epoch loop, train/streams.py). Mean per step.
Moves ``rel_triples_per_s``."""
from gpubench.metrics._common import step_dispatch_ms as read  # noqa: F401
