"""Device milliseconds launched by ``epoch.draw`` (sampling.py), per
epoch.
Moves ``rel_triples_per_s``."""
from gpubench.metrics._common import sampling_ms as read  # noqa: F401
