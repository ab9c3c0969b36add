"""Device milliseconds launched by ``epoch.draw`` (sampling.py), per
epoch.
Moves ``rel_card_ms_per_step``."""
from gpubench.metrics._common import sampling_ms as read  # noqa: F401
