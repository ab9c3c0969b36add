"""The whole step's share of the card's published float32 peak.
Moves ``rel_triples_per_s``."""
from gpubench.metrics._common import mfu_pct as read  # noqa: F401
