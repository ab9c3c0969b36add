"""The whole step's share of the card's published float32 peak.
Moves ``rel_card_ms_per_step``."""
from gpubench.metrics._common import mfu_pct as read  # noqa: F401
