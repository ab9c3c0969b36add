"""Share of the traced window in which no kernel or copy ran on the card.
Moves ``rel_card_ms_per_step``."""
from gpubench.metrics._common import idle_pct as read  # noqa: F401
