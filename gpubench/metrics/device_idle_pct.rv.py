"""Share of the traced window in which no kernel or copy ran on the card.
Moves ``rel_triples_per_s``."""
from gpubench.metrics._common import idle_pct as read  # noqa: F401
