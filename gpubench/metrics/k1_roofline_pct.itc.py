"""K1's share of its bytes roofline: N (8 + 4d) + 16 U d bytes over the
program's ``apply.ids`` and ``apply.unique`` counters, at the card's
published memory rate, over the device time of the row-sparse applies.
Moves ``rel_card_ms_per_step``."""
from gpubench.metrics._itc import k1_roofline_pct as read  # noqa: F401
