"""The whole driver epoch's share of the card's published float32 peak: the
model FLOPs of every stream (lib/bounds.py, lib/bounds_itc.py) over the
traced window.
Moves ``rel_card_ms_per_step``."""
from gpubench.metrics._common import mfu_pct as read  # noqa: F401
