"""Share of the per-slot draws' real slots that the Bloom filter dropped
(sampling.py), from the program's counters ``sampling.dropped`` and
``sampling.slots`` over the traced window.
Moves ``rel_card_ms_per_step``."""
from gpubench.metrics._program import drop_pct as read  # noqa: F401
